"""Tensor SE(2) / SO(2) geometry.

Pure functions over ``[..., 3]`` (SE(2)) and ``[..., 2]`` (R^2) tensors,
batched over the leading axes; the counterpart of
``nfisam_tpu/core/geometry.py``, function for function.

Conventions: an SE(2) element is ``[x, y, theta]`` with ``theta`` in
radians, tangent vectors are ``[v1, v2, w]``, and ``theta`` is wrapped to
``[-pi, pi)`` on output of group ops.
"""
from __future__ import annotations

import math

import torch

_EPS_W = 1e-7  # small-rotation switch for exp/log closed forms
_TWO_PI = 2.0 * math.pi


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi).  ``torch.remainder`` is the floored
    modulo, as ``jnp.mod``."""
    return torch.remainder(theta + math.pi, _TWO_PI) - math.pi


def rot2_matrix(theta: torch.Tensor) -> torch.Tensor:
    """[...] -> [..., 2, 2] rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def rot2_apply(theta: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """Rotate points ``pt`` ([..., 2]) by angles ``theta`` ([...])."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def se2_identity(batch_shape=(), dtype=None, device=None) -> torch.Tensor:
    """Identity poses, zeros of shape ``batch_shape + (3,)``."""
    return torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group composition a * b for [..., 3] SE(2) tensors."""
    t = a[..., :2] + rot2_apply(a[..., 2], b[..., :2])
    th = wrap_angle(a[..., 2] + b[..., 2])
    return torch.cat([t, th[..., None]], dim=-1)


def se2_inverse(a: torch.Tensor) -> torch.Tensor:
    """Group inverse for [..., 3] SE(2) tensors."""
    th = a[..., 2]
    t = -rot2_apply(-th, a[..., :2])
    return torch.cat([t, wrap_angle(-th)[..., None]], dim=-1)


def se2_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative transform a^{-1} * b."""
    return se2_compose(se2_inverse(a), b)


def se2_exp(v: torch.Tensor) -> torch.Tensor:
    """Exponential map se(2) -> SE(2) for [..., 3] tangent vectors:
    ``t = V(w) @ v_xy`` with ``V = [[sin w / w, -(1-cos w)/w],
    [(1-cos w)/w, sin w / w]]``."""
    vx, vy, w = v[..., 0], v[..., 1], v[..., 2]
    small = torch.abs(w) < _EPS_W
    w_safe = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    b = torch.where(small, w / 2.0, (1.0 - torch.cos(w_safe)) / w_safe)
    tx = a * vx - b * vy
    ty = b * vx + a * vy
    return torch.stack([tx, ty, wrap_angle(w)], dim=-1)


def se2_log(T: torch.Tensor) -> torch.Tensor:
    """Logarithmic map SE(2) -> se(2) for [..., 3] poses:
    ``v_xy = V(w)^{-1} t`` with ``V^{-1} = [[A, h], [-h, A]]``,
    ``h = w/2`` and ``A = h cot(h)`` (limit 1 at w=0)."""
    x, y, w = T[..., 0], T[..., 1], T[..., 2]
    h = w / 2.0
    small = torch.abs(w) < _EPS_W
    h_safe = torch.where(small, torch.ones_like(h), h)
    A = torch.where(small, 1.0 - h * h / 3.0, h_safe / torch.tan(h_safe))
    vx = A * x + h * y
    vy = -h * x + A * y
    return torch.stack([vx, vy, w], dim=-1)


def se2_det_grad_logmap(T: torch.Tensor) -> torch.Tensor:
    """det(d logmap / d (x, y, theta)) at T, ``(theta/2)^2 /
    sin^2(theta/2)``; [..., 3] -> [...]."""
    w = T[..., 2]
    h = w / 2.0
    small = torch.abs(w) < 1e-5
    h_safe = torch.where(small, torch.ones_like(h), h)
    return torch.where(small, 1.0 + h * h / 3.0,
                       (h_safe / torch.sin(h_safe)) ** 2)


def se2_grad_det_grad_logmap(T: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`se2_det_grad_logmap` w.r.t. (x, y, theta); only
    the theta component is non-zero.  [..., 3] -> [..., 3]."""
    w = T[..., 2]
    h = w / 2.0
    small = torch.abs(w) < 1e-5
    h_safe = torch.where(small, torch.ones_like(h), h)
    s = torch.sin(h_safe)
    dfdth = torch.where(small, w / 6.0, h_safe / s ** 2 -
                        torch.cos(h_safe) * h_safe ** 2 / s ** 3)
    zeros = torch.zeros_like(w)
    return torch.stack([zeros, zeros, dfdth], dim=-1)


def se2_grad_x_logmap(T: torch.Tensor) -> torch.Tensor:
    """Jacobian d(logmap)/d(x, y, theta) at T; [..., 3] -> [..., 3, 3]."""
    v = se2_log(T)
    lx, ly, w = v[..., 0], v[..., 1], v[..., 2]
    x, y = T[..., 0], T[..., 1]
    h = w / 2.0
    small = torch.abs(w) < 1e-5
    ones = torch.ones_like(w)
    w_safe = torch.where(small, ones, w)
    cw = torch.cos(w_safe)
    # diag = (w/2) sin w / (1 - cos w); -> 1 as w -> 0
    diag = torch.where(small, 1.0 - w * w / 12.0,
                       h * torch.sin(w_safe) / (1.0 - cw))
    inv_c1 = torch.where(small, ones, 1.0 / (cw - 1.0))
    dvx_dth = torch.where(small, 0.5 * ly, lx / w_safe + h * (x * inv_c1))
    dvy_dth = torch.where(small, -0.5 * lx, ly / w_safe + h * (y * inv_c1))
    zeros = torch.zeros_like(w)
    return torch.stack([torch.stack([diag, h, dvx_dth], dim=-1),
                        torch.stack([-h, diag, dvy_dth], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def se2_grad_xi_expmap(T: torch.Tensor) -> torch.Tensor:
    """Jacobian d(x, y, theta)/d(v1, v2, w) at v = log(T); [..., 3] ->
    [..., 3, 3], the inverse of :func:`se2_grad_x_logmap`."""
    v = se2_log(T)
    lx, ly, w = v[..., 0], v[..., 1], v[..., 2]
    small = torch.abs(w) < 1e-5
    ones = torch.ones_like(w)
    w_safe = torch.where(small, ones, w)
    s, c = torch.sin(w_safe), torch.cos(w_safe)
    a = torch.where(small, 1.0 - w * w / 6.0, s / w_safe)
    b = torch.where(small, w / 2.0, (1.0 - c) / w_safe)
    da = torch.where(small, -w / 3.0, (c * w_safe - s) / w_safe ** 2)
    db = torch.where(small, 0.5 * ones,
                     (s * w_safe - (1.0 - c)) / w_safe ** 2)
    dx_dth = da * lx - db * ly
    dy_dth = db * lx + da * ly
    zeros = torch.zeros_like(w)
    return torch.stack([torch.stack([a, -b, dx_dth], dim=-1),
                        torch.stack([b, a, dy_dth], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def se2_range_and_bearing(pose: torch.Tensor, pt: torch.Tensor):
    """Range and bearing from SE(2) poses [..., 3] to points [..., 2]."""
    d = pt - pose[..., :2]
    rng = torch.linalg.norm(d, dim=-1)
    local = rot2_apply(-pose[..., 2], d)
    return rng, torch.atan2(local[..., 1], local[..., 0])


def se2_chordal_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|| log(a^{-1} b) ||."""
    return torch.linalg.norm(se2_log(se2_between(a, b)), dim=-1)


def product_manifold_dist(a: torch.Tensor, b: torch.Tensor,
                          circular_mask) -> torch.Tensor:
    """Distance on a product of Euclidean and circular dims:
    ``circular_mask`` ([..., dim] bool) marks the angular residuals,
    which are wrapped."""
    diff = a - b
    mask = torch.as_tensor(circular_mask, dtype=torch.bool,
                           device=diff.device)
    diff = torch.where(mask, wrap_angle(diff), diff)
    return torch.linalg.norm(diff, dim=-1)
