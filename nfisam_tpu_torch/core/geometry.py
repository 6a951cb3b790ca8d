"""Tensor SE(2) / SO(2) geometry.

Pure functions over ``[..., 3]`` (SE(2)) and ``[..., 2]`` (R^2) tensors,
batched over the leading axes; the counterpart of
``nfisam_tpu/core/geometry.py`` restricted to what the case1 factors use.

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


def rot2_apply(theta: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """Rotate points ``pt`` ([..., 2]) by angles ``theta`` ([...])."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


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
