"""Monotone rational-quadratic spline (RQS) transforms.

The math is Durkan et al. 2019, "Neural Spline Flows", as
``nfisam_tpu/flows/rqs.py`` computes it: softmax bins with size floors,
endpoint knots pinned and bin sizes recomputed from the pinned knots,
softplus derivatives, linear tails outside ``[-B, B]`` or a periodic
spline for circular dims.  Batched over arbitrary leading shapes with
per-element spline parameters ``(..., K)``; both directions return the
elementwise ``log |det J|``.  Differentiable, so the trainer takes
gradients through the forward direction.
"""
from __future__ import annotations

import math

import torch

MIN_BIN_WIDTH = 1e-3
MIN_BIN_HEIGHT = 1e-3
MIN_DERIVATIVE = 1e-3
# softplus(x) = 1 - MIN_DERIVATIVE  =>  boundary derivative == 1 (linear tails)
BOUNDARY_RAW_DERIV = float(math.log(math.exp(1.0 - MIN_DERIVATIVE) - 1.0))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no switch to the identity at large x."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _normalize_bins(unnormalized: torch.Tensor, num_bins: int, left: float,
                    right: float, min_size: float):
    """softmax -> min-size floor -> cumulative knots in [left, right]."""
    probs = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1.0 - min_size * num_bins) * probs
    cum = torch.cumsum(sizes, dim=-1)
    cum = (right - left) * cum + left
    # pin the endpoints exactly
    edge = torch.ones_like(cum[..., :1])
    cum = torch.cat([edge * left, cum[..., :-1], edge * right], dim=-1)
    sizes = cum[..., 1:] - cum[..., :-1]
    return sizes, cum


def _search_bin(cum: torch.Tensor, x: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """Index of the bin containing x: sum of (x >= knot) - 1, clipped."""
    idx = torch.sum((x[..., None] >= cum[..., :-1]).to(torch.int64),
                    dim=-1) - 1
    return torch.clamp(idx, 0, num_bins - 1)


def _gather(params: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-element bin parameter: params (..., K), idx (...)."""
    return torch.gather(params, -1, idx[..., None])[..., 0]


def rqs(inputs, unnorm_widths, unnorm_heights, unnorm_derivs,
        inverse: bool = False, left: float = 0.0, right: float = 1.0,
        bottom: float = 0.0, top: float = 1.0):
    """Core RQS transform on the interval; all elements assumed inside.

    ``unnorm_derivs`` already includes the two boundary knots (K+1 values).
    Returns ``(outputs, logabsdet)`` elementwise.
    """
    K = unnorm_widths.shape[-1]
    widths, cumw = _normalize_bins(unnorm_widths, K, left, right,
                                   MIN_BIN_WIDTH)
    heights, cumh = _normalize_bins(unnorm_heights, K, bottom, top,
                                    MIN_BIN_HEIGHT)
    derivs = MIN_DERIVATIVE + softplus(unnorm_derivs)

    idx = _search_bin(cumh if inverse else cumw, inputs, K)

    in_cumw = _gather(cumw[..., :-1], idx)
    in_w = _gather(widths, idx)
    in_cumh = _gather(cumh[..., :-1], idx)
    in_h = _gather(heights, idx)
    delta = in_h / in_w
    d0 = _gather(derivs[..., :-1], idx)
    d1 = _gather(derivs[..., 1:], idx)
    s = d0 + d1 - 2.0 * delta

    if inverse:
        y_rel = inputs - in_cumh
        a = in_h * (delta - d0) + y_rel * s
        b = in_h * d0 - y_rel * s
        c = -delta * y_rel
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        theta = (2.0 * c) / (-b - torch.sqrt(disc))
        theta = torch.clamp(theta, 0.0, 1.0)
        outputs = theta * in_w + in_cumw
        t1mt = theta * (1.0 - theta)
        denom = delta + s * t1mt
        deriv_num = delta * delta * (d1 * theta * theta + 2.0 * delta * t1mt +
                                     d0 * (1.0 - theta) ** 2)
        logabsdet = -(torch.log(deriv_num) - 2.0 * torch.log(denom))
        return outputs, logabsdet

    theta = (inputs - in_cumw) / in_w
    theta = torch.clamp(theta, 0.0, 1.0)
    t1mt = theta * (1.0 - theta)
    denom = delta + s * t1mt
    numer = in_h * (delta * theta * theta + d0 * t1mt)
    outputs = in_cumh + numer / denom
    deriv_num = delta * delta * (d1 * theta * theta + 2.0 * delta * t1mt +
                                 d0 * (1.0 - theta) ** 2)
    logabsdet = torch.log(deriv_num) - 2.0 * torch.log(denom)
    return outputs, logabsdet


def unconstrained_rqs(inputs, unnorm_widths, unnorm_heights, unnorm_derivs,
                      inverse: bool = False, tail_bound: float = 5.0,
                      circular: bool = False):
    """RQS with linear tails outside [-B, B] (or periodic for circular dims).

    ``unnorm_derivs`` carries K-1 interior knots for the linear-tail case and
    K knots (the shared wrap-around derivative last) for the circular case.
    Elements outside the interval pass through identity with zero log-det.
    """
    B = tail_bound
    if circular:
        # periodic boundary: first == last derivative knot
        derivs = torch.cat([unnorm_derivs[..., -1:], unnorm_derivs], dim=-1)
        inputs = torch.remainder(inputs + B, 2.0 * B) - B
        inside = torch.ones(inputs.shape, dtype=torch.bool,
                            device=inputs.device)
    else:
        pad = torch.full_like(unnorm_derivs[..., :1], BOUNDARY_RAW_DERIV)
        derivs = torch.cat([pad, unnorm_derivs, pad], dim=-1)
        inside = (inputs >= -B) & (inputs <= B)

    safe_inputs = torch.clamp(inputs, -B, B)
    out_in, ld_in = rqs(safe_inputs, unnorm_widths, unnorm_heights, derivs,
                        inverse=inverse, left=-B, right=B, bottom=-B, top=B)
    outputs = torch.where(inside, out_in, inputs)
    logabsdet = torch.where(inside, ld_in, torch.zeros_like(ld_in))
    return outputs, logabsdet
