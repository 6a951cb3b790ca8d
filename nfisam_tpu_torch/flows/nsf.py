"""Autoregressive neural spline flow (NSF-AR) on tensors.

Counterpart of ``nfisam_tpu/flows/nsf.py``: dim ``i``'s rational-quadratic
spline parameters come from a two-hidden-layer tanh conditioner over dims
``< i``; all dims' conditioners are block-masked weight tensors evaluated
with three einsums.  The forward pass is one batched pass; the inverse is
sequential in dim and batched over samples.  Circular dims (``NSF_AR_CS``)
use periodic splines on [-pi, pi].

Parameters of one flow are a dict of tensors: ``W1 (d, h, d)``,
``b1 (d, h)``, ``W2 (d, h, h)``, ``b2 (d, h)``, ``W3 (d, 3K, h)``,
``b3 (d, 3K)``; a stack is a list of such dicts.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .rqs import unconstrained_rqs

PARAM_NAMES = ("W1", "b1", "W2", "b2", "W3", "b3")


@dataclass(frozen=True)
class NSFConfig:
    """Static flow configuration."""
    dim: int
    num_knots: int = 9            # K: number of spline bins
    tail_bound: float = 5.0       # B for Euclidean dims
    hidden_dim: int = 8
    num_flows: int = 1
    circular: Tuple[bool, ...] = ()   # per-dim flags; empty = all Euclidean

    @property
    def circular_mask(self) -> np.ndarray:
        if not self.circular:
            return np.zeros(self.dim, dtype=bool)
        return np.asarray(self.circular, dtype=bool)

    @property
    def params_per_dim(self) -> int:
        return 3 * self.num_knots   # W, H, D slots (D over-allocated by 1)


def autoregressive_mask(d: int) -> np.ndarray:
    """mask[i, j] = 1 iff dim i may see input dim j (strictly lower)."""
    return (np.arange(d)[None, :] < np.arange(d)[:, None]).astype(np.float32)


def init_flow_params(gen: torch.Generator, cfg: NSFConfig,
                     device) -> List[Dict[str, torch.Tensor]]:
    """Per-flow parameters for a stack of ``cfg.num_flows`` flows: the
    uniform init of the JAX package, drawn from ``gen``."""
    d, h, p = cfg.dim, cfg.hidden_dim, cfg.params_per_dim

    def unif(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    fan_in1 = np.maximum(np.arange(d), 1).astype(np.float32)
    bound1 = torch.as_tensor(1.0 / np.sqrt(fan_in1),
                             device=device)[:, None, None]
    flows = []
    for _ in range(cfg.num_flows):
        flows.append({
            "W1": unif((d, h, d), -1.0, 1.0) * bound1,
            "b1": torch.zeros((d, h), device=device),
            "W2": unif((d, h, h), -1.0, 1.0) / math.sqrt(h),
            "b2": torch.zeros((d, h), device=device),
            "W3": unif((d, p, h), -1.0, 1.0) / math.sqrt(h),
            # dim 0 has no inputs; its spline is driven by this bias alone
            "b3": unif((d, p), -0.5, 0.5),
        })
    return flows


def flow_params_from_numpy(flow_params: List[Dict[str, np.ndarray]],
                           device) -> List[Dict[str, torch.Tensor]]:
    """Flow parameters exported as numpy (e.g. from the JAX package) as
    float32 tensors on ``device``."""
    return [{k: torch.tensor(np.asarray(p[k], dtype=np.float32),
                             device=device) for k in PARAM_NAMES}
            for p in flow_params]


# The forward pass's constant masks and column orders on a device, built
# once: a training step replayed from a CUDA graph (train/trainer.py) may
# copy nothing from the host
@functools.lru_cache(maxsize=None)
def _ar_mask_on(d: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(autoregressive_mask(d), device=device)


@functools.lru_cache(maxsize=None)
def _rqs_columns_on(circ: Tuple[bool, ...], device: torch.device):
    """(euclidean columns, circular columns, the order restoring the dims
    from [euclidean | circular])."""
    circ = np.asarray(circ, dtype=bool)
    e, c = np.where(~circ)[0], np.where(circ)[0]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (e, c, np.argsort(np.concatenate([e, c]))))


def conditioner_all_dims(params: dict, x: torch.Tensor,
                         cfg: NSFConfig) -> torch.Tensor:
    """All dims' spline parameters in one batched pass: (n, d) -> (n, d, 3K)."""
    mask = _ar_mask_on(cfg.dim, x.device)
    w1 = params["W1"] * mask[:, None, :]
    h1 = torch.tanh(torch.einsum("nj,ihj->nih", x, w1) + params["b1"])
    h2 = torch.tanh(torch.einsum("nih,igh->nig", h1, params["W2"]) +
                    params["b2"])
    return torch.einsum("nih,iph->nip", h2, params["W3"]) + params["b3"]


def _conditioner_one_dim(params: dict, x: torch.Tensor, i: int,
                         cfg: NSFConfig) -> torch.Tensor:
    """Spline parameters for dim ``i`` only: (n, d) -> (n, 3K)."""
    mask = torch.as_tensor(autoregressive_mask(cfg.dim)[i], device=x.device)
    w1 = params["W1"][i] * mask[None, :]
    h1 = torch.tanh(x @ w1.T + params["b1"][i])
    h2 = torch.tanh(h1 @ params["W2"][i].T + params["b2"][i])
    return h2 @ params["W3"][i].T + params["b3"][i]


def _split_spline_params(P: torch.Tensor, cfg: NSFConfig):
    K = cfg.num_knots
    return P[..., :K], P[..., K:2 * K], P[..., 2 * K:]


def _apply_rqs_mixed(x, W, H, D, cfg: NSFConfig, inverse: bool):
    """Apply RQS per column, routing circular dims to periodic splines."""
    circ = cfg.circular_mask
    K = cfg.num_knots
    if not circ.any():
        return unconstrained_rqs(x, W, H, D[..., :K - 1], inverse=inverse,
                                 tail_bound=cfg.tail_bound)
    if circ.all():
        return unconstrained_rqs(x, W, H, D, inverse=inverse,
                                 tail_bound=math.pi, circular=True)
    e_idx, c_idx, order = _rqs_columns_on(tuple(circ.tolist()), x.device)
    oe, lde = unconstrained_rqs(
        x[..., e_idx], W[..., e_idx, :], H[..., e_idx, :],
        D[..., e_idx, :K - 1], inverse=inverse, tail_bound=cfg.tail_bound)
    oc, ldc = unconstrained_rqs(
        x[..., c_idx], W[..., c_idx, :], H[..., c_idx, :], D[..., c_idx, :],
        inverse=inverse, tail_bound=math.pi, circular=True)
    # columns come back as [euclidean | circular]; restore the dim order
    out = torch.cat([oe, oc], dim=-1)[..., order]
    ld = torch.cat([lde, ldc], dim=-1)[..., order]
    return out, ld


def _apply_rqs_one_dim(x_i, P_i, i: int, cfg: NSFConfig, inverse: bool):
    W, H, D = _split_spline_params(P_i, cfg)
    if bool(cfg.circular_mask[i]):
        return unconstrained_rqs(x_i, W, H, D, inverse=inverse,
                                 tail_bound=math.pi, circular=True)
    return unconstrained_rqs(x_i, W, H, D[..., :cfg.num_knots - 1],
                             inverse=inverse, tail_bound=cfg.tail_bound)


# --------------------------------------------------------------------------
# Single-flow forward / inverse
# --------------------------------------------------------------------------
def flow_forward(params: dict, x: torch.Tensor, cfg: NSFConfig):
    """x -> (z, log_det) with log_det summed over dims; fully batched."""
    P = conditioner_all_dims(params, x, cfg)
    W, H, D = _split_spline_params(P, cfg)
    z, ld = _apply_rqs_mixed(x, W, H, D, cfg, inverse=False)
    return z, torch.sum(ld, dim=-1)


def flow_inverse(params: dict, z: torch.Tensor, cfg: NSFConfig,
                 x_prefix: torch.Tensor | None = None, start_dim: int = 0):
    """Sequential-in-dim inverse: ``x_prefix`` (n, start_dim) supplies the
    known (separator) columns; dims >= start_dim are inverted, consuming z
    columns in order.  Returns the full (n, dim) tensor."""
    n = z.shape[0]
    x = torch.zeros((n, cfg.dim), dtype=z.dtype, device=z.device)
    if start_dim > 0:
        x[:, :start_dim] = x_prefix[:, :start_dim]
    for i in range(start_dim, cfg.dim):
        P_i = _conditioner_one_dim(params, x, i, cfg)
        x[:, i], _ = _apply_rqs_one_dim(z[:, i - start_dim], P_i, i, cfg,
                                        inverse=True)
    return x


def flow_inverse_masked(params: dict, z_full: torch.Tensor,
                        x_prefix_full: torch.Tensor,
                        invert_mask: torch.Tensor,
                        cfg: NSFConfig) -> torch.Tensor:
    """Inverse where the separator/frontal split is data: ``z_full``
    (n, dim) carries latent draws at the columns to invert,
    ``x_prefix_full`` (n, dim) known values at prefix columns, and
    ``invert_mask`` (dim,) booleans select which.  Columns not yet
    reached are zero while dim ``i``'s conditioner runs."""
    n = z_full.shape[0]
    x = torch.zeros((n, cfg.dim), dtype=z_full.dtype, device=z_full.device)
    for i in range(cfg.dim):
        P_i = _conditioner_one_dim(params, x, i, cfg)
        x_inv, _ = _apply_rqs_one_dim(z_full[:, i], P_i, i, cfg,
                                      inverse=True)
        x[:, i] = torch.where(invert_mask[i], x_inv, x_prefix_full[:, i])
    return x


# --------------------------------------------------------------------------
# Flow stacks
# --------------------------------------------------------------------------
def stack_forward(flow_params: List[dict], x: torch.Tensor, cfg: NSFConfig):
    """Compose flows; returns (z, total_log_det)."""
    total_ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for params in flow_params:
        x, ld = flow_forward(params, x, cfg)
        total_ld = total_ld + ld
    return x, total_ld


def stack_forward_perdim(flow_params: List[dict], x: torch.Tensor,
                         cfg: NSFConfig):
    """Compose flows keeping the per-dim log-det columns (n, dim)."""
    total_ld = torch.zeros_like(x)
    for params in flow_params:
        P = conditioner_all_dims(params, x, cfg)
        W, H, D = _split_spline_params(P, cfg)
        x, ld = _apply_rqs_mixed(x, W, H, D, cfg, inverse=False)
        total_ld = total_ld + ld
    return x, total_ld


def stack_inverse_masked(flow_params: List[dict], z_full: torch.Tensor,
                         x_prefix_full: torch.Tensor,
                         invert_mask: torch.Tensor,
                         cfg: NSFConfig) -> torch.Tensor:
    """Invert the stack (last flow first) with a data-driven prefix mask;
    returns the full (n, dim) block."""
    for params in reversed(flow_params):
        x_full = flow_inverse_masked(params, z_full, x_prefix_full,
                                     invert_mask, cfg)
        # the next (earlier) flow inverts what this flow produced at the
        # inverted columns; prefix columns stay pinned
        z_full = x_full
    return x_full


def stack_inverse(flow_params: List[dict], z: torch.Tensor, cfg: NSFConfig,
                  x_prefix: torch.Tensor | None = None, start_dim: int = 0):
    """Invert the stack (last flow first); with a separator prefix each
    flow's inverse clamps the known columns."""
    for params in reversed(flow_params):
        x_full = flow_inverse(params, z, cfg, x_prefix, start_dim)
        z = x_full[:, start_dim:]
    return x_full
