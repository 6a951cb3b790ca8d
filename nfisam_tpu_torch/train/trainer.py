"""Per-clique flow training: a plain PyTorch Adam loop.

Counterpart of ``fit_flow_raw`` in ``nfisam_tpu/train/trainer.py``:
parameter init from ``init_flow_params``, the circular-aware normalizer,
full-batch Adam with optax's semantics (b1 0.9, b2 0.999, eps 1e-8, bias
correction) on one flat parameter vector, gradients by autograd through
the forward RQS, and the loss-plateau stop: at an iteration ``t`` with
``t % w == 0 and t >= 2w`` the mean losses of the last two windows are
compared, and if their relative change is below ``loss_delta_tol`` the
update of that iteration is skipped and training ends.  The losses stay
on the device; the host reads them only at those checks.  The JAX
package's validation-based stop (``training_set_frac < 1``) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..flows.base_dist import BaseDistribution
from ..flows.model import (compute_normalizer, negative_log_likelihood,
                           normalize)
from ..flows.nsf import PARAM_NAMES, NSFConfig, init_flow_params
from ..utils.keys import split_host, torch_generator

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters."""
    max_iters: int = 2000
    learning_rate: float = 0.015
    average_window: int = 50
    loss_delta_tol: float = 1e-2


def _flatten(flow_params: List[dict]):
    """One flat leaf tensor and a function rebuilding the per-flow dicts
    as views into it."""
    shapes = [[(k, p[k].shape) for k in PARAM_NAMES] for p in flow_params]
    flat = torch.cat([p[k].reshape(-1) for p in flow_params
                      for k in PARAM_NAMES]).detach().clone()

    def unravel(vec: torch.Tensor) -> List[dict]:
        out, off = [], 0
        for flow in shapes:
            params = {}
            for k, shape in flow:
                size = int(np.prod(shape))
                params[k] = vec[off:off + size].view(shape)
                off += size
            out.append(params)
        return out

    return flat, unravel


def plateau_window(tc: TrainConfig) -> int:
    """The plateau window, clamped so tiny ``max_iters`` never reach past
    the loss record."""
    return min(tc.average_window, max(tc.max_iters // 2, 1))


def train_flow(flow_params: List[dict], data: torch.Tensor, cfg: NSFConfig,
               tc: TrainConfig):
    """Adam on the full batch ``data`` (normalized samples) from
    ``flow_params``.  Returns (params, iter_loss (max_iters,), n_iters)."""
    base = BaseDistribution(cfg.circular_mask)
    flat, unravel = _flatten(flow_params)
    flat.requires_grad_(True)
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    iter_loss = torch.zeros(tc.max_iters, dtype=torch.float32,
                            device=data.device)
    w = plateau_window(tc)
    t = 0
    while t < tc.max_iters:
        if t % w == 0 and t >= 2 * w:
            cur = iter_loss[t - w:t].mean()
            prev = iter_loss[t - 2 * w:t - w].mean()
            prev = torch.where(prev == 0.0, torch.ones_like(prev), prev)
            if float(torch.abs(1.0 - cur / prev)) < tc.loss_delta_tol:
                # stopping iteration: no update, loss curve kept continuous
                iter_loss[t] = iter_loss[t - 1]
                t += 1
                break
        loss = negative_log_likelihood(unravel(flat), data, cfg, base)
        (grad,) = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            step = t + 1
            mu.mul_(ADAM_B1).add_(grad, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(grad, grad, value=1.0 - ADAM_B2)
            mu_hat = mu / (1.0 - ADAM_B1 ** step)
            nu_hat = nu / (1.0 - ADAM_B2 ** step)
            flat -= tc.learning_rate * mu_hat / (torch.sqrt(nu_hat) +
                                                 ADAM_EPS)
            iter_loss[t] = loss.detach()
        t += 1
    return [{k: v.detach() for k, v in p.items()} for p in unravel(flat)], \
        iter_loss, t


def fit_flow_raw(key, samples_raw: torch.Tensor, cfg: NSFConfig,
                 tc: TrainConfig, circular_dim_list,
                 scale_circular: bool = True):
    """Fit a clique flow from raw (unnormalized) samples: init from the
    key, normalize, train.  Returns (params, iter_loss, n_iters, mean,
    std)."""
    device = samples_raw.device
    samples_raw = samples_raw.to(torch.float32)
    k_init, _ = split_host(key, 2)
    params = init_flow_params(torch_generator(k_init, device), cfg, device)
    circ = torch.as_tensor(np.asarray(circular_dim_list, dtype=bool),
                           device=device)
    mean, std = compute_normalizer(samples_raw, circ,
                                   scale_circular=scale_circular)
    xn = normalize(samples_raw, mean, std, circ)
    params, iter_loss, n_iters = train_flow(params, xn, cfg, tc)
    return params, iter_loss, n_iters, mean, std
