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
``fit_flows_batched`` trains a stack of same-signature cliques in one
loop, as the JAX package's ``vmap`` of the fit does.
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


def _init_and_normalize(key, samples_raw: torch.Tensor, cfg: NSFConfig,
                        circular_dim_list, scale_circular: bool):
    """One clique's start: flow parameters from the key, the normalizer
    and the normalized samples.  Returns (params, xn, mean, std)."""
    device = samples_raw.device
    samples_raw = samples_raw.to(torch.float32)
    k_init, _ = split_host(key, 2)
    params = init_flow_params(torch_generator(k_init, device), cfg, device)
    circ = torch.as_tensor(np.asarray(circular_dim_list, dtype=bool),
                           device=device)
    mean, std = compute_normalizer(samples_raw, circ,
                                   scale_circular=scale_circular)
    return params, normalize(samples_raw, mean, std, circ), mean, std


def fit_flow_raw(key, samples_raw: torch.Tensor, cfg: NSFConfig,
                 tc: TrainConfig, circular_dim_list,
                 scale_circular: bool = True):
    """Fit a clique flow from raw (unnormalized) samples: init from the
    key, normalize, train.  Returns (params, iter_loss, n_iters, mean,
    std)."""
    params, xn, mean, std = _init_and_normalize(
        key, samples_raw, cfg, circular_dim_list, scale_circular)
    params, iter_loss, n_iters = train_flow(params, xn, cfg, tc)
    return params, iter_loss, n_iters, mean, std


def train_flows_batched(flow_params: List[dict], data: torch.Tensor,
                        cfg: NSFConfig, tc: TrainConfig):
    """``train_flow`` for B independent members in lockstep:
    ``flow_params`` carry a leading member axis on every tensor, ``data``
    is (B, n, dim).  Returns (params, iter_loss (B, max_iters), n_iters
    as a list of B ints).

    The JAX package runs ``vmap`` of its ``while_loop``; this is that
    loop's semantics on the host: every member checks the plateau at the
    same ``t``, a member that plateaus skips that update, records
    ``n_iters = t + 1`` and stays frozen (parameters, Adam moments, loss
    curve) from then on, and the loop ends when every member has stopped
    or at ``max_iters``.  The host reads the B stop flags once a window.
    """
    base = BaseDistribution(cfg.circular_mask)
    B = data.shape[0]
    _, unravel = _flatten([{k: v[0] for k, v in p.items()}
                           for p in flow_params])
    flat = torch.cat([p[k].reshape(B, -1) for p in flow_params
                      for k in PARAM_NAMES], dim=1).detach().clone()

    def member_loss(vec, x):
        return negative_log_likelihood(unravel(vec), x, cfg, base)

    # torch.func.vmap over the single-member loss, not a forward written
    # again with a leading member axis: each member's loss and gradient are
    # then the very function ``train_flow`` differentiates, and one set of
    # launches a step serves all B members
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(member_loss))
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    iter_loss = torch.zeros((B, tc.max_iters), dtype=torch.float32,
                            device=data.device)
    n_iters = [tc.max_iters] * B
    running = [True] * B
    active = torch.ones((B, 1), dtype=torch.bool, device=data.device)
    w = plateau_window(tc)
    t = 0
    while t < tc.max_iters:
        if t % w == 0 and t >= 2 * w:
            # each member's windows reduced as ``train_flow`` reduces them,
            # so a member stops where its own fit would
            cur = torch.stack([iter_loss[b, t - w:t].mean()
                               for b in range(B)])
            prev = torch.stack([iter_loss[b, t - 2 * w:t - w].mean()
                                for b in range(B)])
            prev = torch.where(prev == 0.0, torch.ones_like(prev), prev)
            deltas = torch.abs(1.0 - cur / prev).tolist()
            for b, delta in enumerate(deltas):
                if delta < tc.loss_delta_tol and running[b]:
                    running[b] = False
                    iter_loss[b, t] = iter_loss[b, t - 1]
                    n_iters[b] = t + 1
            if not any(running):
                break
            active = torch.as_tensor(running, device=data.device)[:, None]
        grad, loss = grad_and_loss(flat, data)
        with torch.no_grad():
            step = t + 1
            mu_new = mu.mul(ADAM_B1).add(grad, alpha=1.0 - ADAM_B1)
            nu_new = nu.mul(ADAM_B2).addcmul(grad, grad, value=1.0 - ADAM_B2)
            mu_hat = mu_new / (1.0 - ADAM_B1 ** step)
            nu_hat = nu_new / (1.0 - ADAM_B2 ** step)
            flat_new = flat - tc.learning_rate * mu_hat / (
                torch.sqrt(nu_hat) + ADAM_EPS)
            if all(running):
                mu, nu, flat = mu_new, nu_new, flat_new
                iter_loss[:, t] = loss
            else:
                mu = torch.where(active, mu_new, mu)
                nu = torch.where(active, nu_new, nu)
                flat = torch.where(active, flat_new, flat)
                iter_loss[:, t] = torch.where(active[:, 0], loss,
                                              iter_loss[:, t])
        t += 1
    members = [unravel(flat[b]) for b in range(B)]
    params = [{k: torch.stack([m[f][k] for m in members])
               for k in PARAM_NAMES} for f in range(len(flow_params))]
    return params, iter_loss, n_iters


def fit_flows_batched(keys, samples_stack: torch.Tensor, cfg: NSFConfig,
                      tc: TrainConfig, circ_masks,
                      scale_circular: bool = True):
    """Train B same-signature clique flows in lockstep (the JAX package's
    ``fit_flows_batched``).

    ``keys`` (B, 2) uint32 raw keys; ``samples_stack`` (B, n, dim) raw
    samples on the device to train on; ``circ_masks`` (B, dim) booleans.
    Each member starts exactly as ``fit_flow_raw`` starts it from its own
    key (parameters, its own normalizer), and the members then train in
    one loop (``train_flows_batched``).  Returns stacked (params, iter_loss
    (B, max_iters), n_iters (list of B ints), mean (B, dim), std (B, dim)).

    The JAX package pads B to a power of two and caches one compiled
    program per (config, n, B); both exist to bound compilation.  PyTorch
    runs eagerly and compiles nothing per shape, so there is neither here.
    """
    keys = np.asarray(keys)
    masks = np.asarray(circ_masks, dtype=bool)
    starts = [_init_and_normalize(keys[b], samples_stack[b], cfg, masks[b],
                                  scale_circular)
              for b in range(samples_stack.shape[0])]
    params0 = [{k: torch.stack([s[0][f][k] for s in starts])
                for k in PARAM_NAMES} for f in range(cfg.num_flows)]
    data = torch.stack([s[1] for s in starts])
    params, iter_loss, n_iters = train_flows_batched(params0, data, cfg, tc)
    return (params, iter_loss, n_iters,
            torch.stack([s[2] for s in starts]),
            torch.stack([s[3] for s in starts]))
