"""Per-clique flow training: a plain PyTorch Adam loop.

Counterpart of ``fit_flow_raw`` in ``nfisam_tpu/train/trainer.py``:
parameter init from ``init_flow_params``, the circular-aware normalizer,
full-batch Adam with optax's semantics (b1 0.9, b2 0.999, eps 1e-8, bias
correction) on one flat parameter vector, gradients by autograd through
the forward RQS, and the loss-plateau stop: at an iteration ``t`` with
``t % w == 0 and t >= 2w`` the mean losses of the last two windows are
compared, and if their relative change is below ``loss_delta_tol`` the
update of that iteration is skipped and training ends.  With
``training_set_frac < 1`` the samples are shuffled and split, and the
validation-based "slower stop" replaces the plateau stop: every
``validation_interval`` iterations (at ``t + 1`` a multiple of it) the
held-out loss is computed with the parameters before that iteration's
update; the first time it rises above the last one kept, training is set
to stop at iteration ``slower_stop_rate * (t + 1)``, whose update is
skipped.  The losses stay on the device; the host reads them only at those
checks.  ``fit_flows_batched`` trains a stack of same-signature cliques
in one loop, as the JAX package's ``vmap`` of the fit does.

On a card, ``train_flow``'s plateau-stopped fit captures the loss and
its gradient by autograd in a CUDA graph and replays it every iteration
(``_GraphedLossGrad``): the same kernels in the same order as the eager
pass, so the same bits, for one launch where the eager pass issues a few
hundred.  The host still reads the losses only at the plateau checks.

With a (clique, data) ``mesh`` of several ranks (``parallel/mesh.py``),
as the JAX package's sharded fits: ``fit_flow_raw`` splits the samples
over every rank of the mesh, ``fit_flows_batched`` the cliques over the
clique axis and the samples over the data axis.  A rank's loss is its
rows' NLL sum over the global row count and the gradient and loss are
summed over the ranks sharing the fit before Adam, so each rank steps as
the full batch would, and every rank ends with every clique's results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

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
    validation_interval: int = 10
    slower_stop_rate: float = 2.0
    training_set_frac: float = 1.0


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


@dataclass(frozen=True)
class RowShard:
    """This rank's rows of a fit shared by several ranks: the loss on them
    is scaled by ``scale`` (local rows over global rows) and ``reduce``
    sums a tensor over the ranks sharing the fit."""
    scale: float
    reduce: Callable[[torch.Tensor], torch.Tensor]


def plateau_window(tc: TrainConfig) -> int:
    """The plateau window, clamped so tiny ``max_iters`` never reach past
    the loss record."""
    return min(tc.average_window, max(tc.max_iters // 2, 1))


def slower_stop_iteration(tc: TrainConfig, t: int) -> int:
    """The stop the validation rule sets when the held-out loss rises at
    iteration ``t``: ``slower_stop_rate * (t + 1)`` in float32, truncated,
    as the JAX package's ``jnp.int32`` of it."""
    return int(np.float32(tc.slower_stop_rate) * np.float32(t + 1))


class _GraphedLossGrad:
    """``train_flow``'s loss and its gradient on a card, captured in a CUDA
    graph once and replayed for every iteration: the same kernels in the
    same order as the eager pass, so the same bits, for one launch where
    the eager pass issues a few hundred.  The Adam update stays eager (a
    graph of it left the eager bits on the card).  A pass that cannot be
    captured raises: nothing falls back to the eager loop."""

    def __init__(self, loss_fn: Callable, flat: torch.Tensor):
        stream = torch.cuda.current_stream(flat.device)
        side = torch.cuda.Stream(flat.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):    # warm-up, off the fit's state
            probe = flat.detach().clone().requires_grad_(True)
            torch.autograd.grad(loss_fn(probe), probe)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            loss = loss_fn(flat)
            (self.grad,) = torch.autograd.grad(loss, flat)
        self.loss = loss.detach()

    def __call__(self) -> tuple:
        """(loss, gradient) at ``flat``'s current value: the graph's
        buffers, overwritten by the next replay."""
        self.graph.replay()
        return self.loss, self.grad


def train_flow(flow_params: List[dict], data: torch.Tensor, cfg: NSFConfig,
               tc: TrainConfig, test_data: torch.Tensor | None = None,
               shard: Optional[RowShard] = None):
    """Adam on the full batch ``data`` (normalized samples) from
    ``flow_params``, with the plateau stop, or the validation stop on
    ``test_data`` when it is given; with ``shard``, ``data`` is this
    rank's part of the batch.  Returns (params, iter_loss (max_iters,),
    n_iters)."""
    base = BaseDistribution(cfg.circular_mask)
    flat, unravel = _flatten(flow_params)
    flat.requires_grad_(True)
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    iter_loss = torch.zeros(tc.max_iters, dtype=torch.float32,
                            device=data.device)
    w = plateau_window(tc)
    last_val, slow = float("inf"), -1
    graphed = None
    if data.is_cuda and test_data is None and shard is None and \
            tc.max_iters > 0:
        graphed = _GraphedLossGrad(
            lambda v: negative_log_likelihood(unravel(v), data, cfg, base),
            flat)
    t = 0
    while t < tc.max_iters:
        if test_data is not None:
            if (t + 1) % tc.validation_interval == 0 and slow < 0:
                with torch.no_grad():
                    val = float(negative_log_likelihood(
                        unravel(flat), test_data, cfg, base))
                if val > last_val:
                    slow = slower_stop_iteration(tc, t)
                else:
                    last_val = val
            stop = slow >= 0 and t + 1 >= slow
        elif t % w == 0 and t >= 2 * w:
            cur = iter_loss[t - w:t].mean()
            prev = iter_loss[t - 2 * w:t - w].mean()
            prev = torch.where(prev == 0.0, torch.ones_like(prev), prev)
            stop = float(torch.abs(1.0 - cur / prev)) < tc.loss_delta_tol
        else:
            stop = False
        if stop:
            # stopping iteration: no update, loss curve kept continuous
            iter_loss[t] = iter_loss[max(t - 1, 0)]
            t += 1
            break
        if graphed is not None:
            loss, grad = graphed()
        else:
            loss = negative_log_likelihood(unravel(flat), data, cfg, base)
            (grad,) = torch.autograd.grad(loss, flat)
        if shard is not None:
            both = shard.reduce(torch.cat([grad, loss.detach()[None]]) *
                                shard.scale)
            grad, loss = both[:-1], both[-1]
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
                        circular_dim_list, scale_circular: bool,
                        tc: TrainConfig):
    """One clique's start: flow parameters from the key; with a held-out
    part, the samples shuffled by a permutation from the key; the
    normalizer over all of them, and the normalized samples split.
    Returns (params, train rows, held-out rows or None, mean, std)."""
    device = samples_raw.device
    samples_raw = samples_raw.to(torch.float32)
    k_init, k_shuffle = split_host(key, 2)
    params = init_flow_params(torch_generator(k_init, device), cfg, device)
    n = samples_raw.shape[0]
    n_train = min(int(n * tc.training_set_frac), n)   # the rest held out
    if n_train < n:
        # the split needs the shuffle; the full-batch loss does not
        perm = torch.randperm(n, generator=torch_generator(k_shuffle, device),
                              device=device)
        samples_raw = samples_raw[perm]
    circ = torch.as_tensor(np.asarray(circular_dim_list, dtype=bool),
                           device=device)
    mean, std = compute_normalizer(samples_raw, circ,
                                   scale_circular=scale_circular)
    xn = normalize(samples_raw, mean, std, circ)
    test = xn[n_train:] if n_train < n else None
    return params, xn[:n_train], test, mean, std


def _row_shard(n: int, mesh, axis) -> tuple:
    """(this rank's rows, ``RowShard``) of ``n`` rows split over ``axis``
    of ``mesh`` (None: every rank); all rows and no shard where the axis
    has one rank."""
    from ..parallel.mesh import all_reduce_sum
    parts = mesh.parts(axis)
    if parts == 1:
        return slice(None), None
    rows = mesh.rows(n, axis)
    group = mesh.group(axis)
    return rows, RowShard((rows.stop - rows.start) / n,
                          lambda t: all_reduce_sum(t, group))


def fit_flow(key, samples_norm: torch.Tensor, cfg: NSFConfig,
             tc: TrainConfig, mesh=None,
             init_params: Optional[List[dict]] = None):
    """Train a flow stack on pre-normalized samples, from ``init_params``
    or from parameters drawn from the key.  The samples are shuffled by a
    permutation from the key and, with ``training_set_frac < 1``, split
    into training and held-out rows.  With a ``mesh`` of several ranks the
    training rows are cut to a multiple of its ranks and split over them.
    Returns (params, iter_loss (max_iters,), n_iters)."""
    device = samples_norm.device
    k_init, k_shuffle = split_host(key, 2)
    if init_params is None:
        init_params = init_flow_params(torch_generator(k_init, device), cfg,
                                       device)
    n = samples_norm.shape[0]
    perm = torch.randperm(n, generator=torch_generator(k_shuffle, device),
                          device=device)
    samples_norm = samples_norm.to(torch.float32)[perm]
    n_train = min(int(n * tc.training_set_frac), n)
    train = samples_norm[:n_train]
    test = samples_norm[n_train:] if n_train < n else None
    shard = None
    if mesh is not None and mesh.size > 1:
        train = train[:(n_train // mesh.size) * mesh.size]
        rows, shard = _row_shard(train.shape[0], mesh, None)
        train = train[rows]
    return train_flow(init_params, train, cfg, tc, test, shard)


def fit_flow_raw(key, samples_raw: torch.Tensor, cfg: NSFConfig,
                 tc: TrainConfig, circular_dim_list,
                 scale_circular: bool = True, mesh=None):
    """Fit a clique flow from raw (unnormalized) samples: init from the
    key, normalize, train.  Returns (params, iter_loss, n_iters, mean,
    std).

    With a ``mesh`` of several ranks the samples are cut to a multiple of
    the ranks (kept whole, in every rank, where there are fewer samples
    than ranks) and the training rows split over every rank, as the JAX
    package shards a lone clique's fit over all its devices."""
    shard_all = mesh is not None and mesh.size > 1
    if shard_all:
        keep = (samples_raw.shape[0] // mesh.size) * mesh.size
        if keep == 0:
            shard_all = False
        else:
            samples_raw = samples_raw[:keep]
    params, train, test, mean, std = _init_and_normalize(
        key, samples_raw, cfg, circular_dim_list, scale_circular, tc)
    shard = None
    if shard_all:
        rows, shard = _row_shard(train.shape[0], mesh, None)
        train = train[rows]
    params, iter_loss, n_iters = train_flow(params, train, cfg, tc, test,
                                            shard)
    return params, iter_loss, n_iters, mean, std


def train_flows_batched(flow_params: List[dict], data: torch.Tensor,
                        cfg: NSFConfig, tc: TrainConfig,
                        test_data: torch.Tensor | None = None,
                        shard: Optional[RowShard] = None):
    """``train_flow`` for B independent members in lockstep:
    ``flow_params`` carry a leading member axis on every tensor, ``data``
    is (B, n, dim) (with ``shard``, this rank's rows of every member),
    ``test_data`` (B, n_test, dim) or None.  Returns (params, iter_loss
    (B, max_iters), n_iters as a list of B ints).

    The JAX package runs ``vmap`` of its ``while_loop``; this is that
    loop's semantics on the host: every member checks its stop rule at the
    same ``t``, a member that stops skips that update, records
    ``n_iters = t + 1`` and stays frozen (parameters, Adam moments, loss
    curve) from then on, and the loop ends when every member has stopped
    or at ``max_iters``.  The host reads the B plateau flags once a
    window, or the B held-out losses once a validation interval (a
    member's stop iteration is then known on the host).
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
    val_losses = torch.func.vmap(member_loss)
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    iter_loss = torch.zeros((B, tc.max_iters), dtype=torch.float32,
                            device=data.device)
    n_iters = [tc.max_iters] * B
    running = [True] * B
    active = torch.ones((B, 1), dtype=torch.bool, device=data.device)
    w = plateau_window(tc)
    last_val, slow = [float("inf")] * B, [-1] * B
    t = 0
    while t < tc.max_iters:
        stopping = []
        if test_data is not None:
            if (t + 1) % tc.validation_interval == 0 and \
                    any(running[b] and slow[b] < 0 for b in range(B)):
                with torch.no_grad():
                    vals = val_losses(flat, test_data).tolist()
                for b, val in enumerate(vals):
                    if not running[b] or slow[b] >= 0:
                        continue
                    if val > last_val[b]:
                        slow[b] = slower_stop_iteration(tc, t)
                    else:
                        last_val[b] = val
            stopping = [b for b in range(B) if running[b] and
                        0 <= slow[b] <= t + 1]
        elif t % w == 0 and t >= 2 * w:
            # each member's windows reduced as ``train_flow`` reduces them,
            # so a member stops where its own fit would
            cur = torch.stack([iter_loss[b, t - w:t].mean()
                               for b in range(B)])
            prev = torch.stack([iter_loss[b, t - 2 * w:t - w].mean()
                                for b in range(B)])
            prev = torch.where(prev == 0.0, torch.ones_like(prev), prev)
            deltas = torch.abs(1.0 - cur / prev).tolist()
            stopping = [b for b, delta in enumerate(deltas)
                        if delta < tc.loss_delta_tol and running[b]]
        if stopping:
            for b in stopping:
                running[b] = False
                iter_loss[b, t] = iter_loss[b, max(t - 1, 0)]
                n_iters[b] = t + 1
            if not any(running):
                break
            active = torch.as_tensor(running, device=data.device)[:, None]
        grad, loss = grad_and_loss(flat, data)
        if shard is not None:
            both = shard.reduce(torch.cat([grad, loss[:, None]], 1) *
                                shard.scale)
            grad, loss = both[:, :-1], both[:, -1]
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
                      scale_circular: bool = True, mesh=None):
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

    With a ``mesh`` of several ranks: the sample axis is cut to a multiple
    of the data axis (kept whole where it is shorter), B padded to a
    multiple of the clique axis by repeating the last clique, each clique
    index trains its block of cliques on its data rows, and the blocks are
    gathered over the clique axis (the padding dropped).
    """
    keys = np.asarray(keys)
    masks = np.asarray(circ_masks, dtype=bool)
    B = samples_stack.shape[0]
    sharded = mesh is not None and mesh.size > 1
    shard, cliques, split_rows = None, slice(None), False
    if sharded:
        n = samples_stack.shape[1]
        keep_n = (n // mesh.shape["data"]) * mesh.shape["data"]
        split_rows = keep_n > 0
        if split_rows and keep_n != n:
            samples_stack = samples_stack[:, :keep_n]
        pad_b = (-B) % mesh.shape["clique"]
        if pad_b:
            samples_stack = torch.cat([samples_stack, samples_stack[-1:].expand(
                (pad_b,) + tuple(samples_stack.shape[1:]))])
            keys = np.concatenate([keys, np.repeat(keys[-1:], pad_b, 0)])
            masks = np.concatenate([masks, np.repeat(masks[-1:], pad_b, 0)])
        cliques = mesh.rows(B + pad_b, "clique")
    starts = [_init_and_normalize(keys[b], samples_stack[b], cfg, masks[b],
                                  scale_circular, tc)
              for b in range(samples_stack.shape[0])[cliques]]
    params0 = [{k: torch.stack([s[0][f][k] for s in starts])
                for k in PARAM_NAMES} for f in range(cfg.num_flows)]
    data = torch.stack([s[1] for s in starts])
    if split_rows:
        rows, shard = _row_shard(data.shape[1], mesh, "data")
        data = data[:, rows]
    test = None if starts[0][2] is None else \
        torch.stack([s[2] for s in starts])
    params, iter_loss, n_iters = train_flows_batched(params0, data, cfg, tc,
                                                     test, shard)
    out = (params, iter_loss, n_iters,
           torch.stack([s[3] for s in starts]),
           torch.stack([s[4] for s in starts]))
    if sharded and mesh.shape["clique"] > 1:
        out = gather_fits(out, mesh.group("clique"), B)
    return out


def gather_fits(out, group, B: int):
    """``fit_flows_batched``'s outputs of every rank of ``group``, each a
    block of the cliques, gathered on the host (parameter stacks are
    kilobytes) in rank order; the first ``B`` cliques are kept."""
    from ..parallel.mesh import all_gather_objects
    if group is None:
        return out
    params, iter_loss, n_iters, mean, std = out
    device = iter_loss.device
    host = ([{k: v.cpu() for k, v in p.items()} for p in params],
            iter_loss.cpu(), list(n_iters), mean.cpu(), std.cpu())
    parts = all_gather_objects(host, group)

    def cat(i):
        return torch.cat([part[i] for part in parts])[:B].to(device)

    return ([{k: torch.cat([part[0][f][k] for part in parts])[:B].to(device)
              for k in PARAM_NAMES} for f in range(len(params))],
            cat(1), [t for part in parts for t in part[2]][:B], cat(3),
            cat(4))
