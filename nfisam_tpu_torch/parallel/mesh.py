"""A (clique, data) mesh over the ranks of a ``torch.distributed`` group,
and the sharded training step and conditional sampler on it.

Counterpart of ``nfisam_tpu/parallel/mesh.py``.  The JAX package lays its
devices out on a ``jax.sharding.Mesh`` and XLA inserts the collectives;
here each device is a rank of the default process group
(``multihost.init_process_group``) and the collectives are explicit:

* ``data`` axis: the rows of a fit or of a posterior draw are split into
  contiguous blocks over the ranks of one clique index.  A fit's loss on
  a rank is its rows' NLL sum over the global row count, so the gradient
  summed over the axis is the full batch's; drawn rows are gathered back,
  so every rank holds the whole block;
* ``clique`` axis: a bucket of same-signature cliques is split into
  contiguous blocks over the clique indices, and the trained stacks are
  gathered.

Rank ``r`` sits at ``(r // n_data, r % n_data)``, as the JAX package
reshapes its device list.  Without a process group the mesh has one rank
and runs no collective.  Collectives on CUDA tensors over a ``gloo``
group (ranks sharing one card) go through the host; see
``multihost.init_process_group`` for the choice of backend.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..flows.ar_inverse import (stack_inverse_masked_cuda,
                                stack_inverse_masked_plain)
from ..flows.base_dist import BaseDistribution
from ..flows.model import negative_log_likelihood
from ..flows.nsf import PARAM_NAMES, NSFConfig, init_flow_params
from ..train.trainer import ADAM_B1, ADAM_B2, ADAM_EPS, _flatten
from ..utils.device import resolve_device
from ..utils.keys import split_host, torch_generator


def world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def row_block(n: int, parts: int, index: int) -> slice:
    """Contiguous block ``index`` of ``n`` rows split ``parts`` ways (the
    first ``n % parts`` blocks one row longer)."""
    return slice(index * n // parts, (index + 1) * n // parts)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor on ``t``'s device)."""
    if group is None:
        return t
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        buf = t.detach().cpu()
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)
    buf = t.detach().clone()
    dist.all_reduce(buf, group=group)
    return buf


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Equal row blocks of ``group``'s ranks concatenated in rank order."""
    if group is None:
        return t
    staged = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = t.detach().cpu() if staged else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).to(t.device)


def all_gather_objects(obj, group) -> list:
    """Every rank's ``obj`` of ``group``, in rank order (pickled on the
    host: for kilobytes, such as trained parameter stacks)."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class Mesh:
    """A (clique, data) grid over ranks ``devices`` of the default process
    group.  ``shape`` maps axis to size; ``clique_index`` and
    ``data_index`` place this rank; ``group(axis)`` is the sub-group of
    the ranks that share this rank's other index (None where the axis has
    one rank), ``group(None)`` every rank of the mesh."""

    axis_names = ("clique", "data")

    def __init__(self, n_clique: int, n_data: int, devices: Sequence[int]):
        self.shape = {"clique": int(n_clique), "data": int(n_data)}
        self.devices = np.asarray(list(devices)).reshape(n_clique, n_data)
        self.size = int(n_clique * n_data)
        rank, _ = world()
        (self.clique_index,), (self.data_index,) = \
            np.nonzero(self.devices == rank)
        self.clique_index, self.data_index = \
            int(self.clique_index), int(self.data_index)
        self._groups = {"clique": None, "data": None, None: None}
        if self.size == 1:
            return
        # ``new_group`` is collective: every rank creates every sub-group,
        # in the same order
        self._groups[None] = dist.new_group(sorted(int(r) for r in devices))
        for c in range(n_clique):
            g = dist.new_group([int(r) for r in self.devices[c]])
            if c == self.clique_index and n_data > 1:
                self._groups["data"] = g
        for d in range(n_data):
            g = dist.new_group([int(r) for r in self.devices[:, d]])
            if d == self.data_index and n_clique > 1:
                self._groups["clique"] = g

    def group(self, axis: Optional[str]):
        return self._groups[axis]

    def index(self, axis: Optional[str]) -> int:
        """This rank's place along ``axis`` (None: in the whole mesh)."""
        if axis is None:
            return self.clique_index * self.shape["data"] + self.data_index
        return self.clique_index if axis == "clique" else self.data_index

    def parts(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[axis]

    def rows(self, n: int, axis: Optional[str] = "data") -> slice:
        """This rank's contiguous block of ``n`` rows split over ``axis``."""
        return row_block(n, self.parts(axis), self.index(axis))

    def __repr__(self) -> str:
        return f"Mesh(clique={self.shape['clique']}, data={self.shape['data']})"


def make_mesh(n_data: Optional[int] = None, n_clique: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (clique, data) mesh over the ranks ``devices`` (by default
    every rank of the process group, which it must be)."""
    _, size = world()
    devices = list(devices if devices is not None else range(size))
    if n_data is None:
        n_data = len(devices) // n_clique
    assert n_clique * n_data == len(devices), \
        f"{n_clique} x {n_data} != {len(devices)} devices"
    if sorted(devices) != list(range(size)):
        raise ValueError(f"a mesh spans every rank of the process group "
                         f"(world size {size}), not {devices}")
    return Mesh(n_clique, n_data, devices)


def data_parallel_mesh(devices: Optional[Sequence[int]] = None) -> Mesh:
    """Every rank on the data axis."""
    _, size = world()
    devices = list(devices if devices is not None else range(size))
    return make_mesh(n_data=len(devices), n_clique=1, devices=devices)


# --------------------------------------------------------------------------
# Sharded batched-clique training step
# --------------------------------------------------------------------------
def _stack_flat(params_stack: List[dict]) -> torch.Tensor:
    """(B, P) flat parameters of a stack of flows with a clique axis."""
    B = params_stack[0]["W1"].shape[0]
    return torch.cat([p[k].reshape(B, -1) for p in params_stack
                      for k in PARAM_NAMES], dim=1)


def _unstack_flat(flat: torch.Tensor, like: List[dict]) -> List[dict]:
    out, off = [], 0
    for p in like:
        flow = {}
        for k in PARAM_NAMES:
            shape = (flat.shape[0],) + tuple(p[k].shape[1:])
            size = int(np.prod(shape[1:]))
            flow[k] = flat[:, off:off + size].reshape(shape)
            off += size
        out.append(flow)
    return out


def build_sharded_train_step(cfg: NSFConfig, mesh: Mesh,
                             learning_rate: float = 0.015):
    """One Adam step over a stack of same-signature cliques.

    Each rank holds its clique axis block of the parameters and the
    (its cliques, its data rows, dim) block of the samples (``shard``).
    A clique's loss on a rank is its rows' NLL sum over the global row
    count; the gradients and losses are summed over the data axis before
    Adam, so a step is the JAX package's ``value_and_grad`` of the
    summed per-clique mean NLL.  Returns ``(train_step, init, shard)``:
    ``train_step(params, opt_state, data) -> (params, opt_state,
    losses)`` with the losses of every clique of the stack (gathered over
    the clique axis), ``init(key, n_cliques, device=None) -> (params,
    opt_state)`` (``device`` by ``resolve_device``: the card unless the
    caller names another) and ``shard(data_stack)`` this rank's block of a
    (B, n, dim) stack."""
    base = BaseDistribution(cfg.circular_mask)

    def shard(data_stack: torch.Tensor) -> torch.Tensor:
        B, n = data_stack.shape[0], data_stack.shape[1]
        return data_stack[mesh.rows(B, "clique"), mesh.rows(n, "data")]

    def train_step(params_stack, opt_state, data):
        like = params_stack
        flat = _stack_flat(params_stack)
        _, unravel = _flatten([{k: v[0] for k, v in p.items()}
                               for p in params_stack])

        def member_loss(vec, x):
            return negative_log_likelihood(unravel(vec), x, cfg, base)

        grad, loss = torch.func.vmap(torch.func.grad_and_value(member_loss))(
            flat, data)
        # (rows x the mean NLL, its gradient, rows) summed over the data
        # axis, then over the global row count: the full batch's mean
        m = torch.full_like(loss[:, None], data.shape[1])
        both = all_reduce_sum(torch.cat([grad * m, loss[:, None] * m, m], 1),
                              mesh.group("data"))
        grad, loss = both[:, :-2] / both[:, -1:], both[:, -2] / both[:, -1]
        mu, nu, step = opt_state
        step = step + 1
        mu = mu * ADAM_B1 + grad * (1.0 - ADAM_B1)
        nu = nu * ADAM_B2 + grad * grad * (1.0 - ADAM_B2)
        mu_hat = mu / (1.0 - ADAM_B1 ** step)
        nu_hat = nu / (1.0 - ADAM_B2 ** step)
        flat = flat - learning_rate * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
        losses = all_gather_rows(loss, mesh.group("clique"))
        return _unstack_flat(flat, like), (mu, nu, step), losses

    def init(key, n_cliques: int, device=None):
        device = resolve_device(device)
        keys = split_host(key, n_cliques)[mesh.rows(n_cliques, "clique")]
        members = [init_flow_params(torch_generator(k, device), cfg, device)
                   for k in keys]
        params = [{k: torch.stack([m[f][k] for m in members])
                   for k in PARAM_NAMES} for f in range(cfg.num_flows)]
        flat = _stack_flat(params)
        return params, (torch.zeros_like(flat), torch.zeros_like(flat), 0)

    return train_step, init, shard


# --------------------------------------------------------------------------
# Sharded posterior sampling
# --------------------------------------------------------------------------
def shard_samples(mesh: Mesh, samples: torch.Tensor) -> torch.Tensor:
    """This rank's rows of an (n, d) sample block split over the data
    axis."""
    return samples[mesh.rows(samples.shape[0], "data")]


def build_sharded_conditional_sampler(cfg: NSFConfig, mesh: Mesh,
                                      sep_dim: int):
    """Root-to-leaf conditional draw with the sample axis split over every
    rank of the mesh: ``draw(flow_params, x_prefix_norm (n, sep_dim), z
    (n, dim - sep_dim))`` inverts this rank's rows (the kernel on a card,
    the plain version on the CPU) and gathers them, so every rank returns
    the whole (n, dim - sep_dim) block of drawn columns."""

    def draw(flow_params, x_prefix_norm, z):
        n = z.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
        rows = mesh.rows(n, None)
        xp, zl = x_prefix_norm[rows], z[rows]
        m = zl.shape[0]
        z_full = torch.cat([torch.zeros((m, sep_dim), dtype=zl.dtype,
                                        device=zl.device), zl], 1)
        prefix = torch.cat([xp, torch.zeros_like(zl)], 1)
        mask = torch.as_tensor(np.arange(cfg.dim) >= sep_dim,
                               device=zl.device)
        inverse = stack_inverse_masked_cuda if zl.device.type == "cuda" \
            else stack_inverse_masked_plain
        x_full = inverse(flow_params, z_full, prefix, mask, cfg)
        return all_gather_rows(x_full[:, sep_dim:], mesh.group(None))

    return draw
