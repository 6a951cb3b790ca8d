"""Fused root-to-leaf posterior pass over one sample buffer.

Counterpart of ``nfisam_tpu/solver/posterior_pass.py``.  The per-clique
walk (``FactorGraphSolver.sample_posterior_per_clique``) builds each
clique's [observations | separator] block on the host side of the solver
(a host-to-device copy of the observations, a concatenation of separator
views, a mask made from numpy), which synchronises the stream once per
clique.  Here the host walks the tree once, up front:

- the cliques in topological order (parents first): the same DFS with
  ``str``-sorted children as the per-clique walk, so both consume the
  solver's key stream identically;
- one column range per variable in a single (n, D+1) float32 device
  buffer; column D stays zero and is where every prefix column that is
  neither an observation nor a separator reads from;
- per clique, its gather map, observation values and inversion mask,
  packed into arrays that reach the device in one non-blocking copy each.

Then, for each clique in that order: the next key of the solver's
stream, the base draws z from it (as ``CliqueFlowModel.conditional_sample``
draws them), the prefix gathered from the buffer by index,
``conditional_draw_core`` (the masked AR inverse: the CUDA kernel on a
card), and the frontal columns written back.  Nothing in the pass reads a
device value on the host.  On the same solver state and key stream it
gives the per-clique walk's samples bit for bit.  ``pack_plan`` packs
the per-clique arrays and ``run_plan`` is the pass itself, so that a
synthetic chain of cliques (the utilization profile's) runs the same
code as the solver's tree.

With the solver's ``sample_mesh`` of several data ranks and a sample
count that splits evenly over them, each rank computes only its
contiguous block of rows: it draws the whole base sample from the key
and keeps its rows, the prefix and the kernel are row by row, and the
blocks are gathered at the end, so every rank's samples are the
unsharded pass's bit for bit (``LazySamples.shard_rows`` says how many
rows this rank computed).

The JAX pass also groups runs of one flow signature into one scan,
pads run lengths and the buffer width to powers of two, caches stacked
parameters block by block, and prewarms the next padded sizes.  All of
that bounds compilation or host dispatch of compiled scans; this pass
compiles nothing and launches one kernel a clique, so it has none of it.
A run-level launch (a CUDA graph of the pass, or one kernel walking a
run) is the next lever, to be measured first.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..flows.model import (CliqueFlowModel, _select_inverse_fn,
                           conditional_draw_core)
from ..graph.bayes_tree import CliqueNode
from ..utils.keys import torch_generator


def topological_cliques(root: CliqueNode) -> List[CliqueNode]:
    """Cliques parents first: a DFS whose children are ``str``-sorted, so
    the order (and the key each clique takes) is hash-seed free."""
    order, stack = [], [root]
    while stack:
        clique = stack.pop()
        order.append(clique)
        stack.extend(sorted(clique.children, key=str))
    return order


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory, so the
    copy does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclass
class FusedPlan:
    """What the pass reads, packed once: each clique's model, first buffer
    column and frontal width, in topological order; per clique (rows of
    the (L, max dim) arrays on the device) its gather map into the buffer
    (``D``, the zero column, where a prefix column is neither an
    observation nor a separator), observation mask and values, inversion
    mask, and ``lead``, its prefix width."""
    models: List[CliqueFlowModel]
    first: List[int]
    frontal_dim: List[int]
    lead: List[int]
    src: torch.Tensor
    omask: torch.Tensor
    ovals: torch.Tensor
    imask: torch.Tensor
    D: int


def pack_plan(specs, D: int, device) -> FusedPlan:
    """A ``FusedPlan`` from per-clique specs (model, observations (c,),
    separator columns (buffer column of each separator dim, in order),
    first frontal column, frontal width), parents first, over ``D``
    buffer columns."""
    L, width = len(specs), max(s[0].dim for s in specs)
    src = np.full((L, width), D, dtype=np.int64)
    omask = np.zeros((L, width), dtype=bool)
    ovals = np.zeros((L, width), dtype=np.float32)
    imask = np.ones((L, width), dtype=bool)
    lead = []
    for i, (_, obs, sep_cols, _, _) in enumerate(specs):
        c = len(obs)
        omask[i, :c] = True
        ovals[i, :c] = obs
        src[i, c:c + len(sep_cols)] = sep_cols
        c += len(sep_cols)
        imask[i, :c] = False
        lead.append(c)
    src, omask, ovals, imask = (_to_device(a, device)
                                for a in (src, omask, ovals, imask))
    return FusedPlan([s[0] for s in specs], [s[3] for s in specs],
                     [s[4] for s in specs], lead, src, omask, ovals, imask,
                     D)


@torch.no_grad()
def run_plan(plan: FusedPlan, next_key, num_samples: int, device,
             rows: slice = slice(None)) -> torch.Tensor:
    """The pass itself: for each clique in order, the next key
    (``next_key()``), the base draws, the prefix gathered from the buffer,
    ``conditional_draw_core`` and the frontal columns written back.
    Returns this rank's ``rows`` of the (n, D + 1) buffer."""
    inverse_fn = _select_inverse_fn(device)
    n_local = len(range(num_samples)[rows])
    buffer = torch.zeros((n_local, plan.D + 1), dtype=torch.float32,
                         device=device)
    for i, model in enumerate(plan.models):
        d, first, lead = model.dim, plan.first[i], plan.lead[i]
        gen = torch_generator(next_key(), device)
        z = model.base.sample(gen, num_samples, device)[rows]
        prefix = torch.where(plan.omask[i, :d], plan.ovals[i, :d],
                             buffer.index_select(1, plan.src[i, :d]))
        x = conditional_draw_core(model.flow_params, model.mean, model.std,
                                  model.circ_mask, z, prefix,
                                  plan.imask[i, :d], model.cfg, inverse_fn)
        buffer[:, first:first + plan.frontal_dim[i]] = \
            x[:, lead:lead + plan.frontal_dim[i]]
    return buffer


@torch.no_grad()
def fused_sample_posterior(solver, num_samples: int
                           ) -> Optional["LazySamples"]:
    """Run the fused pass over ``solver``'s physical tree.  Returns the
    samples, or None if some clique's model is not a ``CliqueFlowModel``
    (the caller then walks clique by clique)."""
    specs = []
    col_of: Dict = {}        # variable -> first buffer column
    D = 0
    for clique in topological_cliques(solver._physical_bayes_tree.root):
        model = getattr(solver._clique_density_model.get(clique), "model",
                        None)
        if not isinstance(model, CliqueFlowModel):
            return None
        frontal_list = sorted(
            clique.frontal, key=lambda v: solver._reverse_ordering_map[v])
        separator_list = sorted(
            clique.separator, key=lambda v: solver._reverse_ordering_map[v])
        first = D
        for v in frontal_list:
            col_of[v] = D
            D += v.dim
        obs = np.asarray(solver._clique_true_obs[clique],
                         dtype=np.float32).reshape(-1)
        # parents come first, so every separator already has its columns
        sep_cols = [c for v in separator_list
                    for c in range(col_of[v], col_of[v] + v.dim)]
        specs.append((model, obs, sep_cols, first, D - first))

    device = solver.device
    plan = pack_plan(specs, D, device)
    mesh = getattr(solver._args, "sample_mesh", None)
    rows = slice(None)
    if mesh is not None and mesh.shape["data"] > 1 and \
            num_samples % mesh.shape["data"] == 0:
        rows = mesh.rows(num_samples)
    buffer = run_plan(plan, solver._next_key, num_samples, device, rows)
    n_local = buffer.shape[0]
    if n_local != num_samples:
        from ..parallel.mesh import all_gather_rows
        buffer = all_gather_rows(buffer, mesh.group("data"))
    return LazySamples(buffer, col_of, shard_rows=n_local)


class LazySamples(Mapping):
    """Posterior samples as column views of the pass's buffer: variable ->
    (n, dim) tensor on the solver's device.  A view is cut when a consumer
    asks for it; ``materialize`` copies the buffer to the host once.
    ``shard_rows`` is the rows this rank computed (all of them unless the
    pass was sharded over a mesh's data axis)."""

    def __init__(self, buffer: torch.Tensor, col_of: Dict,
                 shard_rows: Optional[int] = None) -> None:
        self._buffer = buffer
        self._col_of = col_of
        self._cache: Dict = {}
        self.shard_rows = buffer.shape[0] if shard_rows is None \
            else shard_rows

    def __getitem__(self, v) -> torch.Tensor:
        out = self._cache.get(v)
        if out is None:
            col = self._col_of[v]
            out = self._buffer[:, col:col + v.dim]
            self._cache[v] = out
        return out

    def __iter__(self):
        return iter(self._col_of)

    def __len__(self) -> int:
        return len(self._col_of)

    def materialize(self) -> Dict:
        """Every variable as a host numpy array, from one device copy."""
        buf = self._buffer.cpu().numpy()
        return {v: buf[:, col:col + v.dim]
                for v, col in self._col_of.items()}
