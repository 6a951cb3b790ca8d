"""Clique-parallel training scheduler.

Counterpart of ``nfisam_tpu/parallel/scheduler.py``.  Leaves-to-root
order only makes a parent wait on its children, so:

1. the cliques without a model are partitioned into **wavefronts**: a
   clique joins a wave once every child is modeled;
2. every clique of a wave is simulated first, then the wave's cliques
   are bucketed by training signature (padded dim, sample count, and the
   circular pattern under ``NSF_AR_CS``), and each bucket trains in one
   lockstep loop (``fit_flows_batched``), in chunks of at most ``CHUNK``
   cliques; a lone clique trains with ``fit_flow_raw``;
3. with a (clique, data) mesh (``NFiSAMArgs.data_parallel_mesh``, see
   ``parallel/mesh.py``) the fits shard over its ranks: a bucket's
   cliques over the clique axis, the samples over the data axis;
4. inside a process group of several ranks and no mesh
   (``parallel/multihost.py``), a bucket is not cut into ``CHUNK``s: it
   trains as one, split across the ranks by ``train_chunked``, and
   ``host_trained_cliques`` records the cliques this rank trained.

A clique whose signature is in the checkpoint store loads instead of
simulating and training.  The solver's key stream is consumed in the JAX
package's order: one simulation key per clique of the wave that did not
load, then one pad key per clique in bucketing order, then the fit keys
chunk by chunk (one a clique, in bucket order).  So the port trains the
same cliques, in the same buckets, as the JAX package.

``ParallelNFiSAM`` is a drop-in replacement for ``NFiSAM``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.variables import circular_dim_list
from ..flows.model import CliqueFlowModel
from ..graph.bayes_tree import CliqueNode
from ..solver.checkpoint import content_tag
from ..solver.nfisam import FlowModelAdapter, NFiSAM, NFiSAMArgs
from ..train.trainer import fit_flow_raw, fit_flows_batched
from ..utils.tracing import tracer
from .multihost import host_parallel_enabled, train_chunked

# the largest bucket trained in one loop; bigger buckets train in chunks
CHUNK = 8


def wavefronts(clique_ordering: List[CliqueNode],
               already_modeled) -> List[List[CliqueNode]]:
    """Partition cliques into leaves-first waves; a clique is ready once
    every child is modeled or scheduled in an earlier wave."""
    done = set(c for c in clique_ordering if c in already_modeled)
    remaining = [c for c in clique_ordering if c not in done]
    waves: List[List[CliqueNode]] = []
    while remaining:
        wave = [c for c in remaining
                if all(ch in done for ch in c.children)]
        if not wave:
            raise RuntimeError("Cyclic clique dependency (corrupt tree)")
        waves.append(wave)
        done.update(wave)
        remaining = [c for c in remaining if c not in done]
    return waves


class ParallelNFiSAM(NFiSAM):
    """NF-iSAM with wavefront-parallel clique training.

    ``bucket_log`` holds (padded dim, sample count, bucket size) for every
    bucket trained; ``host_trained_cliques`` the sorted names of the
    cliques THIS rank trained under bucket chunking across ranks (empty
    in a single-rank run)."""

    def __init__(self, args: NFiSAMArgs = None, device=None):
        super().__init__(args=args, device=device)
        self.host_trained_cliques: List[str] = []
        self.bucket_log: List[Tuple[int, int, int]] = []

    def fit_tree_density_models(self, timer: Optional[List[float]] = None,
                                clique_dim_timer: Optional[List] = None
                                ) -> None:
        """Wave by wave: load or simulate every clique, then train the
        simulated ones by bucket.  ``timer`` gets each clique's simulation
        seconds and each chunk's seconds since its bucket began;
        ``clique_dim_timer`` a [dim, seconds since the fit began] pair as
        each trained clique is done."""
        with tracer.span("fit"):
            self._temp_training_loss = {}
            self._evict_stale_value_matches()
            ordering = self._working_bayes_tree.clique_ordering()
            t_begin = self._clock() if clique_dim_timer is not None else 0.0
            for wave in wavefronts(ordering, self._clique_density_model):
                with tracer.span("fit.wave", cliques=len(wave)):
                    self._fit_wave(wave, timer, clique_dim_timer, t_begin)

    def _fit_wave(self, wave: List[CliqueNode], timer, clique_dim_timer,
                  t_begin: float) -> None:
        """One wave of ``fit_tree_density_models``."""
        # ---- load or simulate every clique of the wave ------------------
        sims = []
        for clique in wave:
            restored = self.try_load_clique_model(clique)
            if restored is not None:
                model, self._clique_true_obs[clique] = restored
                self._clique_density_model[clique] = model
                with tracer.span("fit.finish"):
                    self._finish_clique(clique, model)
                continue
            samples, var_ordering, true_obs = self.clique_training_sampler(
                clique, num_samples=self._args.local_sample_num, timer=timer)
            self._clique_true_obs[clique] = true_obs
            sims.append((clique, samples, var_ordering))

        # ---- bucket by padded dim and sample count ----------------------
        buckets: Dict[Tuple, List] = {}
        for clique, samples, var_ordering in sims:
            circ = circular_dim_list(var_ordering)
            samples, pad = self._pad_samples(samples.to(torch.float32))
            key = (samples.shape[-1], samples.shape[0])
            if self._args.flow_type == "NSF_AR_CS":
                # the circular-spline routing is part of the flow's
                # config, so such buckets share the circular pattern
                key = key + (tuple(circ) + (False,) * pad,)
            buckets.setdefault(key, []).append(
                (clique, samples, var_ordering, circ, pad))

        for (aug_dim, n, *_), items in buckets.items():
            self.bucket_log.append((aug_dim, n, len(items)))
            t0 = self._clock() if timer is not None else 0.0
            with tracer.span("fit.bucket", dim=aug_dim, n=n, size=len(items),
                             lone=len(items) == 1):
                cfg = self._flow_config(
                    aug_dim, list(items[0][3]) + [False] * items[0][4])
                # chunking across ranks splits the whole bucket itself
                size = len(items) if host_parallel_enabled(self._args) \
                    else CHUNK
                for i in range(0, len(items), size):
                    self._fit_bucket_chunk(items[i:i + size], cfg, aug_dim,
                                           n)
                    if timer is not None:
                        timer.append(self._clock() - t0)
                    if clique_dim_timer is not None:
                        done = self._clock() - t_begin
                        clique_dim_timer.extend(
                            [item[0].dim, done] for item in items[i:i + size])

    def _fit_bucket_chunk(self, items, cfg, aug_dim: int, n: int) -> None:
        tc = self._args.train_config()
        scale_circ = self._args.flow_type == "NSF_AR"
        mesh = self._args.data_parallel_mesh
        if len(items) == 1:
            clique, samples, var_ordering, circ, pad = items[0]
            key = self._next_key()
            params, iter_loss, n_iters, mean, std = fit_flow_raw(
                key, samples, cfg, tc, circ + [False] * pad,
                scale_circular=scale_circ, mesh=mesh)
            fitted = [(clique, circ, pad, params, iter_loss, n_iters, mean,
                       std, key)]
        else:
            keys = np.stack([self._next_key() for _ in items])
            samples_stack = torch.stack([s for _, s, _, _, _ in items])
            masks = np.stack([np.asarray(c + [False] * pd, dtype=bool)
                              for _, _, _, c, pd in items])
            if host_parallel_enabled(self._args):
                (p_s, il_s, t_s, m_s, s_s), trained_idx = train_chunked(
                    keys, samples_stack, cfg, tc, masks,
                    scale_circular=scale_circ, mesh=mesh)
                # sorted names: ``clique.vars`` is a set
                self.host_trained_cliques.extend(
                    "".join(sorted(str(v.name) for v in items[i][0].vars))
                    for i in trained_idx)
            else:
                p_s, il_s, t_s, m_s, s_s = fit_flows_batched(
                    keys, samples_stack, cfg, tc, masks,
                    scale_circular=scale_circ, mesh=mesh)
            fitted = [(clique, circ, pad,
                       [{k: v[b] for k, v in p.items()} for p in p_s],
                       il_s[b], t_s[b], m_s[b], s_s[b], keys[b])
                      for b, (clique, _, _, circ, pad) in enumerate(items)]

        for clique, circ, pad, params, iter_loss, n_iters, mean, std, key \
                in fitted:
            self._record_training_loss(clique, iter_loss, n_iters)
            with tracer.span("fit.finish"):
                aug_sep_dim = aug_dim - pad - clique.frontal_dim
                model = CliqueFlowModel(
                    cfg, params, mean, std, circ, aug_sep_dim, pad_dims=pad,
                    content_tag=content_tag(key, cfg, (n, aug_dim)))
                adapter = FlowModelAdapter(model, self._next_key,
                                           mesh=self._args.sample_mesh)
                self._save_clique_model(clique, model)
                self._clique_density_model[clique] = adapter
                self._finish_clique(clique, adapter)
