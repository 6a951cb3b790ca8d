"""Clique-parallel training scheduler.

Counterpart of ``nfisam_tpu/parallel/scheduler.py``.  Leaves-to-root
order only makes a parent wait on its children, so:

1. the cliques without a model are partitioned into **wavefronts**: a
   clique joins a wave once every child is modeled;
2. every clique of a wave is simulated first, then the wave's cliques
   are bucketed by training signature (padded dim, sample count, and the
   circular pattern under ``NSF_AR_CS``), and each bucket trains in one
   lockstep loop (``fit_flows_batched``), in chunks of at most ``CHUNK``
   cliques; a lone clique trains with ``fit_flow_raw``.

The solver's key stream is consumed in the JAX package's order: one
simulation key per clique of the wave, then one pad key per clique in
bucketing order, then the fit keys chunk by chunk.  So the port trains
the same cliques, in the same buckets, as the JAX package.  Checkpoints
and multi-host chunking are not ported: there is no restore branch and
``host_trained_cliques`` stays empty.

``ParallelNFiSAM`` is a drop-in replacement for ``NFiSAM``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.variables import circular_dim_list
from ..flows.model import CliqueFlowModel
from ..graph.bayes_tree import CliqueNode
from ..solver.nfisam import FlowModelAdapter, NFiSAM, NFiSAMArgs
from ..train.trainer import fit_flow_raw, fit_flows_batched

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
    bucket trained; ``host_trained_cliques`` is the JAX package's
    multi-host record and stays empty here."""

    def __init__(self, args: NFiSAMArgs = None, device=None):
        super().__init__(args=args, device=device)
        self.host_trained_cliques: List[str] = []
        self.bucket_log: List[Tuple[int, int, int]] = []

    def fit_tree_density_models(self) -> None:
        self._temp_training_loss = {}
        self._evict_stale_value_matches()
        ordering = self._working_bayes_tree.clique_ordering()
        for wave in wavefronts(ordering, self._clique_density_model):
            # ---- simulate every clique of the wave ----------------------
            sims = []
            for clique in wave:
                samples, var_ordering, true_obs = \
                    self.clique_training_sampler(
                        clique, num_samples=self._args.local_sample_num)
                self._clique_true_obs[clique] = true_obs
                sims.append((clique, samples, var_ordering))

            # ---- bucket by padded dim and sample count ------------------
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
                cfg = self._flow_config(
                    aug_dim, list(items[0][3]) + [False] * items[0][4])
                for i in range(0, len(items), CHUNK):
                    self._fit_bucket_chunk(items[i:i + CHUNK], cfg, aug_dim)

    def _fit_bucket_chunk(self, items, cfg, aug_dim: int) -> None:
        tc = self._args.train_config()
        scale_circ = self._args.flow_type == "NSF_AR"
        if len(items) == 1:
            clique, samples, var_ordering, circ, pad = items[0]
            params, iter_loss, n_iters, mean, std = fit_flow_raw(
                self._next_key(), samples, cfg, tc, circ + [False] * pad,
                scale_circular=scale_circ)
            fitted = [(clique, circ, pad, params, iter_loss, n_iters, mean,
                       std)]
        else:
            keys = np.stack([self._next_key() for _ in items])
            samples_stack = torch.stack([s for _, s, _, _, _ in items])
            masks = np.stack([np.asarray(c + [False] * pd, dtype=bool)
                              for _, _, _, c, pd in items])
            p_s, il_s, t_s, m_s, s_s = fit_flows_batched(
                keys, samples_stack, cfg, tc, masks,
                scale_circular=scale_circ)
            fitted = [(clique, circ, pad,
                       [{k: v[b] for k, v in p.items()} for p in p_s],
                       il_s[b], t_s[b], m_s[b], s_s[b])
                      for b, (clique, _, _, circ, pad) in enumerate(items)]

        for clique, circ, pad, params, iter_loss, n_iters, mean, std in \
                fitted:
            aug_sep_dim = aug_dim - pad - clique.frontal_dim
            model = CliqueFlowModel(cfg, params, mean, std, circ,
                                    aug_sep_dim, pad_dims=pad)
            adapter = FlowModelAdapter(model, self._next_key)
            clique_name = "".join(sorted(str(v.name) for v in clique.vars))
            self._temp_training_loss[clique_name] = (iter_loss, n_iters)
            self._clique_density_model[clique] = adapter
            self._finish_clique(clique, adapter)
