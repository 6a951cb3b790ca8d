"""Clique training samples by nested sampling: the solvers'
``local_sampling_method="nested"`` and ``"dynamic nested"``.

Counterpart of ``nfisam_tpu/solver/nested_adapter.py``, with its fault
(ROADMAP C3): ``dynamic`` is not passed on, so "dynamic nested" runs the
static sampler, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..samplers.nested import GlobalNestedSampler


def nested_clique_samples(key, variable_pattern, factors, num_samples,
                          dynamic: bool = False, device=None) -> np.ndarray:
    """(num_samples, dim) clique samples over ``variable_pattern``: the
    nested sampler's equal-weight draws with ``num_samples`` live points,
    subsampled or resampled to ``num_samples`` rows."""
    sampler = GlobalNestedSampler(nodes=variable_pattern, factors=factors,
                                  device=device)
    samples = sampler.sample(key=key, live_points=num_samples,
                             downsampling=True)
    if samples.shape[0] > num_samples:
        rng = np.random.default_rng(int(np.asarray(key)[1]))
        samples = samples[rng.choice(len(samples), num_samples,
                                     replace=False)]
    elif samples.shape[0] < num_samples:
        rng = np.random.default_rng(int(np.asarray(key)[1]))
        samples = samples[rng.choice(len(samples), num_samples,
                                     replace=True)]
    return samples
