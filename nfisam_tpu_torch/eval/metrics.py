"""Posterior quality metric: the Gaussian-kernel MMD of the reference.

Counterpart of ``mmd`` in ``nfisam_tpu/eval/metrics.py``, in float64
numpy: pairwise squared distances are taken as direct differences, so
coordinates of O(100 m) lose nothing to cancellation.
"""
from __future__ import annotations

import numpy as np


def _sq_dists(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    d = X[:, None, :] - Y[None, :, :]
    return np.sum(d * d, axis=-1)


def mmd(samples1, samples2, k_sigma2: float = 1.0) -> float:
    """Normalized Gaussian-kernel MMD: the kernel is a Gaussian density
    with covariance ``k_sigma2 I`` normalized by its value at 0, and the
    within-set sums leave out the diagonal."""
    X = np.asarray(samples1, dtype=np.float64)
    Y = np.asarray(samples2, dtype=np.float64)
    m, n = X.shape[0], Y.shape[0]
    two_s2 = 2.0 * k_sigma2
    E1 = (np.sum(np.exp(-_sq_dists(X, X) / two_s2)) - m) / (m * (m - 1))
    E2 = (np.sum(np.exp(-_sq_dists(Y, Y) / two_s2)) - n) / (n * (n - 1))
    E3 = np.sum(np.exp(-_sq_dists(X, Y) / two_s2)) / (m * n)
    return float(np.sqrt(max(E1 + E2 - 2.0 * E3, 0.0)))
