"""Small host-side helpers: angle wrapping, JSON of numpy values, sample
dict <-> array, subsampling, outlier rejection and an SPD check.

A numpy copy of ``nfisam_tpu/utils/functions.py`` (the port keeps its own
rather than importing the JAX package).
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

_TWO_PI = 2.0 * np.pi
_DEG_TO_RAD_FACTOR = np.pi / 180.0
_RAD_TO_DEG_FACTOR = 180.0 / np.pi


def theta_to_pipi(theta):
    """Wrap to [-pi, pi)."""
    return (theta + np.pi) % _TWO_PI - np.pi


def sort_pair_lists(number_list, attached_list):
    """Sort two lists by the first."""
    pairs = sorted(zip(number_list, attached_list), key=lambda p: p[0])
    return [p[0] for p in pairs], [p[1] for p in pairs]


def none_to_zero(x):
    return 0.0 if x is None else x


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder that spills ndarrays to lists and numpy scalars to
    Python numbers."""

    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        return json.JSONEncoder.default(self, obj)


def sample_dict_to_array(samples: Dict, ordering: List = None) -> np.ndarray:
    if ordering is None:
        ordering = list(samples.keys())
    elif set(ordering) != set(samples.keys()):
        raise ValueError("ordering does not match sample keys")
    return np.hstack([np.asarray(samples[v]) for v in ordering])


def array_order_to_dict(samples: np.ndarray, order: List) -> Dict:
    out, cur = {}, 0
    for var in order:
        out[var] = samples[:, cur:cur + var.dim]
        cur += var.dim
    return out


def sample_from_arr(arr: np.ndarray, size: int = 1,
                    rng: np.random.Generator = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return arr[rng.choice(len(arr), size=size, replace=False)]


def reject_outliers(data, iq_range: float = 0.5) -> np.ndarray:
    """Indices of data within a widened interquartile band."""
    data = np.asarray(data, dtype=float)
    ok = ~np.isnan(data)
    pcnt = (1 - iq_range) / 2
    qlow, qhigh = np.quantile(data[ok], [pcnt, 1 - pcnt])
    iqr = qhigh - qlow
    mask = (data >= qlow - 1.7 * iqr) & (data <= qhigh + 1.7 * iqr)
    return np.where(mask)[0]


def is_spd(mat: np.ndarray, tol: float = 1e-8) -> bool:
    """Symmetric positive definite check."""
    mat = np.asarray(mat)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        return False
    if not np.allclose(mat, mat.T, atol=tol):
        return False
    try:
        np.linalg.cholesky(mat)
        return True
    except np.linalg.LinAlgError:
        return False
