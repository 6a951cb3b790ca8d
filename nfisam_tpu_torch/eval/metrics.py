"""Posterior quality metrics: the Gaussian-kernel MMD of the reference,
point-estimate errors, and the alignments the scale runners judge a
posterior in.

Counterpart of ``mmd``, ``rmse``, ``sample_mean``, ``geodesic_distance``,
``translation_distance``, ``kabsch_umeyama``, ``rigid_gauge_transform``,
``anchor_samples``, ``sample_dict_to_array`` and ``array_order_to_dict``
in ``nfisam_tpu/eval/metrics.py``, as host numpy in float64: pairwise
squared distances are taken as direct differences, so coordinates of
O(100 m) lose nothing to cancellation.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import geometry as geom
from ..core.variables import R2Variable, SE2Variable, Variable


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


def rmse(samples1, samples2) -> float:
    s1, s2 = np.asarray(samples1), np.asarray(samples2)
    if s1.shape != s2.shape:
        raise ValueError("shape mismatch")
    return float(np.sqrt(np.sum((s1 - s2) ** 2) / s1.size))


def sample_mean(samples: np.ndarray, var_ordering: List[Variable]
                ) -> Tuple[np.ndarray, Dict[Variable, np.ndarray]]:
    """Per-dim means, circular dims by their mean angle (reference
    ``sample_mean:151``)."""
    circ: List[bool] = []
    for v in var_ordering:
        circ += v.circular_dim_list
    circ_arr = np.asarray(circ)
    samples = np.asarray(samples)
    means = samples.mean(axis=0)
    if circ_arr.any():
        th = samples[:, circ_arr]
        means[circ_arr] = np.arctan2(np.sin(th).mean(0), np.cos(th).mean(0))
    var2mean = {}
    cur = 0
    for v in var_ordering:
        var2mean[v] = means[cur:cur + v.dim]
        cur += v.dim
    return means, var2mean


def geodesic_distance(var2point1: Dict[Variable, np.ndarray],
                      var2point2: Dict[Variable, np.ndarray]) -> float:
    """Root of the summed squared SE(2) log-map distances and R^2
    distances between two point estimates."""
    err = 0.0
    for var, pt1 in var2point1.items():
        pt2 = var2point2[var]
        if isinstance(var, SE2Variable):
            a = torch.as_tensor(np.asarray(pt2, np.float64).reshape(3))
            b = torch.as_tensor(np.asarray(pt1, np.float64).reshape(3))
            rel = geom.se2_log(geom.se2_between(a, b))
            err += float(torch.sum(rel ** 2))
        elif isinstance(var, R2Variable):
            err += float(np.sum((np.asarray(pt1) - np.asarray(pt2)) ** 2))
        else:
            raise ValueError("Unknown variable type")
    return float(np.sqrt(err))


def translation_distance(var2point1: Dict[Variable, np.ndarray],
                         var2point2: Dict[Variable, np.ndarray]) -> float:
    """RMS over variables of the translation distance."""
    err = 0.0
    for var, pt1 in var2point1.items():
        pt2 = var2point2[var]
        err += float(np.sum((np.asarray(pt1)[:2] - np.asarray(pt2)[:2]) ** 2))
    return float(np.sqrt(err / len(var2point1)))


def kabsch_umeyama(A: np.ndarray, B: np.ndarray):
    """Similarity alignment ``R, c, t`` with ``c R b + t ~= a`` (reference
    ``Functions.kabsch_umeyama:53``)."""
    if A.shape != B.shape:
        raise ValueError("shape mismatch")
    n, m = A.shape
    EA, EB = A.mean(0), B.mean(0)
    VarA = np.mean(np.linalg.norm(A - EA, axis=1) ** 2)
    H = ((A - EA).T @ (B - EB)) / n
    U, D, VT = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U) * np.linalg.det(VT))
    S = np.diag([1] * (m - 1) + [d])
    R = U @ S @ VT
    c = VarA / np.trace(np.diag(D) @ S)
    t = EA - c * R @ EB
    return R, c, t


def rigid_gauge_transform(ref_pts: np.ndarray, est_pts: np.ndarray):
    """Rigid alignment ``R, t`` (rotation and translation, no scale) with
    ``R @ est + t ~= ref``: the 2D gauge of range-only SLAM, whose global
    rotation about the anchor is weakly observed.  Scale is not a gauge
    freedom of SE(2) SLAM, hence no Umeyama scale."""
    if ref_pts.shape != est_pts.shape or ref_pts.shape[1] != 2:
        raise ValueError("two (n, 2) point sets of one shape expected")
    mu_r, mu_e = ref_pts.mean(0), est_pts.mean(0)
    H = (ref_pts - mu_r).T @ (est_pts - mu_e)
    U, _, VT = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ VT))
    R = U @ np.diag([1.0, d]) @ VT
    t = mu_r - R @ mu_e
    return R, t


def anchor_samples(samples, ref_means):
    """Re-express posterior samples in the gauge of a reference point
    estimate (e.g. the incremental MAP): fit ``rigid_gauge_transform`` on
    the posterior means of the variables common to both, then apply it to
    every sample; positions rotate and translate, circular dims (the SE(2)
    heading) shift by the gauge angle and re-wrap.

    ``samples``: {Variable: (n, dim) array}; ``ref_means``: {Variable:
    (dim,) array}.  Every variable needs a planar position in its first
    two columns, which are not circular: any other raises ``ValueError``.
    Returns ({Variable: (n, dim) ndarray}, gauge angle in radians)."""
    for v in samples:
        if v.dim < 2 or any(v.circular_dim_list[:2]):
            raise ValueError(
                f"anchor_samples needs a planar position in the first two "
                f"columns of every variable; {v!r} has dim {v.dim} and "
                f"circular flags {v.circular_dim_list}")
    common = [v for v in samples if v in ref_means]
    if len(common) < 2:
        return ({v: np.asarray(s) for v, s in samples.items()}, 0.0)
    ref = np.stack([np.asarray(ref_means[v])[:2] for v in common])
    est = np.stack([np.asarray(samples[v]).mean(0)[:2] for v in common])
    R, t = rigid_gauge_transform(ref, est)
    ang = float(np.arctan2(R[1, 0], R[0, 0]))
    out = {}
    for v, s in samples.items():
        s = np.array(s, copy=True)
        s[:, :2] = s[:, :2] @ R.T + t
        for d, circ in enumerate(v.circular_dim_list):
            if circ:
                s[:, d] = np.mod(s[:, d] + ang + np.pi, 2 * np.pi) - np.pi
        out[v] = s
    return out, ang


def sample_dict_to_array(samples: Dict[Variable, np.ndarray],
                         ordering: List[Variable] = None) -> np.ndarray:
    if ordering is None:
        ordering = list(samples.keys())
    return np.hstack([np.asarray(samples[v]) for v in ordering])


def array_order_to_dict(samples: np.ndarray,
                        order: List[Variable]) -> Dict:
    out, cur = {}, 0
    for v in order:
        out[v] = samples[:, cur:cur + v.dim]
        cur += v.dim
    return out
