"""Posterior quality metrics: the Gaussian-kernel MMD of the reference
and its variants, point-estimate errors, the alignments the scale
runners judge a posterior in, and the closed forms of a linear-Gaussian
displacement graph that exact-posterior tests check against.

Counterpart of ``nfisam_tpu/eval/metrics.py``, as host numpy in float64:
pairwise squared distances are taken as direct differences, so
coordinates of O(100 m) lose nothing to cancellation.  The kernel Stein
discrepancy takes its pairwise products as tensors on the samples'
device, in float32 at full precision (as the JAX package's
``Precision.HIGHEST``; no TF32) or in a dtype the caller names.
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


def _kernel_sums(X, Y, two_s2: float):
    """Sums of the RBF kernel exp(-|a - b|^2 / two_s2) over XX, YY, XY."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    return (np.sum(np.exp(-_sq_dists(X, X) / two_s2)),
            np.sum(np.exp(-_sq_dists(Y, Y) / two_s2)),
            np.sum(np.exp(-_sq_dists(X, Y) / two_s2)), X.shape[0],
            Y.shape[0])


def mmd_unbiased_sq(X, Y, sigma: float = 1.0) -> float:
    """Unbiased squared MMD with an RBF kernel of width ``sigma``
    (reference ``MMDu2``)."""
    kxx, kyy, kxy, m, n = _kernel_sums(X, Y, 2.0 * sigma ** 2)
    return float((kxx - m) / (m * (m - 1)) - 2.0 * kxy / (m * n)
                 + (kyy - n) / (n * (n - 1)))


def mmd_biased(X, Y, sigma: float = 1.0) -> float:
    """Biased MMD estimate (reference ``MMDb``)."""
    kxx, kyy, kxy, m, n = _kernel_sums(X, Y, 2.0 * sigma ** 2)
    return float(np.sqrt(max(kxx / m ** 2 - 2.0 * kxy / (m * n)
                             + kyy / n ** 2, 0.0)))


def mmd_sq_signed(samples1, samples2, k_sigma2: float = 1.0) -> float:
    """The squared MMD of ``mmd``, unclamped: it can be negative, which
    the clamp in ``mmd`` hides."""
    kxx, kyy, kxy, m, n = _kernel_sums(samples1, samples2, 2.0 * k_sigma2)
    return float((kxx - m) / (m * (m - 1)) + (kyy - n) / (n * (n - 1))
                 - 2.0 * kxy / (m * n))


def mmd(samples1, samples2, k_sigma2: float = 1.0) -> float:
    """Normalized Gaussian-kernel MMD: the kernel is a Gaussian density
    with covariance ``k_sigma2 I`` normalized by its value at 0, and the
    within-set sums leave out the diagonal."""
    return float(np.sqrt(max(mmd_sq_signed(samples1, samples2, k_sigma2),
                             0.0)))


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


def gaussian_displacement_graph_moments(
        variables: List[Variable],
        displacements: Dict[Tuple[Variable, Variable],
                            Tuple[np.ndarray, np.ndarray]],
        priors: Dict[Variable, Tuple[np.ndarray, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form mean and covariance of a linear-Gaussian displacement
    graph (x_b = x_a + mean + noise on each edge, Gaussian priors), over
    ``variables`` stacked in order."""
    idx = {}
    start = 0
    for v in variables:
        idx[v] = (start, start + v.dim)
        start += v.dim
    Lam = np.zeros((start, start))
    h = np.zeros(start)
    for v, (mean, cov) in priors.items():
        i0, i1 = idx[v]
        Li = np.linalg.inv(cov)
        Lam[i0:i1, i0:i1] += Li
        h[i0:i1] += Li @ mean
    for (va, vb), (mean, cov) in displacements.items():
        i0, i1 = idx[va]
        j0, j1 = idx[vb]
        Li = np.linalg.inv(cov)
        hl = Li @ mean
        Lam[i0:i1, i0:i1] += Li
        Lam[j0:j1, j0:j1] += Li
        Lam[i0:i1, j0:j1] -= Li
        Lam[j0:j1, i0:i1] -= Li
        h[i0:i1] -= hl
        h[j0:j1] += hl
    Sigma = np.linalg.inv(Lam)
    return Sigma @ h, Sigma


def gaussian_displacement_graph_evidence(joint) -> float:
    """The exact log evidence of a linear-Gaussian displacement graph,
    log E_{tree prior}[prod of its likelihood factors].

    ``joint`` is a ``samplers.joint.StructuredJointFactor`` whose tree
    priors are Gaussian unary factors (``mu``, ``covariance``) and whose
    tree binaries and likelihood factors are displacement factors
    (x_b = x_a + obs + eps).  The tree prior of the stacked variables is
    Gaussian N(mu0, S0) by moment propagation, each likelihood factor
    reads obs_i = H_i x + eps_i with H_i = [-I  +I], and the evidence is
    the Gaussian marginal likelihood N(obs; H mu0, H S0 H^T + R)."""
    idx = {}
    start = 0
    for v in joint.vars:
        idx[v] = (start, start + v.dim)
        start += v.dim
    D = start
    mu = np.zeros(D)
    S = np.zeros((D, D))
    for f in joint.tree_priors:
        i0, i1 = idx[f.vars[0]]
        mu[i0:i1] = np.asarray(f.mu, dtype=np.float64)
        S[i0:i1, i0:i1] = np.asarray(f.covariance, dtype=np.float64)
    for f, var1_sampled in joint.tree_binaries:
        va, vb = f.vars
        src, dst, sign = (va, vb, 1.0) if var1_sampled else (vb, va, -1.0)
        s0, s1 = idx[src]
        d0, d1 = idx[dst]
        mu[d0:d1] = mu[s0:s1] + sign * np.asarray(f.obs, dtype=np.float64)
        # x_dst = x_src +- obs + eps: copy the covariance rows, add the
        # noise on the diagonal block
        S[d0:d1, :] = S[s0:s1, :]
        S[:, d0:d1] = S[:, s0:s1]
        S[d0:d1, d0:d1] = S[s0:s1, s0:s1] + \
            np.asarray(f.covariance, dtype=np.float64)
    rows, obs, Rs = [], [], []
    for f in joint.likelihood_factors:
        va, vb = f.vars
        a0, a1 = idx[va]
        b0, b1 = idx[vb]
        H = np.zeros((va.dim, D))
        H[:, a0:a1] = -np.eye(va.dim)
        H[:, b0:b1] = np.eye(va.dim)
        rows.append(H)
        obs.append(np.asarray(f.obs, dtype=np.float64))
        Rs.append(np.asarray(f.covariance, dtype=np.float64))
    H = np.vstack(rows)
    b = np.concatenate(obs)
    R = np.zeros((len(b), len(b)))
    o = 0
    for Ri in Rs:
        k = Ri.shape[0]
        R[o:o + k, o:o + k] = Ri
        o += k
    C = H @ S @ H.T + R
    resid = b - H @ mu
    sign, logdet = np.linalg.slogdet(2.0 * np.pi * C)
    if sign <= 0:
        raise ValueError("the observation covariance is not positive "
                         "definite")
    return float(-0.5 * (logdet + resid @ np.linalg.solve(C, resid)))


def gaussian_kernel_stein_discrepancy(joint_factor, kernel_precision,
                                      samples, nboot: int = 10,
                                      seed: int = 0, dtype=None):
    """Gaussian-kernel KSD of ``samples`` (n, d) under ``joint_factor``'s
    density, with a multinomial bootstrap: (U-statistic, bootstrap
    p-value, the (n, n) off-diagonal Stein kernel matrix as numpy,
    V-statistic).  The score is the joint's float32 gradient on the
    samples' device; the pairwise products are taken in ``dtype``
    (default float32) there; the bootstrap is host numpy."""
    X = torch.as_tensor(samples)
    dtype = dtype or torch.float32
    score = joint_factor.grad_x_log_pdf(X.to(torch.float32)).to(dtype)
    X = X.to(dtype)
    P = torch.as_tensor(np.asarray(kernel_precision), dtype=dtype,
                        device=X.device)
    n = X.shape[0]
    diff = X[:, None, :] - X[None, :, :]                      # (n, n, d)
    maha = torch.einsum("ijd,de,ije->ij", diff, P, diff)
    KXX = torch.exp(-maha / 2)
    grad_i = -torch.einsum("de,ije->ijd", P, diff)          # dk wrt x_i
    p1 = score @ score.T
    p2 = torch.einsum("id,ijd->ij", score, -grad_i)
    p3 = torch.einsum("jd,ijd->ij", score, grad_i)
    # trace(grad_i grad_j^T + P) with grad_j = -grad_i
    p4 = torch.trace(P) - torch.einsum("ijd,ijd->ij", grad_i, grad_i)
    raw = (p1 + p2 + p3 + p4) * KXX
    off = raw - torch.diag(torch.diag(raw))
    ustats = float(torch.sum(off) / (n * (n - 1)))
    vstats = float(torch.sum(raw) / n ** 2)
    rng = np.random.default_rng(seed)
    boot = np.zeros(nboot)
    off_np = off.cpu().numpy()
    for i in range(nboot):
        w = (rng.multinomial(n, np.ones(n) / n) / n).reshape(-1, 1)
        boot[i] = ((w.T - 1 / n) @ off_np @ (w - 1 / n)).item()
    p_u = float((boot >= ustats).mean())
    return ustats, p_u, off_np, vstats
