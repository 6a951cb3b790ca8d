"""Factor-type-banked joint density and the incremental, warm-started MAP.

Counterpart of ``nfisam_tpu/solver/banked_joint.py`` (the ISAM2 analog of
the reference's GTSAM harness, ``gtsam_solution.cpp:18``):

* **banks, not factors**: factors are grouped by type into stacked
  parameter banks (SE(2) priors, SE(2) odometry, R^2 priors, R^2
  odometry, and one range-mixture bank for plain ranges and ambiguous
  data association), so
  the joint negative log density of the whole graph is a few gathers and
  reductions whatever the factor count;
* **LM-CG**: each Levenberg-Marquardt step solves ``(H + lam I) dx =
  -g`` by conjugate gradients on Hessian-vector products;
* **warm start**: the previous step's estimate carries over; new poses are
  dead-reckoned through odometry, new landmarks scored on candidate points
  of their measured range rings.

Where the JAX package compiles the LM loop into one program and takes each
Hessian-vector product as ``jvp`` of ``grad`` (matrix-free), the port runs
the loop eagerly on the solver's device (``cuda`` unless the caller names
another), and assembles the Hessian once an LM iteration as a sparse
matrix of the banks' per-row blocks (``SparseHessian``), so that each
product is one sparse product instead of ~1500 eager operations.  CG runs
its ``cg_iters`` iterations with converged iterates frozen by a
device-side mask, so nothing inside it waits for the host, and each LM
iteration reads one flag.  The solves compute in float64 (``MAP_DTYPE``)
where the JAX package computes in float32: a float32 LM-CG path stopped at
its iteration cap depends on rounding, so the card, the CPU and the JAX
package would each report another floor (PERF.md); the estimate is kept
in float32 between solves, as in JAX.  The JAX package pads the state and
the bank rows to powers of two to bound recompiles, and pins the solver
to the CPU; the port does neither.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import geometry as geom
from ..core.variables import Variable
from ..factors.factors import (Factor, R2RelativeGaussianLikelihoodFactor,
                               SE2RelativeGaussianLikelihoodFactor,
                               UnaryR2GaussianPriorFactor,
                               UnarySE2ApproximateGaussianPriorFactor,
                               _RangeFactorBase)
from ..factors.mixtures import BinaryFactorMixture
from ..utils.device import resolve_device

_LOG_TWO_PI = float(np.log(2.0 * np.pi))
# the dtype of the LM-CG solves
MAP_DTYPE = torch.float64
# the JAX package's IncMAPConfig defaults (no caller sets another): LM
# iterations of a cold and of a warm-started solve, CG iterations an LM
# step, the damping's start and its factors on an accepted / a rejected
# step, the relative NLL change that stops a solve (the JAX package's
# float32 resolution floor), and the least candidate points on a range
# ring
MAP_MAX_ITERS = 150
MAP_WARM_MAX_ITERS = 15
MAP_CG_ITERS = 300
MAP_INIT_DAMPING = 1e-3
MAP_DAMPING_DOWN = 0.2
MAP_DAMPING_UP = 10.0
MAP_TOL = 1e-6
LANDMARK_INIT_CANDIDATES = 16


# ---------------------------------------------------------------- density
# Each bank is (idx, params): ``idx`` (n, L) int64 state columns a row
# reads, ``params`` that row's parameters; its row function maps the
# gathered (..., L) columns and the parameters to (...,) negative log
# densities, shape-agnostic in the leading dims so the same function
# gives the joint density and, under vmap, each row's Hessian block.
def _se2_residual_lp(dT, prec_chol, log_norm):
    """Exp-map Gaussian log density of SE(2) residuals ``dT`` (..., 3)."""
    v = geom.se2_log(dT)
    det = torch.abs(geom.se2_det_grad_logmap(dT))
    white = torch.sum(v[..., :, None] * prec_chol, dim=-2)
    return (log_norm - 0.5 * torch.sum(white * white, -1)
            + torch.log(torch.clamp(det, min=1e-12)))


def _se2_prior_nll(X, inv_prior, prec_chol, log_norm):
    return -_se2_residual_lp(geom.se2_compose(inv_prior, X), prec_chol,
                             log_norm)


def _se2_odometry_nll(T, inv_obs, prec_chol, log_norm):
    rel = geom.se2_between(T[..., :3], T[..., 3:])
    return -_se2_residual_lp(geom.se2_compose(inv_obs, rel), prec_chol,
                             log_norm)


def _r2_prior_nll(X, mu, prec_chol, log_norm):
    white = torch.sum((X - mu)[..., :, None] * prec_chol, dim=-2)
    return 0.5 * torch.sum(white * white, -1) - log_norm


def _r2_odometry_nll(Y, obs, prec_chol, log_norm):
    """``Y`` (..., 4): the two ends' positions; the displacement's
    Gaussian negative log density."""
    d = Y[..., 2:] - Y[..., :2] - obs
    white = torch.sum(d[..., :, None] * prec_chol, dim=-2)
    return 0.5 * torch.sum(white * white, -1) - log_norm


def _range_mixture_nll(Y, r, sigma, logw):
    """``Y`` (..., 2 + 2K): the observer's position, then the K candidate
    positions; per component its own range ``r``, ``sigma`` and log
    weight."""
    d = Y[..., 2:].reshape(Y.shape[:-1] + (-1, 2)) - Y[..., None, :2]
    # safe norm: d|v|/dv is NaN at v = 0, and a 0 weight does not stop a
    # NaN from poisoning the gradient and every Hessian-vector product
    # (0 * NaN = NaN); the reference guards its range gradient the same
    # way (Factors.py:2203-2220, max(dist, 1e-8))
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    comp_lp = (logw - 0.5 * (dist - r) ** 2 / sigma ** 2
               - 0.5 * _LOG_TWO_PI - torch.log(sigma))
    return -torch.logsumexp(comp_lp, dim=-1)


_ROW_NLL = {"sp": _se2_prior_nll, "so": _se2_odometry_nll,
            "rp": _r2_prior_nll, "rr": _r2_odometry_nll,
            "rg": _range_mixture_nll}


def _banked_nll(x: torch.Tensor, banks) -> torch.Tensor:
    """Negative log joint density of the state ``x`` (D,): the sum over
    every bank's rows."""
    total = x.new_zeros(())
    for name, (idx, params) in banks.items():
        total = total + torch.sum(_ROW_NLL[name](x[idx], *params))
    return total


def banked_log_density(x: torch.Tensor, banks) -> torch.Tensor:
    """Log joint density of each state row of ``x`` (C, D): minus the sum
    of every bank's rows' negative log densities (the joint's
    ``log_pdf``, a few batched operations a bank)."""
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for name, (idx, params) in banks.items():
        total = total - torch.sum(_ROW_NLL[name](x[:, idx], *params),
                                  dim=-1)
    return total


class SparseHessian:
    """The gradient and Hessian of ``_banked_nll``, each summed in a fixed
    order so that a solve gives the same bits on every run.  The Hessian
    is a CSR matrix: each bank row's dense (L, L) block, ``torch.func.
    hessian`` of its row function under ``vmap``, summed into the (D, D)
    pattern of the banks' index columns; the gradient is each bank row's
    L partials, ``torch.func.grad`` under ``vmap``, summed per state
    column.  The patterns (sorted unique entries, and the order that
    groups each entry's contributions) are built once; every sum is a
    ``segment_reduce`` (no atomics) and waits for nothing on the host.

    ``mv`` is the product with the CSR matrix, each row's products summed
    by ``segment_reduce`` too.  Neither autograd's gradient of the gathers
    (``index_put_`` with accumulation) nor cuSPARSE's default CSR product
    promises one summation order on a card, and either lets a capped
    LM-CG solve end somewhere else on each run."""

    def __init__(self, banks, D: int):
        self.banks = banks
        rows, cols = [], []
        for idx, _ in banks.values():
            L = idx.shape[1]
            rows.append(idx[:, :, None].expand(-1, L, L).reshape(-1))
            cols.append(idx[:, None, :].expand(-1, L, L).reshape(-1))
        keys = torch.cat(rows) * D + torch.cat(cols)
        uniq, inverse, counts = torch.unique(
            keys, sorted=True, return_inverse=True, return_counts=True)
        self.order = torch.argsort(inverse, stable=True)
        self.counts = counts
        r = uniq // D
        self.col = uniq - r * D
        self.row_counts = torch.bincount(r, minlength=D)
        self.crow = torch.cat([r.new_zeros(1),
                               torch.cumsum(self.row_counts, 0)])
        grad_cols = torch.cat([idx.reshape(-1) for idx, _ in banks.values()])
        self.grad_order = torch.argsort(grad_cols, stable=True)
        self.grad_counts = torch.bincount(grad_cols, minlength=D)
        self.D = D

    def _rows(self, transform, x: torch.Tensor) -> torch.Tensor:
        # (functorch can come back in float64 where an SE(2) residual's
        # angle is exactly 0, hence the cast)
        return torch.cat([
            torch.func.vmap(transform(_ROW_NLL[name]))(
                x[idx], *params).reshape(-1).to(x.dtype)
            for name, (idx, params) in self.banks.items()])

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        vals = self._rows(torch.func.grad, x)
        return torch.segment_reduce(vals[self.grad_order], "sum",
                                    lengths=self.grad_counts)

    def at(self, x: torch.Tensor) -> torch.Tensor:
        vals = self._rows(torch.func.hessian, x)
        summed = torch.segment_reduce(vals[self.order], "sum",
                                      lengths=self.counts)
        return torch.sparse_csr_tensor(self.crow, self.col, summed,
                                       (self.D, self.D),
                                       check_invariants=False)

    def mv(self, H: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``H v`` for a matrix ``at`` returned."""
        return torch.segment_reduce(H.values() * v[self.col], "sum",
                                    lengths=self.row_counts)


def conjugate_gradient(matvec, b: torch.Tensor, maxiter: int,
                       tol: float = 1e-8) -> torch.Tensor:
    """``jax.scipy.sparse.linalg.cg(matvec, b, maxiter=maxiter, tol=tol)``
    from x0 = 0 (whose first residual b - A(0) is b), without a host sync:
    the loop always runs ``maxiter`` iterations, and once the residual
    meets ||r||^2 <= tol^2 ||b||^2 a device-side mask freezes every
    iterate, which gives the early-stopped answer."""
    atol2 = (tol ** 2) * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    gamma = torch.dot(r, r)
    for _ in range(maxiter):
        active = gamma > atol2
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        gamma_new = torch.dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def lm_cg_solve(x0: torch.Tensor, banks, max_iters: int):
    """Levenberg-Marquardt on ``_banked_nll`` from ``x0``: each iteration
    solves ``(H + lam I) dx = -g`` by ``conjugate_gradient`` on the
    Hessian-vector product ``H v + lam v``, accepts the step if it lowers
    the NLL (then lam *= MAP_DAMPING_DOWN, else *= MAP_DAMPING_UP, clipped
    to [1e-10, 1e10]), and stops when an accepted step changes the NLL by
    less than ``MAP_TOL (1 + |f|)`` or after ``max_iters`` iterations.
    The gradient and ``H v`` come from ``SparseHessian`` (``H v`` is the
    value of ``torch.func.jvp`` of ``torch.func.grad`` at ``v``, as one
    sparse product instead of ~1500 eager operations), summed in a fixed
    order.  Returns (x, final NLL, iterations)."""
    def nll(x):
        return _banked_nll(x, banks)

    hessian = SparseHessian(banks, x0.shape[0])
    x = x0
    lam = torch.tensor(MAP_INIT_DAMPING, dtype=x0.dtype, device=x0.device)
    f_val = nll(x)
    it = 0
    while it < max_iters:
        H = hessian.at(x)

        def hvp(v, H=H, lam=lam):
            return hessian.mv(H, v) + lam * v

        x_new = x + conjugate_gradient(hvp, -hessian.grad(x), MAP_CG_ITERS)
        f_new = nll(x_new)
        better = f_new < f_val
        done = better & (torch.abs(f_val - f_new) <
                         MAP_TOL * (1.0 + torch.abs(f_val)))
        x = torch.where(better, x_new, x)
        lam = torch.clamp(torch.where(better, lam * MAP_DAMPING_DOWN,
                                      lam * MAP_DAMPING_UP), 1e-10, 1e10)
        f_val = torch.where(better, f_new, f_val)
        it += 1
        if bool(done):                  # the one host read an iteration
            break
    return x, f_val, it


# ------------------------------------------------------------------- banks
def _prec_chol_lognorm(cov):
    """A Gaussian's precision Cholesky factor and log normaliser, from its
    covariance."""
    cov = np.asarray(cov)
    chol = np.linalg.cholesky(np.linalg.inv(cov))
    log_norm = -0.5 * (cov.shape[0] * _LOG_TWO_PI +
                       np.log(np.linalg.det(cov)))
    return chol, log_norm


class FactorBanks:
    """Host-side bank rows of a factor set: ``add`` files a factor under
    its type with the state offsets of its variables; ``to_device`` stacks
    every bank into tensors."""

    def __init__(self) -> None:
        self.se2p: List[tuple] = []     # (idx, inv_prior, prec_chol, ln)
        self.se2o: List[tuple] = []     # (idx1, idx2, inv_obs, prec_chol, ln)
        self.r2p: List[tuple] = []      # (idx, mu, prec_chol, ln)
        self.r2r: List[tuple] = []      # (idx1, idx2, obs, prec_chol, ln)
        # range-mixture rows: (observer offset, [(candidate offset, r,
        # sigma, log weight), ...])
        self.rg: List[tuple] = []
        self.k_max = 1

    def add(self, f: Factor, offset: Dict[Variable, int]) -> None:
        if isinstance(f, UnarySE2ApproximateGaussianPriorFactor):
            self.se2p.append((offset[f.vars[0]], f.inv_prior, f.prec_chol,
                              f.log_norm))
        elif isinstance(f, SE2RelativeGaussianLikelihoodFactor):
            self.se2o.append((offset[f.vars[0]], offset[f.vars[1]],
                              f.inv_obs, f.prec_chol, f.log_norm))
        elif isinstance(f, UnaryR2GaussianPriorFactor):
            self.r2p.append((offset[f.vars[0]],
                             np.asarray(f.mu, np.float64),
                             *_prec_chol_lognorm(f.covariance)))
        elif isinstance(f, R2RelativeGaussianLikelihoodFactor):
            self.r2r.append((offset[f.vars[0]], offset[f.vars[1]],
                             np.asarray(f.obs, np.float64),
                             *_prec_chol_lognorm(f.covariance)))
        elif isinstance(f, BinaryFactorMixture):
            comps = []
            for w, c in zip(f.weights, f.components):
                if not isinstance(c, _RangeFactorBase):
                    raise NotImplementedError(
                        f"non-range mixture component {type(c).__name__}")
                comps.append((offset[c.vars[1]], float(c.obs[0]),
                              float(c.sigma), float(np.log(w))))
            self.rg.append((offset[f.vars[0]], comps))
            self.k_max = max(self.k_max, len(comps))
        elif isinstance(f, _RangeFactorBase):
            self.rg.append((offset[f.vars[0]],
                            [(offset[f.vars[1]], float(f.obs[0]),
                              float(f.sigma), 0.0)]))
        else:
            raise NotImplementedError(
                f"unsupported factor type {type(f).__name__}")

    def to_device(self, device, dtype=torch.float32) -> Dict[str, tuple]:
        """The banks on ``device``, one row a factor: name -> (index
        columns (n, L) int64, parameters in ``dtype``)."""
        banks: Dict[str, tuple] = {}

        def idx(*bases, width):
            return torch.as_tensor(np.concatenate(
                [np.asarray(b, np.int64)[:, None] + np.arange(width)
                 for b in bases], axis=1), device=device)

        def params(*cols):
            # parameters pass through float32, as in the JAX package
            return tuple(torch.as_tensor(np.asarray(c, np.float32),
                                         device=device).to(dtype)
                         for c in cols)

        if self.se2p:
            i, inv, chol, ln = zip(*self.se2p)
            banks["sp"] = (idx(i, width=3), params(inv, chol, ln))
        if self.se2o:
            i1, i2, inv, chol, ln = zip(*self.se2o)
            banks["so"] = (idx(i1, i2, width=3), params(inv, chol, ln))
        if self.r2p:
            i, mu, chol, ln = zip(*self.r2p)
            banks["rp"] = (idx(i, width=2), params(mu, chol, ln))
        if self.r2r:
            i1, i2, obs, chol, ln = zip(*self.r2r)
            banks["rr"] = (idx(i1, i2, width=2), params(obs, chol, ln))
        if self.rg:
            n, K = len(self.rg), self.k_max
            cand = np.zeros((n, K), np.int64)
            r = np.zeros((n, K), np.float32)
            sigma = np.ones((n, K), np.float32)
            logw = np.full((n, K), -1e9, np.float32)
            for i, (_, comps) in enumerate(self.rg):
                for k in range(K):
                    # a row with fewer components repeats its last one at
                    # weight exp(-1e9); each component has its own range
                    ci, rk, sk, lwk = comps[min(k, len(comps) - 1)]
                    cand[i, k], r[i, k], sigma[i, k] = ci, rk, sk
                    if k < len(comps):
                        logw[i, k] = lwk
            banks["rg"] = (idx([oi for oi, _ in self.rg], *cand.T,
                               width=2), params(r, sigma, logw))
        return banks


# ------------------------------------------------------------------ solver
class IncrementalGaussNewtonMAP:
    """Incremental MAP over banked factors with warm-started LM-CG.

    Usage::

        m = IncrementalGaussNewtonMAP(device="cuda")
        m.update(new_nodes, new_factors)   # per incremental step
        x = m.solve()                      # warm-started after step 1
        est = m.results()                  # Variable -> np estimate
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.vars: List[Variable] = []
        self.offset: Dict[Variable, int] = {}
        self.dim = 0
        self._x: Optional[np.ndarray] = None       # warm-start estimate
        self._solved_once = False
        self.banks = FactorBanks()
        self.factors: List[Factor] = []
        self.last_iterations = 0
        self.last_nll = float("nan")

    # -------------------------------------------------------- construction
    def update(self, new_nodes: Sequence[Variable],
               new_factors: Sequence[Factor]) -> None:
        for v in new_nodes:
            if v in self.offset:
                continue
            self.offset[v] = self.dim
            self.vars.append(v)
            self.dim += v.dim
        if self._x is not None and self.dim > len(self._x):
            self._x = np.concatenate(
                [self._x, np.zeros(self.dim - len(self._x), np.float32)])
        for f in new_factors:
            self.banks.add(f, self.offset)
            self.factors.append(f)
        if self._x is not None:
            self._init_new_values(new_nodes, new_factors)

    # ------------------------------------------------------- initialization
    def _init_new_values(self, new_nodes, new_factors) -> None:
        """Dead-reckon new poses; score candidate points on the range rings
        of new landmarks (the warm-start half of the ISAM2 analog)."""
        new = list(new_nodes)
        x = self._x
        dev = self.device
        for f in new_factors:
            if isinstance(f, SE2RelativeGaussianLikelihoodFactor):
                v1, v2 = f.vars
                if v2 in new and v1 not in new:
                    o = self.offset[v1]
                    pose = geom.se2_compose(
                        torch.as_tensor(x[o:o + 3], device=dev),
                        torch.as_tensor(f.obs, dtype=torch.float32,
                                        device=dev))
                    x[self.offset[v2]:self.offset[v2] + 3] = \
                        pose.cpu().numpy()
                    new = [v for v in new if v != v2]
            elif isinstance(f, UnarySE2ApproximateGaussianPriorFactor):
                v = f.vars[0]
                if v in new:
                    x[self.offset[v]:self.offset[v] + 3] = f.prior_pose
                    new = [u for u in new if u != v]
            elif isinstance(f, UnaryR2GaussianPriorFactor):
                v = f.vars[0]
                if v in new:
                    x[self.offset[v]:self.offset[v] + 2] = f.mu
                    new = [u for u in new if u != v]
        # landmarks: candidates on the measured ring around the observer,
        # scored by every factor that touches the landmark.  A landmark
        # touched again by a new range is re-scored too: one range leaves
        # it on an ambiguous ring, and once a second range disambiguates
        # it the warm start must be allowed to jump ring modes (local LM
        # cannot)
        new_set = set(new)
        lmk_candidates: Dict[Variable, list] = {}
        for f in new_factors:
            if not isinstance(f, (_RangeFactorBase, BinaryFactorMixture)):
                continue
            for v in f.vars[1:]:
                if v.dim != 2:
                    continue
                o = self.offset[f.vars[0]]
                center = x[o:o + 2].copy()
                ring = f.components[0] if isinstance(
                    f, BinaryFactorMixture) else f
                lmk_candidates.setdefault(v, []).append(
                    (center, float(ring.obs[0]), float(ring.sigma)))
        for v, rings in lmk_candidates.items():
            all_touch = [f for f in self.factors if v in f.vars]
            if v not in new_set and len(all_touch) > 12:
                # a settled landmark is re-scored only when a new range
                # disagrees with its estimate by more than 4 sigma (a
                # wrong-mode commitment)
                inc = x[self.offset[v]:self.offset[v] + 2]
                if all(abs(np.linalg.norm(inc - c) - r) < 4.0 * sg
                       for (c, r, sg) in rings):
                    continue
            cands = []
            for (c, r, sg) in rings:
                # arc spacing <= ~2 sigma, so the true mode's basin is
                # always sampled
                M = int(np.clip(np.pi * r / max(sg, 1e-3),
                                LANDMARK_INIT_CANDIDATES, 512))
                angs = np.linspace(-np.pi, np.pi, M, endpoint=False)
                cands.append(c[None] + r * np.stack([np.cos(angs),
                                                     np.sin(angs)], 1))
            if v not in new_set:
                # keep the incumbent estimate in the running
                cands.append(x[self.offset[v]:self.offset[v] + 2][None])
            cands = np.concatenate(cands, axis=0)
            rows_v = torch.as_tensor(cands.astype(np.float32), device=dev)
            # one batched log_pdf a factor over all candidates, summed on
            # the device; one read for the winner
            scores = torch.zeros(len(cands), dtype=torch.float64,
                                 device=dev)
            for f in all_touch:
                cols = []
                for fv in f.vars:
                    if fv == v:
                        cols.append(rows_v)
                    else:
                        of = self.offset[fv]
                        cols.append(torch.as_tensor(
                            x[of:of + fv.dim], device=dev).expand(
                                len(cands), fv.dim))
                scores = scores + f.log_pdf(torch.cat(cols, dim=1)).double()
            best = cands[int(torch.argmax(scores))]
            x[self.offset[v]:self.offset[v] + 2] = best

    # ------------------------------------------------------------- solving
    def _cold_start(self) -> np.ndarray:
        """Priors, dead-reckoning and ring scoring, walking the factors in
        insertion order (parents come before children in every incremental
        stream)."""
        self._x = np.zeros(self.dim, np.float32)
        self._init_new_values(list(self.vars), self.factors)
        return self._x

    def solve(self, timer: Optional[List[float]] = None) -> np.ndarray:
        """One LM-CG solve: cold (``_cold_start``, at most MAP_MAX_ITERS
        iterations) the first time, warm from the last estimate (at most
        MAP_WARM_MAX_ITERS) after."""
        t0 = time.time()
        if self._x is None:
            self._cold_start()
        x0 = torch.as_tensor(self._x[:self.dim], dtype=MAP_DTYPE,
                             device=self.device)
        x, f_val, it = lm_cg_solve(
            x0, self.banks.to_device(self.device, MAP_DTYPE),
            MAP_WARM_MAX_ITERS if self._solved_once else MAP_MAX_ITERS)
        x = x.cpu().numpy().astype(np.float32)
        self._x = x.copy()
        self._solved_once = True
        self.last_iterations = it
        self.last_nll = float(f_val)
        if timer is not None:
            timer.append(time.time() - t0)
        return x

    def results(self) -> Dict[Variable, np.ndarray]:
        out: Dict[Variable, np.ndarray] = {}
        for v in self.vars:
            o = self.offset[v]
            out[v] = self._x[o:o + v.dim]
        return out
