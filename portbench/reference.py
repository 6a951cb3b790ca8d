"""The judge of a step's posterior: plain NumPy in float64, from the
stream's own text (``stream.py``); it imports nothing of the program.

A step's answer is the posterior the solver drew after it: ``n`` samples
of every variable the stream has added so far, drawn jointly (sample
``i`` of every variable is one draw of the whole map).  The judge reads
it five ways; each number reads higher the worse the posterior.

- ``faults`` (exact, limit 0): variables of the stream missing from the
  answer, variables the stream never added, samples not finite, and a
  variable whose sample count or width is not the configuration's.
- ``chi2_dof``: how well the samples satisfy the measurements, the mean
  over samples of each factor's whitened squared residual, summed over
  the odometry, range and ambiguous-range factors added so far and
  divided by their measurement dimensions.  The exact posterior of a
  linear-Gaussian graph reads about 1 (each factor's residual at the
  mode plus the posterior's spread); a posterior that ignores a
  measurement, loses the correlation between poses, or is shifted reads
  far higher.  An ambiguous range counts its best candidate, sample by
  sample (the max-mixture).
- ``prior_chi2``: the same for each prior alone, over its 3 dims, the
  worst prior.  Nothing but the prior fixes the map's frame (odometry
  and ranges read alike for the map moved or turned as a whole), so the
  exact marginal of a prior's pose is the prior itself and reads about
  1; a map turned or shifted about its first pose reads higher, and so
  does a pose spread wider than its prior.
- ``narrow``: how much narrower the posterior is than the odometry's
  noise: one over the mean, over every odometry factor and each of its 3
  whitened dims, of the residual's variance across the samples.  The
  relative pose of two consecutive poses is held by its odometry (the
  ranges' 2 m sigma adds little to its 0.1 m), so the exact posterior
  reads about 1; a posterior collapsed to a point reads without bound
  (1e30), one drawn at half its spread reads 4.
- ``repeats``: the largest share of repeated values among one
  coordinate's samples, over every variable and coordinate.  Draws from
  a continuous posterior in float32 (a spacing of 1e-6 to 1.5e-5 m at
  the maps' 1-170 m) all but never repeat; samples served at a lower
  precision do (bfloat16 keeps 8 bits: a spacing of 0.25-1 m there).

The residuals are the port's factor definitions
(``factors/factors.py``), written out again: odometry is the exp-map
Gaussian of ``log(obs^-1 * (x_i^-1 * x_j))`` under the stated covariance,
a prior the same of ``log(obs^-1 * x)``, a range is
``(|t_pose - l| - obs) / sigma``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .stream import MIXTURE, ODOM, PRIOR, RANGE, Fac, Var


def _wrap(a):
    return (a + np.pi) % (2.0 * np.pi) - np.pi


def _se2_inverse(a):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    x, y = a[..., 0], a[..., 1]
    return np.stack([-(c * x + s * y), s * x - c * y, _wrap(-a[..., 2])],
                    axis=-1)


def _se2_compose(a, b):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                     a[..., 1] + s * b[..., 0] + c * b[..., 1],
                     _wrap(a[..., 2] + b[..., 2])], axis=-1)


def _se2_log(t):
    x, y, w = t[..., 0], t[..., 1], t[..., 2]
    h = w / 2.0
    small = np.abs(w) < 1e-8
    h_safe = np.where(small, 1.0, h)
    A = np.where(small, 1.0 - h * h / 3.0, h_safe / np.tan(h_safe))
    return np.stack([A * x + h * y, -h * x + A * y, w], axis=-1)


def _whitened(obs, cov, x) -> np.ndarray:
    """(n, 3) exp-map residual ``log(obs^-1 * x)`` of samples ``x`` (n, 3)
    whitened by ``cov`` (its Cholesky factor's inverse)."""
    v = _se2_log(_se2_compose(_se2_inverse(obs), x))
    return np.linalg.solve(np.linalg.cholesky(cov), v.T).T


def odom_whitened(f: Fac, xi, xj) -> np.ndarray:
    """(n, 3) whitened residual of odometry ``f`` at samples ``xi``, ``xj``
    (n, 3)."""
    return _whitened(f.obs, f.cov, _se2_compose(_se2_inverse(xi), xj))


def odom_chi2(f: Fac, xi, xj) -> np.ndarray:
    """(n,) squared Mahalanobis residual of odometry ``f``."""
    return (odom_whitened(f, xi, xj) ** 2).sum(axis=1)


def range_chi2(obs, sigma, pose, lmk) -> np.ndarray:
    d = np.linalg.norm(pose[:, :2] - lmk[:, :2], axis=1)
    return ((d - obs) / sigma) ** 2


def factor_chi2(f: Fac, samples: Dict[str, np.ndarray]):
    """(mean over samples of the whitened squared residual, measurement
    dims) of one factor, or None for a prior."""
    if f.kind == PRIOR:
        return None
    if f.kind == ODOM:
        return float(odom_chi2(f, samples[f.vars[0]],
                               samples[f.vars[1]]).mean()), 3
    if f.kind == RANGE:
        return float(range_chi2(f.obs[0], f.cov[0], samples[f.vars[0]],
                                samples[f.vars[1]]).mean()), 1
    if f.kind == MIXTURE:
        pose = samples[f.vars[0]]
        best = np.min([range_chi2(f.obs[0], f.cov[0], pose, samples[c])
                       for c in f.vars[1:]], axis=0)
        return float(best.mean()), 1
    raise ValueError(f"no residual for {f.kind}")


def prior_chi2(f: Fac, x) -> float:
    """Mean over samples ``x`` (n, 3) of prior ``f``'s whitened squared
    residual, per dim."""
    return float((_whitened(f.obs, f.cov, x) ** 2).sum(axis=1).mean()) / 3


NO_SPREAD = 1e30      # ``narrow`` of samples that do not spread
SPREAD_FLOOR = 1e-12  # whitened variances below this are round-off


def judge_step(answer: Dict[str, np.ndarray], vars_: List[Var],
               factors: List[Fac], n_samples: int) -> dict:
    """One step's reading: ``answer`` {name: (n, dim)} against the
    variables and factors the stream has added up to that step.  A number
    with nothing to read (no prior, no odometry) is None."""
    expected = {v.name: v.dim for v in vars_}
    faults = len(set(answer) ^ set(expected))
    good, repeats = {}, 0.0
    for name, x in answer.items():
        x = np.asarray(x, dtype=np.float64)
        if name not in expected or x.shape != (n_samples, expected[name]) \
                or not np.isfinite(x).all():
            faults += name in expected
            continue
        good[name] = x
        for col in x.T:
            repeats = max(repeats, 1.0 - len(np.unique(col)) / len(col))
    total, dof, priors, spreads = 0.0, 0, [], []
    for f in factors:
        if not all(name in good for name in f.vars):
            continue
        if f.kind == PRIOR:
            priors.append(prior_chi2(f, good[f.vars[0]]))
            continue
        if f.kind == ODOM:
            w = odom_whitened(f, good[f.vars[0]], good[f.vars[1]])
            if n_samples > 1:
                spreads.append(w.var(axis=0, ddof=1))
            read = float((w ** 2).sum(axis=1).mean()), 3
        else:
            read = factor_chi2(f, good)
        total += read[0]
        dof += read[1]
    spread = float(np.mean(spreads)) if spreads else None
    return {"faults": faults, "chi2_dof": total / dof if dof else None,
            "prior_chi2": max(priors) if priors else None,
            "narrow": None if spread is None else
            1.0 / spread if spread > SPREAD_FLOOR else NO_SPREAD,
            "repeats": repeats if good else None}


def judge(answers, steps, n_samples: int) -> List[dict]:
    """Each answer's reading: ``answers`` is a list of (k, posterior drawn
    after step ``k`` of ``steps`` (``stream.fleet``)), in step order, each
    judged against everything the steps up to ``k`` added."""
    vars_, factors, done, reads = [], [], 0, []
    for k, answer in answers:
        for vs, fs in steps[done:k + 1]:
            vars_ += vs
            factors += fs
        done = k + 1
        reads.append({"step": k, **judge_step(answer, vars_, factors,
                                              n_samples)})
    return reads
