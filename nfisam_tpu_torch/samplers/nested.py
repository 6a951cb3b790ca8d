"""Batched nested sampling, static and dynamic, over ``(n, dim)`` tensors.

Counterpart of ``nfisam_tpu/samplers/nested.py``: the ground-truth
posterior sampler of NF-iSAM's evaluation.  Each iteration retires the K
worst live points at once and regenerates them with constrained proposals
batched over the K rows: random-direction slice sampling with shrinkage
(``rslice``), a constrained random walk (``rwalk``) or a reflective
Hamiltonian slice driven by the gradient of ``loglike(ptform(u))`` in
unit-cube coordinates (``grad``).  Evidence and posterior weights come
from the merged birth-death record of every point ever created
(``combine_runs``), so unions of runs with different live-point counts
(the dynamic mode's injected batches) share one estimator.

The JAX package runs each iteration as one compiled program; here the
loops run eagerly on the tensors' device, each batch of
``loglike(ptform(u))`` replayed from a CUDA graph on a card
(``utils/cuda_graph.py``), and read the host once per shrink step (are
all K rows done?) and once per iteration (the dlogz gap and the
threshold).  Every key comes from ``split_host`` in the JAX
package's order and seeds a ``torch.Generator`` on the device, so draws
agree with the JAX package's in distribution; ``ncall`` counts what the
JAX package counts (K per shrink step or walk step, 2K per gradient
step).  ``combine_runs`` and the final resampling are the JAX package's
numpy, bit for bit.  ``HOST_READS`` counts the loops' host reads by kind.

As in the JAX package, ``GlobalNestedSampler.sample`` picks the dynamic
sampler for ``dynamic=True`` or any ``sampling_method`` but "nested".
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.variables import Variable
from ..factors.factors import Factor, value_and_grad_rows
from ..utils.cuda_graph import CudaGraphed
from ..utils.device import resolve_device
from ..utils.keys import split_host, torch_generator
from .joint import StructuredJointFactor

PROPOSALS = ("rslice", "rwalk", "grad")

# host reads of the samplers' loops, by kind, since the caller last
# cleared it: "ns_shrink", "ns_iteration", "ns_batch", "nuts_doubling",
# "smc_bisection", "smc_stage"
HOST_READS: Counter = Counter()


def read_host(t: torch.Tensor, kind: str):
    """``t`` as Python values (one device sync), counted under ``kind``."""
    HOST_READS[kind] += 1
    return t.tolist()


@dataclass(frozen=True)
class NestedConfig:
    n_live: int = 1000
    replace_batch: int = 25        # K dead points per iteration
    walk_steps: int = 30           # T steps (rwalk and grad proposals)
    slices: int = 5                # random-direction slices (rslice)
    max_shrink: int = 64           # shrinkage cap per slice
    max_iters: int = 4000
    dlogz: float = 0.05
    proposal: str = "rslice"       # rslice | rwalk | grad

    def __post_init__(self):
        if self.proposal not in PROPOSALS:
            raise ValueError(
                f"NestedConfig.proposal={self.proposal!r}: "
                f"expected one of {PROPOSALS}")


def _reflect_unit(u: torch.Tensor) -> torch.Tensor:
    """Reflect proposals back into [0, 1]^d."""
    u = torch.remainder(u, 2.0)
    return torch.where(u > 1.0, 2.0 - u, u)


# --------------------------------------------------------------------------
# constrained proposals over (K, dim) batches
# --------------------------------------------------------------------------
class _Target:
    """The batched callables of one run: ``ptform``, ``like`` =
    ``loglike(ptform(u))`` and ``like_vg`` = its value and gradient in
    ``u``, each replayed from a CUDA graph on a card."""

    def __init__(self, ptform: Callable, loglike: Callable) -> None:
        def like(u):
            return loglike(ptform(u))

        self.ptform = CudaGraphed(ptform)
        self.like = CudaGraphed(like)
        self.like_vg = CudaGraphed(lambda u: value_and_grad_rows(like, u))


def _rwalk_replace(gen, u0, l0, L_thresh, sigma, like, T):
    """T constrained Gaussian random-walk steps; returns (u, l, ncall)."""
    K, dim = u0.shape
    u, l = u0, l0
    for _ in range(T):
        step = sigma * torch.randn((K, dim), generator=gen, device=u.device)
        u_prop = _reflect_unit(u + step)
        l_prop = like(u_prop)
        accept = l_prop > L_thresh
        u = torch.where(accept[:, None], u_prop, u)
        l = torch.where(accept, l_prop, l)
    return u, l, T * K


def _rslice_replace(gen, u0, l0, L_thresh, like, S, max_shrink):
    """S random-direction slice-sampling updates with shrinkage.

    A bracket of length 2 along a random unit direction, placed uniformly
    at random around the current point (Neal 2003's fixed-length
    interval: a centred bracket breaks reversibility); shrinking it
    converges on the current point, which satisfies the constraint.  The
    rows that have accepted are frozen; the loop ends when all have, or
    after ``max_shrink`` steps.
    """
    K, dim = u0.shape
    dev = u0.device
    u, l, ncall = u0, l0, 0
    for _ in range(S):
        d = torch.randn((K, dim), generator=gen, device=dev)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        lo = -2.0 * torch.rand(K, generator=gen, device=dev)
        hi = lo + 2.0
        done = torch.zeros(K, dtype=torch.bool, device=dev)
        u_out, l_out = u, l
        for _ in range(max_shrink):
            t = lo + (hi - lo) * torch.rand(K, generator=gen, device=dev)
            u_prop = _reflect_unit(u + t[:, None] * d)
            l_prop = like(u_prop)
            acc = (l_prop > L_thresh) & ~done
            u_out = torch.where(acc[:, None], u_prop, u_out)
            l_out = torch.where(acc, l_prop, l_out)
            done = done | acc
            shrink = ~done
            lo = torch.where(shrink & (t < 0), t, lo)
            hi = torch.where(shrink & (t >= 0), t, hi)
            ncall += K
            if read_host(done.all(), "ns_shrink"):
                break
        u, l = u_out, l_out
    return u, l, ncall


def _grad_replace(gen, u0, l0, L_thresh, sigma, like, like_vg, T):
    """Gradient-guided constrained proposal: a reflective Hamiltonian
    slice.  A random velocity is integrated for T steps of per-dim size
    ``sigma``; crossing the cube's boundary reflects position and
    velocity, and a step landing below the threshold moves there and
    reflects the velocity off the constraint surface,
    ``v <- v - 2 (v.g / g.g) g``, with the gradient of
    ``loglike(ptform(u))`` at that outside point (so the reverse path
    reflects alike).  The endpoint is accepted if it meets the
    constraint; otherwise the walker stays."""
    K, dim = u0.shape
    u = u0
    v = torch.randn((K, dim), generator=gen, device=u0.device)
    for _ in range(T):
        m = torch.remainder(u + sigma * v, 2.0)
        u = torch.where(m > 1.0, 2.0 - m, m)            # cube reflection
        v = torch.where(m > 1.0, -v, v)
        l_new, g = like_vg(u)
        g2 = torch.sum(g * g, dim=1, keepdim=True)
        v_bounce = v - 2.0 * g * (torch.sum(v * g, dim=1, keepdim=True) /
                                  torch.where(g2 > 0, g2, 1.0))
        v = torch.where((l_new <= L_thresh)[:, None], v_bounce, v)
    l_T = like(u)
    ok = l_T > L_thresh
    # 2K calls a step (a likelihood batch and a gradient batch), then K
    return (torch.where(ok[:, None], u, u0), torch.where(ok, l_T, l0),
            2 * K * T + K)


def build_ns_iteration(target: _Target, dim: int, cfg: NestedConfig):
    """One iteration: retire the K worst, regenerate them from K live
    points drawn uniformly among the rest."""
    K, N = cfg.replace_batch, cfg.n_live
    # float32, as the JAX package's program computes them
    shrink = np.float32(K) / np.float32(N)
    log_dvol_offset = float(np.log1p(-np.exp(-shrink)) -
                            np.log(np.float32(K)))

    def iteration(key, U, L, logvol, logz):
        order = torch.argsort(L, stable=True)
        dead_idx = order[:K]
        L_dead = L[dead_idx]
        X_dead = target.ptform(U[dead_idx])
        L_thresh = L_dead[-1]          # largest of the dead batch
        # running evidence: the termination diagnostic only; the weights
        # come from the birth-death merge
        new_logvol = logvol - float(shrink)
        log_dvol = logvol + log_dvol_offset
        logz = torch.logaddexp(logz, torch.logsumexp(L_dead + log_dvol, 0))

        k_start, k_prop = split_host(key)
        gen = torch_generator(k_start, U.device)
        start_idx = order[K:][torch.randint(N - K, (K,), generator=gen,
                                            device=U.device)]
        u0, l0 = U[start_idx], L[start_idx]
        gen = torch_generator(k_prop, U.device)
        if cfg.proposal == "rwalk":
            sigma = 2.0 * torch.std(U, dim=0, correction=0) / math.sqrt(dim)
            u_new, l_new, ncall = _rwalk_replace(
                gen, u0, l0, L_thresh, sigma, target.like, cfg.walk_steps)
        elif cfg.proposal == "grad":
            sigma = torch.std(U, dim=0, correction=0) / math.sqrt(dim)
            u_new, l_new, ncall = _grad_replace(
                gen, u0, l0, L_thresh, sigma, target.like, target.like_vg,
                cfg.walk_steps)
        else:
            u_new, l_new, ncall = _rslice_replace(
                gen, u0, l0, L_thresh, target.like, cfg.slices,
                cfg.max_shrink)
        U = U.index_put((dead_idx,), u_new)
        L = L.index_put((dead_idx,), l_new)
        logz_remain = torch.max(L) + new_logvol
        return (U, L, new_logvol, logz, X_dead, L_dead, dead_idx,
                L_thresh, logz_remain, ncall)

    return iteration


# --------------------------------------------------------------------------
# birth-death run record and merge (Higson et al. 2019): host numpy
# --------------------------------------------------------------------------
@dataclass
class NSRun:
    """Every point ever created: position, death likelihood, birth
    threshold (-inf for points drawn from the unconstrained prior)."""
    X: np.ndarray          # (n, dim) parameter positions
    L_death: np.ndarray    # (n,)
    L_birth: np.ndarray    # (n,)
    ncall: int


def combine_runs(runs: Sequence[NSRun],
                 n_sim: int = 64,
                 rng: Optional[np.random.Generator] = None
                 ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Merge birth-death records into posterior weights and evidence.

    At each death L_i the number of live points is
    ``n_i = #{j : L_birth_j < L_i <= L_death_j}``; prior volume shrinks by
    ``E[log t] = -1/n_i`` per death.  Returns (X, logwt, logz, logzerr);
    logzerr from ``n_sim`` resimulations of log t_i ~ -Exp(1)/n_i.
    """
    X = np.concatenate([r.X for r in runs], axis=0)
    Ld = np.concatenate([np.asarray(r.L_death, np.float64) for r in runs])
    Lb = np.concatenate([np.asarray(r.L_birth, np.float64) for r in runs])
    order = np.argsort(Ld, kind="stable")
    X, Ld, Lb = X[order], Ld[order], Lb[order]
    n = len(Ld)
    births_sorted = np.sort(Lb)
    # points born strictly below L_i, minus deaths already processed
    n_alive = np.searchsorted(births_sorted, Ld, side="left") \
        - np.arange(n)
    n_alive = np.maximum(n_alive, 1).astype(np.float64)

    log_t = -1.0 / n_alive
    logX = np.cumsum(log_t)
    logX_prev = np.concatenate([[0.0], logX[:-1]])
    # log(X_{i-1} - X_i), stable
    log_dX = logX_prev + np.log1p(-np.exp(logX - logX_prev))
    logwt = Ld + log_dX
    m = logwt.max()
    logz = m + np.log(np.exp(logwt - m).sum())

    if rng is None:
        rng = np.random.default_rng(0)
    # resimulate shrinkage for the error bar
    sim_log_t = -rng.exponential(size=(n_sim, n)) / n_alive[None, :]
    sim_logX = np.cumsum(sim_log_t, axis=1)
    sim_prev = np.concatenate([np.zeros((n_sim, 1)), sim_logX[:, :-1]],
                              axis=1)
    with np.errstate(divide="ignore"):
        sim_ldX = sim_prev + np.log1p(-np.exp(sim_logX - sim_prev))
    sim_lw = Ld[None, :] + sim_ldX
    mm = sim_lw.max(axis=1, keepdims=True)
    sim_logz = mm[:, 0] + np.log(np.exp(sim_lw - mm).sum(axis=1))
    logzerr = float(np.std(sim_logz))
    return X, logwt, float(logz), logzerr


def _run_ns(key, target: _Target, dim: int, cfg: NestedConfig, device,
            init_U: Optional[torch.Tensor] = None,
            init_L: Optional[torch.Tensor] = None,
            L_birth0: float = -np.inf,
            stop_at_L: float = np.inf) -> NSRun:
    """One nested-sampling run; the live points at termination join the
    record as final deaths (no replacement)."""
    keys = split_host(key, cfg.max_iters + 2)
    if init_U is None:
        U = torch.rand((cfg.n_live, dim),
                       generator=torch_generator(keys[0], device),
                       device=device)
        L = target.like(U)
        ncall = cfg.n_live
    else:
        U, L = init_U, init_L
        ncall = 0
    B = torch.full((cfg.n_live,), L_birth0, dtype=torch.float64,
                   device=device)

    iteration = build_ns_iteration(target, dim, cfg)
    logvol = torch.zeros((), dtype=torch.float32, device=device)
    logz = torch.full((), -1e30, dtype=torch.float32, device=device)
    dead_X: List[torch.Tensor] = []
    dead_L: List[torch.Tensor] = []
    dead_B: List[torch.Tensor] = []
    for it in range(cfg.max_iters):
        (U, L, logvol, logz, X_dead, L_dead, dead_idx, L_thresh,
         logz_remain, nc) = iteration(keys[it + 1], U, L, logvol, logz)
        # exact birth tracking: the retired slots' births leave B and the
        # refills inherit the threshold
        dead_B.append(B[dead_idx])
        B = B.index_put((dead_idx,), L_thresh.to(torch.float64))
        dead_X.append(X_dead)
        dead_L.append(L_dead)
        ncall += nc
        gap = torch.logaddexp(logz, logz_remain) - logz
        gap, thresh = read_host(torch.stack([gap, L_thresh]),
                                "ns_iteration")
        stop = gap < cfg.dlogz
        if stop_at_L < np.inf:
            stop = stop or thresh > stop_at_L
        if stop:
            break
    X = torch.cat(dead_X + [target.ptform(U)], dim=0)
    Ld = torch.cat(dead_L + [L], dim=0)
    Lb = torch.cat(dead_B + [B], dim=0)
    return NSRun(X=X.detach().cpu().numpy(),
                 L_death=Ld.detach().cpu().numpy().astype(np.float64),
                 L_birth=Lb.cpu().numpy(), ncall=ncall)


def nested_sample(key, ptform: Callable, loglike: Callable, dim: int,
                  cfg: NestedConfig = NestedConfig(),
                  summary: Optional[dict] = None, device=None) -> np.ndarray:
    """Static nested sampling; returns equal-weight posterior samples.

    ``ptform``/``loglike`` are batched ``(n, dim)`` callables on tensors
    of ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    run = _run_ns(key, _Target(ptform, loglike), dim, cfg, device)
    X, logwt, logz, logzerr = combine_runs([run])
    return _finish(key, [run], X, logwt, logz, logzerr, cfg, summary)


def dynamic_nested_sample(key, ptform: Callable, loglike: Callable,
                          dim: int, cfg: NestedConfig = NestedConfig(),
                          n_batches: int = 4,
                          batch_live: Optional[int] = None,
                          frac_lo: float = 0.02, frac_hi: float = 0.95,
                          summary: Optional[dict] = None,
                          device=None) -> np.ndarray:
    """Dynamic nested sampling: a base pass, then batches of live points
    targeted at the posterior bulk.

    Each batch injects ``batch_live`` live points born at the likelihood
    L_lo below which only ``frac_lo`` of the posterior mass lies, and runs
    until the batch threshold passes the ``frac_hi`` mass bound; all runs
    merge through the birth-death estimator.
    """
    device = resolve_device(device)
    if batch_live is None:
        batch_live = max(cfg.n_live // 4, 64)
    k_base, *k_batches = split_host(key, n_batches + 1)
    target = _Target(ptform, loglike)
    runs = [_run_ns(k_base, target, dim, cfg, device)]

    bcfg = replace(cfg, n_live=batch_live,
                   replace_batch=max(batch_live // 40, 8))
    for kb in k_batches:
        X, logwt, logz, _ = combine_runs(runs)
        # combine_runs sorts by death likelihood, so the weight quantiles
        # index directly into the sorted L record
        Ld_all = np.sort(np.concatenate([r.L_death for r in runs]))
        w = np.exp(logwt - logwt.max())
        w /= w.sum()
        cw = np.cumsum(w)
        L_lo = float(Ld_all[np.searchsorted(cw, frac_lo)])
        L_hi = float(Ld_all[min(np.searchsorted(cw, frac_hi),
                                len(Ld_all) - 1)])
        # seed batch live points above L_lo: rejection from fresh prior
        # uniforms, then slice decorrelation AT the L_lo constraint
        k1, k2, k3 = split_host(kb, 3)
        u_cand = torch.rand((4 * batch_live, dim),
                            generator=torch_generator(k1, device),
                            device=device)
        l_cand = target.like(u_cand)
        HOST_READS["ns_batch"] += 1
        ok = np.where(l_cand.cpu().numpy().astype(np.float64) > L_lo)[0]
        if len(ok) == 0:
            # constrained region too small for rejection; skip batch
            continue
        reps = torch.as_tensor(np.resize(ok, batch_live), device=device)
        u0, l0 = u_cand[reps], l_cand[reps]
        # duplicated seeds violate the i.i.d.-birth assumption of the
        # birth-death estimator: scale the slice decorrelation with the
        # duplication factor so heavily-recycled batches still mix
        dup = -(-batch_live // len(ok))
        decorrelate = cfg.slices * min(dup, 8)
        u0, l0, nc = _rslice_replace(
            torch_generator(k2, device), u0, l0,
            torch.tensor(L_lo, dtype=torch.float32, device=device),
            target.like, decorrelate, cfg.max_shrink)
        brun = _run_ns(k3, target, dim, bcfg, device, init_U=u0,
                       init_L=l0, L_birth0=L_lo, stop_at_L=L_hi)
        brun.ncall += int(4 * batch_live) + int(nc)
        runs.append(brun)

    X, logwt, logz, logzerr = combine_runs(runs)
    return _finish(key, runs, X, logwt, logz, logzerr, cfg, summary)


def _finish(key, runs, X, logwt, logz, logzerr, cfg, summary):
    weights = np.exp(logwt - logwt.max())
    weights /= weights.sum()
    if summary is not None:
        summary.update({
            "nlive": cfg.n_live,
            "niter": int(sum(len(r.L_death) for r in runs)),
            "ncall": int(sum(r.ncall for r in runs)),
            "eff": 100.0 * len(X) / max(sum(r.ncall for r in runs), 1),
            "logz": float(logz),
            "logzerr": float(logzerr),
        })
    rng = np.random.default_rng(int(np.asarray(key)[1]))
    idx = rng.choice(len(X), size=len(X), p=weights)
    return X[idx]


class GlobalNestedSampler:
    """Ancestral sampling when the graph is a tree, nested sampling over
    its tree/likelihood split otherwise; ``dynamic=True`` or any
    ``sampling_method`` but "nested" selects the dynamic sampler.  Runs on
    ``device`` (``cuda`` unless named)."""

    def __init__(self, nodes: Sequence[Variable],
                 factors: Sequence[Factor], device=None, **kwargs) -> None:
        self._nodes = list(nodes)
        self._dim = sum(v.dim for v in nodes)
        self.device = resolve_device(device)
        self.joint = StructuredJointFactor(factors, nodes)

    def sample(self, key=None, live_points: int = 1000,
               sampling_method: str = "nested", downsampling: bool = False,
               dlogz: float = 0.05, max_iters: int = 4000,
               dynamic: bool = False, n_batches: int = 4,
               proposal: str = "rslice",
               res_summary: Optional[dict] = None, **kwargs) -> np.ndarray:
        if key is None:
            key = np.array([0, 7], dtype=np.uint32)
        if self.joint.if_direct_sampling:
            return self.joint.sample(key, live_points,
                                     self.device).cpu().numpy()
        cfg = NestedConfig(n_live=live_points,
                           replace_batch=max(live_points // 40, 8),
                           dlogz=dlogz, max_iters=max_iters,
                           proposal=proposal)
        dynamic = dynamic or sampling_method not in ("nested",)
        if dynamic:
            samples = dynamic_nested_sample(
                key, self.joint.ptform, self.joint.loglike, self._dim,
                cfg, n_batches=n_batches, summary=res_summary,
                device=self.device)
        else:
            samples = nested_sample(key, self.joint.ptform,
                                    self.joint.loglike, self._dim, cfg,
                                    summary=res_summary, device=self.device)
        if downsampling and samples.shape[0] > live_points:
            rng = np.random.default_rng(0)
            samples = samples[rng.choice(len(samples), live_points,
                                         replace=False)]
        return samples
