"""Adaptive-tempering sequential Monte Carlo over ``(n, dim)`` tensors.

Counterpart of ``nfisam_tpu/samplers/smc.py``: the likelihood is raised
from the ancestral prior to the posterior, each stage's temperature
increment bisected so that the effective sample size stays at a target
fraction, then systematic resampling and random-walk Metropolis moves
scaled by the particles' spread, whose acceptance includes the prior
density ratio (the stage target is ``prior(x) * like(x)^beta``).

The JAX package runs a stage as one compiled program; here it runs
eagerly on the particles' device, the likelihood and prior batches
replayed from CUDA graphs on a card.  The bisection reads the host once a
step (is the bracket narrower than 1e-4?) and a stage once (the new
temperature), counted in ``nested.HOST_READS``.  Keys come from
``split_host`` in the JAX package's order and seed ``torch.Generator``s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.variables import Variable
from ..factors.factors import Factor
from ..utils.cuda_graph import CudaGraphed
from ..utils.device import resolve_device
from ..utils.keys import split_host, torch_generator
from .joint import StructuredJointFactor
from .nested import read_host


@dataclass(frozen=True)
class SMCConfig:
    n_particles: int = 2000
    ess_target: float = 0.5       # fraction of N
    mh_steps: int = 10
    max_stages: int = 50
    step_scale: float = 0.5


def _systematic_resample(gen, weights: torch.Tensor, n: int
                         ) -> torch.Tensor:
    u = (torch.rand((), generator=gen, device=weights.device) +
         torch.arange(n, device=weights.device)) / n
    cum = torch.cumsum(weights, dim=0)
    # an index past the end (rounding in the cumsum) takes the last
    # particle, as an out-of-range gather does in the JAX package
    return torch.clamp(torch.searchsorted(cum, u), max=n - 1)


def _find_next_beta(loglike: torch.Tensor, beta: float,
                    ess_target_n: float) -> torch.Tensor:
    """Bisect the temperature increment so that the ESS is the target;
    the whole remaining increment when that keeps the ESS above it."""
    def ess(db):
        w = db * loglike
        w = w - torch.logsumexp(w, 0)
        return torch.exp(-torch.logsumexp(2 * w, 0))

    rest = torch.tensor(1.0 - beta, dtype=torch.float32,
                        device=loglike.device)
    lo = torch.zeros((), dtype=torch.float32, device=loglike.device)
    hi, mid = rest, rest
    while read_host(hi - lo > 1e-4, "smc_bisection"):
        mid = 0.5 * (lo + hi)
        too_cold = ess(mid) < ess_target_n
        lo, hi = torch.where(too_cold, lo, mid), torch.where(too_cold, mid,
                                                              hi)
    return torch.where(ess(rest) >= ess_target_n, rest, mid)


def smc_sample(key, prior_sample_fn: Callable, loglike_fn: Callable,
               dim: int, cfg: SMCConfig = SMCConfig(),
               summary: Optional[dict] = None,
               logprior_fn: Optional[Callable] = None,
               device=None) -> np.ndarray:
    """Adaptive-tempering SMC from the ancestral prior to the posterior.

    ``prior_sample_fn(key, n, device)`` draws the prior; ``loglike_fn``
    and ``logprior_fn`` are batched ``(n, dim)`` callables.  The stage
    target is ``prior(x) * like(x)^beta``, so the move kernel's acceptance
    includes the prior density ratio."""
    device = resolve_device(device)
    N = cfg.n_particles
    keys = split_host(key, cfg.max_stages + 1)
    X = prior_sample_fn(keys[0], N, device).to(torch.float32)
    if logprior_fn is None:
        def logprior_fn(x):
            return torch.zeros(x.shape[0], device=x.device)
    loglike_fn = CudaGraphed(loglike_fn)
    logprior_fn = CudaGraphed(logprior_fn)

    def stage(key, X, beta):
        L = loglike_fn(X)
        d_beta = _find_next_beta(L, beta, cfg.ess_target * N)
        w = torch.softmax(d_beta * L, dim=0)
        k_rs, k_mh = split_host(key)
        X = X[_systematic_resample(torch_generator(k_rs, device), w, N)]
        new_beta = beta + d_beta
        # move kernel: random-walk MH targeting prior * like^new_beta
        cov_diag = torch.clamp(torch.var(X, dim=0, correction=0), min=1e-8)
        step = cfg.step_scale * torch.sqrt(cov_diag) / math.sqrt(dim)
        L_cur, P_cur = loglike_fn(X), logprior_fn(X)
        gen = torch_generator(k_mh, device)
        n_acc = torch.zeros((), device=device)
        for _ in range(cfg.mh_steps):
            prop = X + step * torch.randn(X.shape, generator=gen,
                                          device=device)
            L_prop, P_prop = loglike_fn(prop), logprior_fn(prop)
            log_alpha = new_beta * (L_prop - L_cur) + (P_prop - P_cur)
            accept = torch.log(torch.rand(N, generator=gen,
                                          device=device)) < log_alpha
            X = torch.where(accept[:, None], prop, X)
            L_cur = torch.where(accept, L_prop, L_cur)
            P_cur = torch.where(accept, P_prop, P_cur)
            n_acc = n_acc + accept.to(torch.float32).mean()
        return X, new_beta, n_acc / cfg.mh_steps

    beta, stages, acc = 0.0, 0, 0.0
    for s in range(cfg.max_stages):
        X, beta_new, acc_t = stage(keys[s + 1], X, beta)
        beta, acc = read_host(torch.stack([beta_new, acc_t]), "smc_stage")
        stages += 1
        if beta >= 1.0 - 1e-6:
            break
    if summary is not None:
        summary.update({"stages": stages, "final_beta": beta,
                        "mh_accept": float(acc)})
    return X.cpu().numpy()


class GlobalSMCSampler:
    """The graph's ancestral (tree) distribution as the prior measure and
    the remaining factors as the tempered likelihood, the split the nested
    sampler uses.  Runs on ``device`` (``cuda`` unless named)."""

    def __init__(self, nodes: Sequence[Variable],
                 factors: Sequence[Factor], device=None, **kwargs) -> None:
        self._nodes = list(nodes)
        self._dim = sum(v.dim for v in nodes)
        self.device = resolve_device(device)
        self.joint = StructuredJointFactor(factors, nodes)

    def sample(self, key=None, num_samples: int = 2000,
               mh_steps: int = 10, summary: Optional[dict] = None,
               **kwargs) -> np.ndarray:
        if key is None:
            key = np.array([0, 13], dtype=np.uint32)
        if self.joint.if_direct_sampling:
            return self.joint.sample(key, num_samples,
                                     self.device).cpu().numpy()
        cfg = SMCConfig(n_particles=num_samples, mh_steps=mh_steps)
        return smc_sample(key, self.joint.sample, self.joint.loglike,
                          self._dim, cfg, summary=summary,
                          logprior_fn=self.joint.log_prior_tree,
                          device=self.device)
