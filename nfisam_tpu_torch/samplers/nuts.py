"""No-U-Turn sampling over ``(chains, dim)`` tensors.

Counterpart of ``nfisam_tpu/samplers/nuts.py``: dynamic-length NUTS in
its iterative multinomial form (Hoffman & Gelman 2014; Betancourt 2017)
with dual-averaging step-size adaptation and a diagonal mass matrix
estimated from the warmup draws; the gradient of the log density is
``torch.autograd.grad`` of its sum over chains.

The JAX package vmaps a per-chain kernel; here the chains are the rows of
one batch and take their leapfrog steps in lockstep.  A chain whose tree
has stopped is frozen (its carry kept by a select), as under ``vmap`` of a
``while_loop``.  Every active chain has the same depth, so the subtree's
2^depth leapfrog steps and its checkpoint slots are host integers; the
host is read once a doubling (has every chain stopped?), counted in
``nested.HOST_READS``.  A subtree's steps run as one CUDA graph per
depth on a card, each leapfrog step taking one log density and gradient
evaluation: the gradient at a step's end is the next step's start.
Where every factor of the graph has a bank in ``solver/banked_joint.py``,
``GlobalMCMCSampler`` evaluates the joint density by banks (a few
batched operations a factor type, where ``log_pdf`` takes a few a
factor); it is the same function.  Keys come from ``split_host`` in the
JAX package's order and seed ``torch.Generator``s, one a transition for
all chains.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.variables import Variable
from ..factors.factors import Factor, value_and_grad_rows
from ..utils.cuda_graph import CudaGraphed
from ..utils.device import resolve_device
from ..utils.keys import split_host, torch_generator
from .joint import StructuredJointFactor
from .nested import read_host


@dataclass(frozen=True)
class NUTSConfig:
    num_samples: int = 1000
    num_warmup: int = 500
    max_treedepth: int = 8
    target_accept: float = 0.8
    num_chains: int = 4


def _leapfrog(grad_fn, q, p, eps, inv_mass):
    """One leapfrog step, the gradient taken at both ends."""
    p = p + 0.5 * eps * grad_fn(q)
    q = q + eps * inv_mass * p
    p = p + 0.5 * eps * grad_fn(q)
    return q, p


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _ctz(x: int) -> int:
    """Trailing zeros of x > 0."""
    return (x & -x).bit_length() - 1


def _where(cond, a, b):
    """Rowwise select: ``cond`` (C,) picks rows of (C,) or (C, dim)."""
    return torch.where(cond[:, None] if a.ndim == 2 else cond, a, b)


def _is_turn(dq, p_a, p_b, inv_mass):
    return (torch.sum(dq * p_a * inv_mass, dim=1) < 0) | \
        (torch.sum(dq * p_b * inv_mass, dim=1) < 0)


def _subtree(logprob_fn: Callable, D: int):
    """The 2^depth leapfrog steps of one subtree, depth read from
    ``unif``'s shape (one uniform a step and chain, for the multinomial
    choice): returns its end state (q, p, gradient), log weight, chosen
    point, the acceptance sums carried in and whether it holds a U-turn
    or a divergence.  Its host integers are the step index's checkpoint
    slots, so one CUDA graph per depth replays it."""
    def run(q, p, g, H0, step, sign, inv_mass, unif, acc_sum, acc_n):
        C, dim = q.shape
        logw = torch.full((C,), -math.inf, device=q.device)
        q_sub = q
        ckq = torch.zeros((C, D + 1, dim), device=q.device)
        ckp = torch.zeros((C, D + 1, dim), device=q.device)
        bad = torch.zeros(C, dtype=torch.bool, device=q.device)
        for i in range(unif.shape[0]):
            p = p + 0.5 * step * g
            q = q + step * inv_mass * p
            logp, g = value_and_grad_rows(logprob_fn, q)
            p = p + 0.5 * step * g
            dH = logp - 0.5 * torch.sum(p * p * inv_mass, dim=1) - H0
            diverged = (dH < -1000.0) | ~torch.isfinite(dH)
            acc_sum = acc_sum + torch.clamp(torch.exp(dH), max=1.0)
            acc_n = acc_n + 1
            # multinomial: keep this point with prob w / w_total
            logw_next = torch.logaddexp(logw, dH)
            q_sub = _where(torch.log(unif[i]) < dH - logw_next, q, q_sub)
            logw = logw_next
            # checkpoints: an even leaf i starts power-of-two blocks, in
            # slot popcount(i)
            if i % 2 == 0:
                ckq[:, _popcount(i)] = q
                ckp[:, _popcount(i)] = p
            # U-turns of every aligned block of 2^k leaves ending at leaf
            # i (2^k | i+1), its start in slot pc-1+c-k; a leftward build
            # integrates with -eps, so the displacement is flipped to
            # read q_plus - q_minus
            c, pc = _ctz(i + 1), _popcount(i + 1)
            for k in range(1, c + 1):
                slot = min(max(pc - 1 + c - k, 0), D)
                bad = bad | _is_turn(sign * (q - ckq[:, slot]),
                                     ckp[:, slot], p, inv_mass)
            bad = bad | diverged
        return q, p, g, logw, q_sub, acc_sum, acc_n, bad

    return run


def build_nuts_kernel(logprob_fn: Callable, dim: int, cfg: NUTSConfig):
    """One NUTS transition of every chain (the rows of ``q0``).

    Iterative tree doubling with multinomial state selection: a new
    subtree joins the sample only if it holds no internal U-turn (checked
    against the checkpoint states at its power-of-two block boundaries)
    and no divergent leaf (dH < -1000); an invalid subtree is discarded
    whole and the transition ends.  ``logprob_fn`` maps (C, dim) to (C,).
    """
    D = cfg.max_treedepth
    value_and_grad = CudaGraphed(lambda q: value_and_grad_rows(logprob_fn, q))
    subtree = CudaGraphed(_subtree(logprob_fn, D))

    def kernel(gen, q0, eps, inv_mass):
        C, dev = q0.shape[0], q0.device
        eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        p0 = torch.randn((C, dim), generator=gen, device=dev) / \
            torch.sqrt(inv_mass)
        logp0, g0 = value_and_grad(q0)
        H0 = logp0 - 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1)
        dirs = torch.rand((C, D), generator=gen, device=dev) < 0.5

        qm, pm, gm = q0, p0, g0
        qp, pp, gp = q0, p0, g0
        q_s = q0
        logw = torch.zeros(C, device=dev)
        stop = torch.zeros(C, dtype=torch.bool, device=dev)
        acc_sum = torch.zeros(C, device=dev)
        acc_n = torch.zeros(C, device=dev)
        for depth in range(D):
            active = ~stop
            if not read_host(active.any(), "nuts_doubling"):
                break
            go_right = dirs[:, depth]
            step = torch.where(go_right, eps, -eps)[:, None]
            sign = torch.where(go_right, 1.0, -1.0)[:, None]
            unif = torch.rand((2 ** depth, C), generator=gen, device=dev)
            q, p, g, logw_sub, q_sub, sub_sum, sub_n, bad = subtree(
                _where(go_right, qp, qm), _where(go_right, pp, pm),
                _where(go_right, gp, gm), H0, step, sign, inv_mass, unif,
                acc_sum, acc_n)
            valid = ~bad
            keep_m = go_right | bad
            extend_p = go_right & valid
            qm2, pm2, gm2 = _where(keep_m, qm, q), _where(keep_m, pm, p), \
                _where(keep_m, gm, g)
            qp2, pp2, gp2 = _where(extend_p, q, qp), \
                _where(extend_p, p, pp), _where(extend_p, g, gp)
            # multinomial merge of the new subtree, only if it is valid
            logw2 = torch.where(valid, torch.logaddexp(logw, logw_sub), logw)
            take_sub = valid & (torch.log(torch.rand(
                C, generator=gen, device=dev)) < logw_sub - logw2)
            q_s2 = _where(take_sub, q_sub, q_s)
            # the merged tree's U-turn across its two ends
            stop2 = _is_turn(qp2 - qm2, pm2, pp2, inv_mass) | bad
            # stopped chains keep their carry
            qm, pm, gm = _where(active, qm2, qm), _where(active, pm2, pm), \
                _where(active, gm2, gm)
            qp, pp, gp = _where(active, qp2, qp), _where(active, pp2, pp), \
                _where(active, gp2, gp)
            q_s = _where(active, q_s2, q_s)
            logw = torch.where(active, logw2, logw)
            acc_sum = torch.where(active, sub_sum, acc_sum)
            acc_n = torch.where(active, sub_n, acc_n)
            stop = torch.where(active, stop2, stop)
        return q_s, acc_sum / torch.clamp(acc_n, min=1.0)

    return kernel


def nuts_sample(key, logprob_fn: Callable, dim: int, init_q: np.ndarray,
                cfg: NUTSConfig = NUTSConfig(), device=None):
    """Run NUTS on ``cfg.num_chains`` chains in lockstep; returns
    (samples, diagnostics).  ``logprob_fn`` maps (C, dim) to (C,)."""
    device = resolve_device(device)
    kernel = build_nuts_kernel(logprob_fn, dim, cfg)
    C = cfg.num_chains

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    mu = math.log(10.0 * 0.1)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    target = cfg.target_accept

    def warmup_step(carry, key):
        q, eps, eps_bar, H_bar, t, inv_mass = carry
        q, acc = kernel(torch_generator(key, device), q, eps, inv_mass)
        H_bar = (1 - 1 / (t + t0)) * H_bar + \
            (target - torch.mean(acc)) / (t + t0)
        log_eps = mu - torch.sqrt(t) / gamma * H_bar
        eta = t ** (-kappa)
        log_eps_bar = eta * log_eps + (1 - eta) * torch.log(eps_bar)
        return (q, torch.exp(log_eps), torch.exp(log_eps_bar), H_bar, t + 1,
                inv_mass), q

    q = torch.as_tensor(np.broadcast_to(np.asarray(init_q, np.float32),
                                        (C, dim)).copy(), device=device)
    q = q + 0.01 * torch.randn(
        q.shape, generator=torch_generator(np.array([0, 0], np.uint32),
                                           device), device=device)
    inv_mass = torch.ones(dim, device=device)

    # phase 1: step-size adaptation
    n_half = cfg.num_warmup // 2
    carry = (q, f32(0.1), f32(0.1), f32(0.0), f32(1.0), inv_mass)
    draws = []
    for k in split_host(key, n_half):
        carry, q = warmup_step(carry, k)
        draws.append(q)
    q, eps_bar = carry[0], carry[2]
    # phase 2: mass-matrix estimation from the warmup draws, then
    # step-size adaptation again
    if draws:
        inv_mass = torch.clamp(torch.var(torch.cat(draws, dim=0), dim=0,
                                         correction=0), min=1e-6)
    carry = (q, eps_bar, eps_bar, f32(0.0), f32(1.0), inv_mass)
    for k in split_host(split_host(key, 1)[0], n_half):
        carry, _ = warmup_step(carry, k)
    q, eps_bar = carry[0], carry[2]

    n_per_chain = -(-cfg.num_samples // C)
    qs, accs = [], []
    for k in split_host(split_host(key, 2)[1], n_per_chain):
        q, acc = kernel(torch_generator(k, device), q, eps_bar, inv_mass)
        qs.append(q)
        accs.append(acc)
    samples = torch.stack(qs).reshape(-1, dim)[:cfg.num_samples]
    diags = {"accept_rate": float(torch.stack(accs).mean()),
             "step_size": float(eps_bar)}
    return samples.cpu().numpy(), diags


class GlobalMCMCSampler:
    """NUTS over the joint density of the graph's factors, on ``device``
    (``cuda`` unless named)."""

    def __init__(self, nodes: Sequence[Variable],
                 factors: Sequence[Factor], device=None, **kwargs) -> None:
        self._nodes = list(nodes)
        self._dim = sum(v.dim for v in nodes)
        self.device = resolve_device(device)
        self.joint = StructuredJointFactor(factors, nodes)

    def sample(self, key=None, num_samples: int = 1000,
               num_warmup: int = 500, num_chains: int = 4,
               init_point: Optional[np.ndarray] = None, **kwargs
               ) -> np.ndarray:
        if key is None:
            key = np.array([0, 11], dtype=np.uint32)
        if init_point is None:
            init_point = self.joint.sample(key, 64, self.device).mean(
                dim=0).cpu().numpy()
        cfg = NUTSConfig(num_samples=num_samples, num_warmup=num_warmup,
                         num_chains=num_chains)
        samples, self.diagnostics = nuts_sample(
            key, self.log_density(), self._dim, init_point, cfg,
            device=self.device)
        return samples

    def log_density(self) -> Callable:
        """(C, dim) -> (C,) joint log density: by factor banks where every
        factor has one, else the joint's ``log_pdf``."""
        from ..solver.banked_joint import FactorBanks, banked_log_density

        banks = FactorBanks()
        offset = {v: idx[0] for v, idx in self.joint.var_to_indices.items()}
        try:
            for f in self.joint.factors:
                banks.add(f, offset)
        except NotImplementedError:
            return self.joint.log_pdf
        on_device = banks.to_device(self.device)
        return lambda q: banked_log_density(q, on_device)
