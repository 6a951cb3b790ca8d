"""MAP + Laplace-marginal baseline solver.

Counterpart of ``nfisam_tpu/solver/map_solver.py`` (the role of the
reference's GTSAM harness, ``gtsam_solution.cpp``: nonlinear least squares
by Levenberg-Marquardt, Gaussian samples from the marginals).  The density
is the joint of ``StructuredJointFactor`` over the given nodes; the
negative log joint is evaluated through the factor banks of
``banked_joint.py`` (the same terms as ``StructuredJointFactor.log_pdf``,
one gather a factor type instead of one call a factor: ~150 operations
instead of ~10k on a 272-factor graph), its gradient and dense Hessian
come from ``torch.func``, and the damped-Newton loop runs eagerly on the
solver's device (``cuda`` unless the caller names another), with one host
read of the accept/stop flags an iteration.  Mixture factors contribute
through their smooth log-sum-exp density.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.variables import Variable
from ..factors.factors import Factor
from ..samplers.joint import StructuredJointFactor
from ..utils.device import resolve_device
from ..utils.keys import torch_generator
from .banked_joint import FactorBanks, _banked_nll

# the JAX package's MAPConfig defaults (no caller sets another): LM
# iterations, the damping's start and its factors on an accepted / a
# rejected step, and the relative NLL change that stops a solve
LAPLACE_MAX_ITERS = 100
LAPLACE_INIT_DAMPING = 1e-4
LAPLACE_DAMPING_DOWN = 0.1
LAPLACE_DAMPING_UP = 10.0
LAPLACE_TOL = 1e-8


class GaussNewtonMAP:
    """Levenberg-Marquardt MAP with Laplace (inverse-Hessian) marginals."""

    def __init__(self, nodes: Sequence[Variable],
                 factors: Sequence[Factor], device=None) -> None:
        self.nodes = list(nodes)
        self.device = resolve_device(device)
        self.joint = StructuredJointFactor(factors, nodes)
        self.dim = self.joint.dim
        offset = {v: idx[0] for v, idx in self.joint.var_to_indices.items()}
        banks = FactorBanks()
        for f in factors:
            banks.add(f, offset)
        self._banks = banks.to_device(self.device)

    def _neg_logp(self, x: torch.Tensor) -> torch.Tensor:
        """Negative log joint density of the stacked state (dim,)."""
        return _banked_nll(x, self._banks)

    def _lm(self, x: torch.Tensor):
        """The LM loop: each iteration solves ``(H + lam diag(H)) dx = -g``
        (diag clipped below at 1e-9), accepts the step if it lowers the
        NLL (then lam *= LAPLACE_DAMPING_DOWN, else *= LAPLACE_DAMPING_UP,
        clipped to [1e-12, 1e8]), and stops when an accepted step changes
        the NLL by less than ``LAPLACE_TOL (1 + |f|)`` or after
        ``LAPLACE_MAX_ITERS`` iterations.  A
        rejected step leaves x as it was, so the gradient and Hessian of
        the last accepted point are reused, not recomputed."""
        grad_fn = torch.func.grad(self._neg_logp)

        def hess_fn(x):
            # (functorch's hessian can come back in float64 where an SE(2)
            # residual's angle is exactly 0)
            return torch.func.hessian(self._neg_logp)(x).to(x.dtype)

        lam = torch.tensor(LAPLACE_INIT_DAMPING, dtype=x.dtype,
                           device=x.device)
        f_val = self._neg_logp(x)
        g = H = None
        it = 0
        while it < LAPLACE_MAX_ITERS:
            if g is None:
                g, H = grad_fn(x), hess_fn(x)
            diag = torch.clamp(torch.diagonal(H), min=1e-9)
            dx = -torch.linalg.solve(H + lam * torch.diag(diag), g)
            x_new = x + dx
            f_new = self._neg_logp(x_new)
            better = f_new < f_val
            done = better & (torch.abs(f_val - f_new) <
                             LAPLACE_TOL * (1.0 + torch.abs(f_val)))
            lam = torch.clamp(torch.where(better, lam * LAPLACE_DAMPING_DOWN,
                                          lam * LAPLACE_DAMPING_UP),
                              1e-12, 1e8)
            it += 1
            better, done = (bool(b) for b in torch.stack([better, done]))
            if better:
                x, f_val, g = x_new, f_new, None
            if done:
                break
        H = hess_fn(x)
        cov = torch.linalg.inv(H + 1e-9 * torch.eye(
            self.dim, dtype=x.dtype, device=x.device))
        return x, cov, f_val, it

    def solve(self, x0: Optional[np.ndarray] = None,
              key=None, timer: Optional[List[float]] = None):
        """Returns (map_point, laplace_cov, final_nll, iters).  Without
        ``x0`` the start is the best of 512 ancestral draws by joint
        density (the ancestral mean of a range-only landmark sits at its
        ring's centre)."""
        if x0 is None:
            key = key if key is not None else np.array([0, 17],
                                                       dtype=np.uint32)
            with torch.no_grad():
                draws = self.joint.sample(key, 512, self.device)
                x0 = draws[int(torch.argmax(self.joint.log_pdf(draws)))]
        t0 = time.time()
        x, cov, f_val, it = self._lm(torch.as_tensor(
            np.asarray(x0, np.float32) if not torch.is_tensor(x0) else x0,
            dtype=torch.float32, device=self.device))
        self.map_point = x.cpu().numpy()
        self.laplace_cov = cov.cpu().numpy()
        if timer is not None:
            timer.append(time.time() - t0)
        self.final_nll = float(f_val)
        self.iterations = it
        return self.map_point, self.laplace_cov, self.final_nll, \
            self.iterations

    def sample(self, key, num_samples: int) -> np.ndarray:
        """Gaussian samples from the Laplace approximation, drawn with a
        ``torch.Generator`` seeded from ``key`` on the solver's device."""
        if not hasattr(self, "map_point"):
            self.solve()
        # eigenvalue clipping keeps sampling well-defined when the MAP sits
        # on a degenerate direction (e.g. unobserved heading)
        w, V = np.linalg.eigh(0.5 * (self.laplace_cov +
                                     self.laplace_cov.T))
        L = V * np.sqrt(np.clip(w, 1e-12, None))
        z = torch.randn((num_samples, self.dim),
                        generator=torch_generator(key, self.device),
                        device=self.device).cpu().numpy()
        return self.map_point + z @ L.T

    def results(self) -> Dict[Variable, np.ndarray]:
        out: Dict[Variable, np.ndarray] = {}
        for v in self.nodes:
            out[v] = self.map_point[np.asarray(
                self.joint.var_to_indices[v])]
        return out
