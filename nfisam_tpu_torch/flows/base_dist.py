"""Base (latent) distributions for the flows.

Counterpart of ``nfisam_tpu/flows/base_dist.py``: a product of standard
normals (Euclidean dims) and von Mises(0, 1) (circular dims, for
``NSF_AR_CS``), as ``log_prob`` and ``sample`` over ``(n, d)`` tensors.
Draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG_TWO_PI = math.log(2.0 * math.pi)
# log I_0(1): modified Bessel of the first kind at the fixed concentration 1
_LOG_I0_1 = float(np.log(np.i0(1.0)))
_VM_KAPPA = 1.0


def normal_log_prob(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal log density summed over the last axis."""
    return -0.5 * torch.sum(z * z + LOG_TWO_PI, dim=-1)


def von_mises_log_prob(theta: torch.Tensor) -> torch.Tensor:
    """von Mises(0, kappa=1) log density, elementwise."""
    return _VM_KAPPA * torch.cos(theta) - LOG_TWO_PI - _LOG_I0_1


def von_mises_sample(gen: torch.Generator, shape, device,
                     rounds: int = 16) -> torch.Tensor:
    """Best-Fisher rejection sampling with a fixed number of masked rounds
    (acceptance ~66% a round at kappa=1, so the chance that an element is
    still rejected after 16 rounds is ~1e-8; those keep a uniform draw on
    [-pi, pi))."""
    kappa = _VM_KAPPA
    tau = 1.0 + np.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - np.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = float((1.0 + rho * rho) / (2.0 * rho))

    vals = -math.pi + 2.0 * math.pi * torch.rand(shape, generator=gen,
                                                 device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(rounds):
        u1 = torch.rand(shape, generator=gen, device=device)
        u2 = torch.rand(shape, generator=gen, device=device)
        u3 = torch.rand(shape, generator=gen, device=device)
        z = torch.cos(math.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / u2) + 1.0 - c >= 0)
        theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
        vals = torch.where(accept & ~accepted, theta, vals)
        accepted = accepted | accept
    return vals


class BaseDistribution:
    """Product of standard normals and von Mises per a circular mask."""

    def __init__(self, circular_mask):
        self.circular_mask = np.asarray(circular_mask, dtype=bool)
        self.dim = int(self.circular_mask.shape[0])
        self._any_circular = bool(self.circular_mask.any())
        self._masks: dict = {}

    def _mask(self, device) -> torch.Tensor:
        """The circular mask on ``device``, copied there once (a log
        density replayed from a CUDA graph copies nothing from the
        host)."""
        if device not in self._masks:
            self._masks[device] = torch.as_tensor(self.circular_mask,
                                                  device=device)
        return self._masks[device]

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        if not self._any_circular:
            return normal_log_prob(z)
        normal_term = -0.5 * (z * z + LOG_TWO_PI)
        return torch.sum(torch.where(self._mask(z.device),
                                     von_mises_log_prob(z), normal_term),
                         dim=-1)

    def sample(self, gen: torch.Generator, n: int, device) -> torch.Tensor:
        normal = torch.randn((n, self.dim), generator=gen, device=device)
        if not self._any_circular:
            return normal
        vm = von_mises_sample(gen, (n, self.dim), device)
        return torch.where(self._mask(device), vm, normal)
