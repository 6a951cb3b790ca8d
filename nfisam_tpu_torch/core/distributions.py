"""The Gaussian densities the factors and the oracles use.

Counterparts of ``nfisam_tpu/core/distributions.py``: the symmetric SPD
square root that colours unit-normal noise, the standard-normal inverse
CDF that maps uniform-cube samples, the whitened-residual log density,
the multivariate normal and the ring (Gaussian radius around a centre,
uniform angle).  Parameters are host numpy float64, as in the JAX
package; every density and draw is a batched float32 tensor op on its
input's device, and a draw takes a raw host key through a
``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.keys import torch_generator

LOG_TWO_PI = math.log(2.0 * math.pi)


def spd_sqrt(mat: np.ndarray) -> np.ndarray:
    """Symmetric square root of an SPD matrix (host-side, tiny)."""
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def norm_ppf(u: torch.Tensor) -> torch.Tensor:
    """Standard-normal inverse CDF, elementwise."""
    return torch.special.ndtri(u)


def gaussian_log_pdf(delta: torch.Tensor, prec_chol: torch.Tensor,
                     log_norm: float) -> torch.Tensor:
    """log N(delta; 0, Sigma) with ``prec_chol = chol(Sigma^{-1})``;
    delta (n, d) -> (n,)."""
    white = delta @ prec_chol
    return log_norm - 0.5 * torch.sum(white * white, dim=-1)


def gaussian_grad_log_pdf(x: torch.Tensor, mu: torch.Tensor,
                          precision: torch.Tensor) -> torch.Tensor:
    """d/dx log N(x; mu, Sigma) = -(x - mu) Sigma^{-1}; x (n, d)."""
    return -(x - mu) @ precision.T


def gaussian_rvs(key, mu: torch.Tensor, cov_sqrt: torch.Tensor,
                 n: int) -> torch.Tensor:
    """n draws of N(mu, cov_sqrt cov_sqrt^T) on ``mu``'s device."""
    gen = torch_generator(key, mu.device)
    z = torch.randn((n, mu.shape[-1]), generator=gen, device=mu.device)
    return z @ cov_sqrt.T + mu


class HostConstants:
    """Numpy float64 parameters used as float32 tensors."""

    def _const(self, name: str, device) -> torch.Tensor:
        """Float32 copy of the numpy attribute ``name`` on ``device``,
        made once per device: a host-to-device copy per call would
        synchronise the stream."""
        cache = self.__dict__.setdefault("_tensor_cache", {})
        key = (name, str(device))
        t = cache.get(key)
        if t is None:
            t = cache[key] = torch.as_tensor(
                np.asarray(getattr(self, name), dtype=np.float32),
                device=device)
        return t


class GaussianDistribution(HostConstants):
    """Multivariate normal: ``cov_sqrt`` is the symmetric SPD square root,
    ``prec_chol`` the Cholesky factor of the precision."""

    def __init__(self, mu: np.ndarray, sigma: np.ndarray | None = None,
                 precision: np.ndarray | None = None):
        mu = np.asarray(mu, dtype=np.float64).reshape(-1)
        if sigma is not None:
            sigma = np.asarray(sigma, dtype=np.float64)
            precision = np.linalg.inv(sigma)
        elif precision is not None:
            precision = np.asarray(precision, dtype=np.float64)
            sigma = np.linalg.inv(precision)
        else:
            raise ValueError("Need sigma or precision")
        self.mu = mu
        self.sigma = sigma
        self.precision = precision
        self.cov_sqrt = spd_sqrt(sigma)
        self.prec_chol = np.linalg.cholesky(precision)
        self.log_norm = -0.5 * (mu.shape[0] * LOG_TWO_PI +
                                np.log(np.linalg.det(sigma)))

    @property
    def dim(self) -> int:
        return self.mu.shape[0]

    @property
    def mean(self) -> np.ndarray:
        return self.mu

    @property
    def covariance(self) -> np.ndarray:
        return self.sigma

    def rvs(self, key, num_samples: int, device) -> torch.Tensor:
        return gaussian_rvs(key, self._const("mu", device),
                            self._const("cov_sqrt", device), num_samples)

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        return gaussian_log_pdf(x - self._const("mu", x.device),
                                self._const("prec_chol", x.device),
                                float(self.log_norm))

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_pdf(x))

    def grad_x_log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        return gaussian_grad_log_pdf(x, self._const("mu", x.device),
                                     self._const("precision", x.device))

    def unif_to_sample(self, u: torch.Tensor) -> torch.Tensor:
        """Uniform-cube samples through the Gaussian inverse CDF."""
        return norm_ppf(u) @ self._const("cov_sqrt", u.device).T + \
            self._const("mu", u.device)


class GaussianRangeDistribution(HostConstants):
    """Ring-shaped density: Gaussian radius (``variance``) around
    ``center``, uniform angle."""

    def __init__(self, center: np.ndarray, mu: float, variance: float):
        self.center = np.asarray(center, dtype=np.float64).reshape(-1)
        self.mu = float(mu)
        self.variance = float(variance)
        self.sigma_sqrt = float(np.sqrt(variance))

    @property
    def dim(self) -> int:
        return self.center.shape[0]

    @property
    def mean(self) -> float:
        return self.mu

    @property
    def covariance(self) -> float:
        return self.variance

    def _ring(self, r: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
        return self._const("center", r.device) + torch.stack(
            [r * torch.cos(ang), r * torch.sin(ang)], dim=-1)

    def rvs(self, key, num_samples: int, device) -> torch.Tensor:
        gen = torch_generator(key, device)
        r = self.mu + self.sigma_sqrt * torch.randn(
            num_samples, generator=gen, device=device)
        ang = -math.pi + 2 * math.pi * torch.rand(
            num_samples, generator=gen, device=device)
        return self._ring(r, ang)

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Unnormalised in angle (as the factors use it)."""
        r = torch.linalg.vector_norm(x - self._const("center", x.device),
                                     dim=-1)
        return (-0.5 * (r - self.mu) ** 2 / self.variance
                - 0.5 * (LOG_TWO_PI + math.log(self.variance)))

    def unif_to_sample(self, u: torch.Tensor) -> torch.Tensor:
        r = self.sigma_sqrt * norm_ppf(u[..., 0]) + self.mu
        return self._ring(r, (u[..., 1] - 0.5) * 2.0 * math.pi)
