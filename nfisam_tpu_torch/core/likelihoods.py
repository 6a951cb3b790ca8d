"""Standalone log-likelihood objects.

Counterpart of ``nfisam_tpu/core/likelihoods.py``: the evaluate / grad_x
protocol over batched ``(n, dim)`` tensors, for code that wants a
likelihood as a first-class object; gradients come from ``torch.func``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .distributions import LOG_TWO_PI, GaussianDistribution


class LogLikelihood:
    """y | x likelihood protocol."""

    def __init__(self, y) -> None:
        self._y = np.asarray(y, dtype=np.float64).reshape(-1)

    @property
    def y(self) -> np.ndarray:
        return self._y

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def grad_x(self, x: torch.Tensor) -> torch.Tensor:
        return torch.func.vmap(torch.func.grad(
            lambda row: self.evaluate(row[None])[0]))(x)


class GaussianRangeLogLikelihood(LogLikelihood):
    """log N(|x_a - x_b| ; distance, variance) over stacked (x_a, x_b)."""

    def __init__(self, distance: float, dim: int, variance: float) -> None:
        if distance < 0 or dim <= 0 or variance <= 0:
            raise ValueError("distance/dim/variance must be positive")
        super().__init__(np.array([distance]))
        self.dim = dim
        self.variance = float(variance)

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        d = torch.linalg.vector_norm(x[:, :half] - x[:, half:], dim=1)
        delta = d - float(self._y[0])
        return (-0.5 * delta ** 2 / self.variance
                - 0.5 * (LOG_TWO_PI + math.log(self.variance)))


class GaussianMixtureLogLikelihood(LogLikelihood):
    """Mixture of additive-Gaussian likelihoods y = T_k x + noise_k."""

    def __init__(self, y, weights: Sequence[float],
                 transforms: Sequence[np.ndarray],
                 covariances: Sequence[np.ndarray]) -> None:
        super().__init__(y)
        w = np.asarray(weights, dtype=np.float64)
        self.weights = w / w.sum()
        self.transforms = [np.asarray(t, dtype=np.float64)
                           for t in transforms]
        self.noises = [GaussianDistribution(np.zeros(t.shape[0]), c)
                       for t, c in zip(self.transforms, covariances)]

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.as_tensor(self._y.astype(np.float32), device=x.device)
        comps = []
        for w, T, noise in zip(self.weights, self.transforms, self.noises):
            T = torch.as_tensor(T.astype(np.float32), device=x.device)
            comps.append(noise.log_pdf(y - x @ T.T) + math.log(w))
        return torch.logsumexp(torch.stack(comps, -1), dim=-1)


class GaussianDisplacementDistribution:
    """Density of x_b = x_a + mu + noise over stacked (x_a, x_b)."""

    def __init__(self, mu, sigma) -> None:
        self.mu = np.asarray(mu, dtype=np.float64).reshape(-1)
        self.noise = GaussianDistribution(np.zeros(self.mu.shape[0]),
                                          np.asarray(sigma))

    @property
    def dim(self) -> int:
        return 2 * self.mu.shape[0]

    def _delta(self, x: torch.Tensor) -> torch.Tensor:
        half = self.mu.shape[0]
        mu = torch.as_tensor(self.mu.astype(np.float32), device=x.device)
        return x[:, half:] - x[:, :half] - mu

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.noise.log_pdf(self._delta(x))

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_pdf(x))

    def grad_x_log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        g = self.noise.grad_x_log_pdf(self._delta(x))
        return torch.cat([-g, g], dim=-1)

    def rvs(self, key, num_samples: int, x_a=None) -> torch.Tensor:
        if x_a is None:
            raise ValueError("conditional distribution: need x_a")
        mu = torch.as_tensor(self.mu.astype(np.float32), device=x_a.device)
        return x_a + mu + self.noise.rvs(key, num_samples, x_a.device)
