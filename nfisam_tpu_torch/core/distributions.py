"""The Gaussian pieces the case1 factors use.

Counterparts of ``nfisam_tpu/core/distributions.py``: the symmetric SPD
square root that colours unit-normal noise, the standard-normal inverse
CDF that maps uniform-cube samples, and the whitened-residual log density.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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
