"""Clique density model: flow stack + sample normalization + base measure.

Counterpart of ``nfisam_tpu/flows/model.py``.  Column convention (as in
the JAX package): ``[augmented observations | separator | frontal]`` in
reverse-elimination order; ``aug_sep_dim`` counts observation plus
separator columns.  Conditional sampling goes through the masked AR
inverse, which runs as the CUDA kernel on CUDA tensors and as its plain
version on CPU tensors (``_select_inverse_fn``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..core.geometry import wrap_angle
from ..utils.keys import torch_generator
from .ar_inverse import stack_inverse_masked_cuda, stack_inverse_masked_plain
from .base_dist import LOG_TWO_PI, BaseDistribution, von_mises_log_prob
from .nsf import (NSFConfig, flow_params_from_numpy, stack_forward,
                  stack_forward_perdim)


# --------------------------------------------------------------------------
# Normalization (circular-aware)
# --------------------------------------------------------------------------
def circular_mean(samples: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Circular mean in [-pi, pi] (scipy.stats.circmean equivalent)."""
    s = torch.mean(torch.sin(samples), dim=dim)
    c = torch.mean(torch.cos(samples), dim=dim)
    return torch.atan2(s, c)


def compute_normalizer(samples: torch.Tensor, circ_mask: torch.Tensor,
                       scale_circular: bool = True):
    """Per-dim (mean, std); circular dims use the circular mean and the
    wrapped residual's std.  ``scale_circular=False`` for the
    circular-spline flow, which lives natively on [-pi, pi]."""
    mean = torch.where(circ_mask, circular_mean(samples),
                       torch.mean(samples, dim=0))
    resid = torch.where(circ_mask, wrap_angle(samples - mean),
                        samples - mean)
    std = torch.std(resid, dim=0, correction=0)
    if not scale_circular:
        std = torch.where(circ_mask, torch.ones_like(std), std)
    return mean, torch.clamp(std, min=1e-5)


def normalize(samples: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              circ_mask: torch.Tensor, init_dim: int = 0) -> torch.Tensor:
    """(x - mean) / std with angle wrapping on circular dims; ``init_dim``
    offsets into the full-clique mean/std for a column block."""
    d = samples.shape[-1]
    m = mean[init_dim:init_dim + d]
    s = std[init_dim:init_dim + d]
    circ = circ_mask[init_dim:init_dim + d]
    resid = torch.where(circ, wrap_angle(samples - m), samples - m)
    return resid / s


def unnormalize(z: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                circ_mask: torch.Tensor, init_dim: int = 0) -> torch.Tensor:
    d = z.shape[-1]
    m = mean[init_dim:init_dim + d]
    s = std[init_dim:init_dim + d]
    circ = circ_mask[init_dim:init_dim + d]
    x = z * s + m
    return torch.where(circ, wrap_angle(x), x)


# --------------------------------------------------------------------------
# Model functions
# --------------------------------------------------------------------------
def model_forward(flow_params: List[dict], x_norm: torch.Tensor,
                  cfg: NSFConfig, base: BaseDistribution):
    """Normalized target samples -> (z, prior_logprob, log_det)."""
    z, log_det = stack_forward(flow_params, x_norm, cfg)
    return z, base.log_prob(z), log_det


def negative_log_likelihood(flow_params: List[dict], x_norm: torch.Tensor,
                            cfg: NSFConfig, base: BaseDistribution):
    _, prior_lp, log_det = model_forward(flow_params, x_norm, cfg, base)
    return -torch.mean(prior_lp + log_det)


def _select_inverse_fn(device: torch.device):
    """The masked AR inverse for tensors on ``device``: the CUDA kernel on
    a card, the plain version on the CPU."""
    if device.type == "cuda":
        return stack_inverse_masked_cuda
    if device.type == "cpu":
        return stack_inverse_masked_plain
    raise ValueError(f"no masked AR inverse for device {device}")


def conditional_draw_core(flow_params, mean, std, circ_mask, z_full, prefix,
                          invert_mask, cfg: NSFConfig, inverse_fn):
    """One conditional draw from base draws ``z_full`` (n, dim): normalize
    the [obs | separator] prefix, zero the dims to invert, run the masked
    AR inverse, unnormalize."""
    x_prefix = normalize(prefix, mean, std, circ_mask, 0)
    x_prefix = torch.where(invert_mask[None, :], torch.zeros_like(x_prefix),
                           x_prefix)
    x_full = inverse_fn(flow_params, z_full, x_prefix, invert_mask, cfg)
    return unnormalize(x_full, mean, std, circ_mask, init_dim=0)


@dataclass
class CliqueFlowModel:
    """One trained clique density model.

    ``aug_sep_dim`` counts [observation + separator] columns; the flow's
    total dim = aug_sep_dim + frontal_dim + pad_dims, where the trailing
    ``pad_dims`` dummy columns bucket clique dims into few flow shapes (the
    AR structure keeps real dims unaffected).
    """
    cfg: NSFConfig
    flow_params: List[dict]
    mean: torch.Tensor         # (dim,)
    std: torch.Tensor          # (dim,)
    circular_dim_list: List[bool]
    aug_sep_dim: int
    pad_dims: int = 0
    # content fingerprint of the trained flow (stamped at training, as in
    # the JAX package): a checkpoint signature of a parent clique reads it
    content_tag: str = ""
    # circular flags of all dim columns (pad columns Euclidean), on device
    circ_mask: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self) -> None:
        flags = list(self.circular_dim_list)
        flags += [False] * (self.cfg.dim - len(flags))
        self.circ_mask = torch.as_tensor(np.asarray(flags, dtype=bool),
                                         device=self.device)

    @classmethod
    def from_numpy(cls, cfg_fields: dict, flow_params, mean, std,
                   circular_dim_list, aug_sep_dim: int, pad_dims: int,
                   device, content_tag: str = "") -> "CliqueFlowModel":
        """A model from parameters exported as numpy (e.g. a clique model
        of the JAX package): ``cfg_fields`` are ``NSFConfig``'s fields."""
        fields = dict(cfg_fields)
        fields["circular"] = tuple(bool(c) for c in fields.get("circular",
                                                               ()))
        return cls(NSFConfig(**fields),
                   flow_params_from_numpy(flow_params, device),
                   torch.tensor(np.asarray(mean, np.float32),
                                device=device),
                   torch.tensor(np.asarray(std, np.float32), device=device),
                   [bool(c) for c in circular_dim_list], int(aug_sep_dim),
                   int(pad_dims), str(content_tag))

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def device(self) -> torch.device:
        return self.mean.device

    @property
    def base(self) -> BaseDistribution:
        return BaseDistribution(self.cfg.circular_mask)

    def with_separator_dim(self, aug_sep_dim: int) -> "CliqueFlowModel":
        """The same density with a different separator/frontal split."""
        return CliqueFlowModel(self.cfg, self.flow_params, self.mean,
                               self.std, self.circular_dim_list, aug_sep_dim,
                               self.pad_dims, self.content_tag)

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=self.device, dtype=torch.float32)
        if x.shape[1] == self.cfg.dim:
            return x
        pad = torch.zeros((x.shape[0], self.cfg.dim - x.shape[1]),
                          dtype=torch.float32, device=self.device)
        return torch.cat([x, pad], dim=1)

    @torch.no_grad()
    def conditional_draw(self, z_full: torch.Tensor,
                         obs_samples: torch.Tensor | None = None
                         ) -> torch.Tensor:
        """Conditional draw from given base draws ``z_full`` (n, dim);
        returns every column from the separator split on (trailing pad
        columns included)."""
        n = z_full.shape[0]
        if obs_samples is None:
            sep_dim = 0
            obs_full = torch.zeros((n, self.cfg.dim), dtype=torch.float32,
                                   device=self.device)
        else:
            sep_dim = obs_samples.shape[1]
            obs_full = self._padded(obs_samples)
        invert_mask = torch.as_tensor(np.arange(self.cfg.dim) >= sep_dim,
                                      device=self.device)
        x_out = conditional_draw_core(
            self.flow_params, self.mean, self.std, self.circ_mask, z_full,
            obs_full, invert_mask, self.cfg, _select_inverse_fn(self.device))
        return x_out[:, sep_dim:]

    def conditional_sample(self, key, num_samples: int,
                           obs_samples: torch.Tensor | None = None
                           ) -> torch.Tensor:
        """Sample frontal dims conditioned on [obs | separator] samples
        (``num_samples`` is used only without ``obs_samples``)."""
        n = num_samples if obs_samples is None else obs_samples.shape[0]
        gen = torch_generator(key, self.device)
        z_full = self.base.sample(gen, n, self.device)
        return self.conditional_draw(z_full, obs_samples)

    @torch.no_grad()
    def separator_forward(self, x_sep: torch.Tensor):
        """Push separator samples through the flow prefix; returns
        (z, separator_prior_logprob, separator_log_det), the separator
        marginal density (the AR prefix property makes the first d columns
        of the full forward self-contained)."""
        return self.separator_forward_differentiable(x_sep)

    def separator_forward_differentiable(self, x_sep: torch.Tensor):
        """``separator_forward`` under the caller's grad mode."""
        d_sep = x_sep.shape[-1]
        x = normalize(self._padded(x_sep), self.mean, self.std, self.circ_mask)
        z, ld_perdim = stack_forward_perdim(self.flow_params, x, self.cfg)
        normal_lp = -0.5 * (z * z + LOG_TWO_PI)
        circ = torch.as_tensor(self.cfg.circular_mask, device=self.device)
        base_lp = torch.where(circ, von_mises_log_prob(z), normal_lp)
        return (z[:, :d_sep], torch.sum(base_lp[:, :d_sep], dim=-1),
                torch.sum(ld_perdim[:, :d_sep], dim=-1))

    @torch.no_grad()
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Joint log density of unnormalized samples (n, dim) (missing pad
        columns are zero-filled; a constant offset for fixed pads)."""
        xn = normalize(self._padded(x), self.mean, self.std, self.circ_mask)
        _, prior_lp, log_det = model_forward(self.flow_params, xn, self.cfg,
                                             self.base)
        return prior_lp + log_det - torch.sum(torch.log(self.std))

    def sample(self, key, num_samples: int) -> torch.Tensor:
        return self.conditional_sample(key, num_samples)
