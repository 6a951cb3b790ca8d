"""Factor library over batched tensors.

Counterpart of ``nfisam_tpu/factors/factors.py``: Gaussian, ring and
SE(2) wrapped-Gaussian priors (and the SE(2) mixture prior), R^2 and
SE(2) odometry (and slip/grip odometry), bearing, and the Gaussian range
factors between R^2 and SE(2) variables.  Numeric methods take ``(n, d)``
tensors and compute in float32 on the tensors' device; sampling takes a
raw host key and draws from a ``torch.Generator`` seeded with it on that
device.  The ``.fg`` grammar is the JAX package's, dispatched through a
registry: a line naming a type that is not registered raises.  Two types
have no text form in either package: the JAX package's mixture prior
prints no weights, and its slip/grip factor prints nothing.

Gradients (``grad_x_log_pdf``) exist where the JAX package has them: the
hand-derived ones by the same formula, the others through
``torch.autograd.grad`` of the sum over rows (the rows decouple), as the
JAX package's ``jax.grad``.  ``loglike_rows`` is ``evaluate_loglike`` for
every row of an ``(n, d)`` batch, with the same per-row rule.
"""
from __future__ import annotations

import math
from abc import ABC
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..core import geometry as geom
from ..core.distributions import (LOG_TWO_PI, GaussianDistribution,
                                  GaussianRangeDistribution, HostConstants,
                                  gaussian_grad_log_pdf, gaussian_log_pdf,
                                  norm_ppf, spd_sqrt)
from ..core.variables import (Bearing2DVariable, R1Variable, R2Variable,
                              SE2Variable, Variable, VariableType,
                              circular_dim_list)
from ..utils.keys import torch_generator

_TWO_PI = 2.0 * math.pi

FACTOR_REGISTRY: Dict[str, type] = {}


def _se2_inverse_np(pose: np.ndarray) -> np.ndarray:
    """Host-side SE(2) inverse for factor construction."""
    x, y, th = float(pose[0]), float(pose[1]), float(pose[2])
    c, si = np.cos(th), np.sin(th)
    return np.array([-(c * x + si * y), -(-si * x + c * y),
                     float((-th + np.pi) % (2 * np.pi) - np.pi)])


def register_factor(cls):
    FACTOR_REGISTRY[cls.__name__] = cls
    return cls


class UnknownVariableError(KeyError):
    """A factor line references a variable that has not been declared."""


class _NameLookup(dict):
    """name -> Variable map that raises UnknownVariableError on misses."""

    def __missing__(self, key):
        raise UnknownVariableError(key)


def vars_by_name(variables: Iterable[Variable]) -> "_NameLookup":
    return _NameLookup({v.name: v for v in variables})


def _tokens(cls, line: str) -> List[str]:
    """The tokens of a factor line of class ``cls``."""
    tok = line.strip().split()
    if tok[0] != cls.__name__:
        raise ValueError(f"not a {cls.__name__} line: {line!r}")
    return tok


def value_and_grad_rows(fn, x: torch.Tensor):
    """(fn(x), its gradient at every row of ``x`` (n, d)) for a rowwise
    ``fn``: the gradient of its sum over rows, the rows being
    independent."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        val = fn(x)
        (g,) = torch.autograd.grad(val.sum(), x)
    return val.detach(), g


def grad_rows(log_density, x: torch.Tensor) -> torch.Tensor:
    """The gradient of a rowwise log density at every row of ``x``."""
    return value_and_grad_rows(log_density, x)[1]


def _uniform(gen: torch.Generator, shape, low: float, high: float,
             device) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen,
                                           device=device)


# ==========================================================================
# Base protocol
# ==========================================================================
class Factor(HostConstants, ABC):
    """Abstract factor."""

    @property
    def vars(self) -> List[Variable]:
        raise NotImplementedError

    @property
    def dim(self) -> int:
        return sum(v.dim for v in self.vars)

    @property
    def circular_dim_list(self) -> List[bool]:
        return circular_dim_list(self.vars)

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_ancestral_density(self, x: torch.Tensor,
                              var1_sampled: bool = True) -> torch.Tensor:
        """Log density of the measure ``sample`` / ``unif_to_sample`` draw
        from when this factor is an ancestral (tree) edge: ``log_pdf``,
        but for the ring-drawn range factors."""
        return self.log_pdf(x)

    def grad_x_log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no gradient (nor in the JAX "
            f"package)")

    def loglike_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n,): ``evaluate_loglike`` of every row."""
        return self.log_pdf(x)

    def evaluate_loglike(self, x: torch.Tensor) -> torch.Tensor:
        """Log-likelihood at one flattened location ``x`` (dim,)."""
        return self.loglike_rows(x.reshape(1, -1))[0]

    # ---------------------------------------------------------------- text
    @classmethod
    def construct_from_text(cls, line: str, variables: Iterable[Variable]
                            ) -> "Factor":
        tok = line.strip().split()
        if tok[0] == "Factor":
            tok = tok[1:]
        klass = FACTOR_REGISTRY.get(tok[0])
        if klass is None:
            raise ValueError(f"Unknown factor type {tok[0]}")
        return klass.construct_from_text(" ".join(tok), variables)

    def __str__(self) -> str:
        raise NotImplementedError


class UnaryFactor(Factor, ABC):
    @property
    def var(self) -> Variable:
        return self.vars[0]


class BinaryFactor(Factor, ABC):
    @property
    def var1(self) -> Variable:
        return self.vars[0]

    @property
    def var2(self) -> Variable:
        return self.vars[1]


class UndefinedFactor(Factor):
    """Fill-in edge created during symbolic elimination."""

    def __init__(self, vars: List[Variable]) -> None:
        self._vars = list(vars)

    @property
    def vars(self) -> List[Variable]:
        return self._vars

    def __str__(self) -> str:
        return "Factor UndefinedFactor " + " ".join(
            str(v.name) for v in self._vars)


class PriorFactor(Factor, ABC):
    """Factor that can be sampled unconditionally."""

    def sample(self, key, num_samples: int, device) -> torch.Tensor:
        raise NotImplementedError

    def unif_to_sample(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class LikelihoodFactor(Factor, ABC):
    """Conditional factor with an observation."""

    @property
    def observation(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def observation_var(self) -> Variable:
        raise NotImplementedError

    def sample(self, key, var1=None, var2=None) -> torch.Tensor:
        """Directional sampling: given var1 draw var2; given var2 draw
        var1; given both draw the observation."""
        raise NotImplementedError


class ImplicitPriorFactor(PriorFactor, ABC):
    """Prior without closed-form density (e.g. learned flows)."""


# ==========================================================================
# SE(2) wrapped-Gaussian prior
# ==========================================================================
def _se2_wrapped_log_pdf(dT: torch.Tensor, prec_chol: torch.Tensor,
                         log_norm: float) -> torch.Tensor:
    """Exp-map Gaussian density of the SE(2) residual ``dT``, with the
    log-det-Jacobian of the log map."""
    v = geom.se2_log(dT)
    det_jac = torch.abs(geom.se2_det_grad_logmap(dT))
    return gaussian_log_pdf(v, prec_chol, log_norm) + torch.log(det_jac)


class _SE2GaussianNoise:
    """Covariance bookkeeping shared by the two SE(2) Gaussian factors."""

    def _set_covariance(self, covariance) -> None:
        self.covariance = np.asarray(covariance, dtype=np.float64)
        self.precision = np.linalg.inv(self.covariance)
        self.cov_sqrt = spd_sqrt(self.covariance)
        self.prec_chol = np.linalg.cholesky(self.precision)
        self.log_norm = -0.5 * (3 * LOG_TWO_PI +
                                np.log(np.linalg.det(self.covariance)))

    def _noise(self, z: torch.Tensor) -> torch.Tensor:
        """SE(2) noise element from unit-normal draws z (n, 3)."""
        return geom.se2_exp(z @ self._const("cov_sqrt", z.device).T)


@register_factor
class UnarySE2ApproximateGaussianPriorFactor(_SE2GaussianNoise, PriorFactor,
                                             UnaryFactor):
    """SE(2) prior with exp-map Gaussian noise and a log-det-Jacobian
    corrected density."""

    def __init__(self, var: Variable, prior_pose, covariance,
                 correlated_R_t: bool = True):
        self._vars = [var]
        self.prior_pose = np.asarray(prior_pose, dtype=np.float64).reshape(3)
        self.inv_prior = _se2_inverse_np(self.prior_pose)
        self._set_covariance(covariance)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.prior_pose

    def _from_normal(self, z: torch.Tensor) -> torch.Tensor:
        pose = self._const("prior_pose", z.device).expand(z.shape[0], 3)
        return geom.se2_compose(pose, self._noise(z))

    def sample(self, key, num_samples, device):
        gen = torch_generator(key, device)
        return self._from_normal(torch.randn((num_samples, 3), generator=gen,
                                             device=device))

    def unif_to_sample(self, u):
        squeeze = u.ndim == 1
        out = self._from_normal(norm_ppf(torch.atleast_2d(u)))
        return out[0] if squeeze else out

    def log_pdf(self, x):
        inv = self._const("inv_prior", x.device).expand(x.shape[0], 3)
        return _se2_wrapped_log_pdf(geom.se2_compose(inv, x),
                                    self._const("prec_chol", x.device),
                                    float(self.log_norm))

    def grad_x_log_pdf(self, x):
        return grad_rows(self.log_pdf, x)

    def __str__(self):
        vals = [str(self.vars[0].name)] + [str(v) for v in self.prior_pose] + \
            ["covariance"] + [str(v) for v in self.covariance.reshape(-1)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        pose = np.array([float(tok[2]), float(tok[3]), float(tok[4])])
        mat = np.array([float(t) for t in tok[6:15]]).reshape(3, 3)
        if tok[5] == "covariance":
            cov = mat
        elif tok[5] == "information":
            cov = np.linalg.inv(mat)
        else:
            raise ValueError("covariance or information expected")
        return cls(n2v[tok[1]], pose, cov)


# ==========================================================================
# R^2 Gaussian prior
# ==========================================================================
@register_factor
class UnaryR2GaussianPriorFactor(PriorFactor, UnaryFactor):
    """Gaussian prior on an R^2 variable (e.g. a landmark's position)."""

    def __init__(self, var: Variable, mu, covariance=None, precision=None):
        self._vars = [var]
        self.mu = np.asarray(mu, dtype=np.float64).reshape(2)
        if covariance is not None:
            self.covariance = np.asarray(covariance, dtype=np.float64)
            self.precision = np.linalg.inv(self.covariance)
        elif precision is not None:
            self.precision = np.asarray(precision, dtype=np.float64)
            self.covariance = np.linalg.inv(self.precision)
        else:
            raise ValueError("need a covariance or a precision")
        self.cov_sqrt = spd_sqrt(self.covariance)
        self.prec_chol = np.linalg.cholesky(self.precision)
        self.log_norm = -0.5 * (2 * LOG_TWO_PI +
                                np.log(np.linalg.det(self.covariance)))

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.mu

    def _from_normal(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self._const("cov_sqrt", z.device).T + \
            self._const("mu", z.device)

    def sample(self, key, num_samples, device):
        gen = torch_generator(key, device)
        return self._from_normal(torch.randn((num_samples, 2), generator=gen,
                                             device=device))

    def unif_to_sample(self, u):
        squeeze = u.ndim == 1
        out = self._from_normal(norm_ppf(torch.atleast_2d(u)))
        return out[0] if squeeze else out

    def log_pdf(self, x):
        return gaussian_log_pdf(x - self._const("mu", x.device),
                                self._const("prec_chol", x.device),
                                float(self.log_norm))

    def grad_x_log_pdf(self, x):
        return gaussian_grad_log_pdf(x, self._const("mu", x.device),
                                     self._const("precision", x.device))

    def __str__(self):
        c = self.covariance
        vals = [str(self.vars[0].name), str(self.mu[0]), str(self.mu[1]),
                "covariance", str(c[0, 0]), str(c[0, 1]), str(c[1, 0]),
                str(c[1, 1])]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        mu = np.array([float(tok[2]), float(tok[3])])
        mat = np.array([float(t) for t in tok[5:9]]).reshape(2, 2)
        if tok[4] == "covariance":
            return cls(n2v[tok[1]], mu, covariance=mat)
        if tok[4] == "precision":
            return cls(n2v[tok[1]], mu, precision=mat)
        raise ValueError("covariance or precision expected")


# ==========================================================================
# SE(2) relative odometry
# ==========================================================================
@register_factor
class SE2RelativeGaussianLikelihoodFactor(_SE2GaussianNoise,
                                          LikelihoodFactor, BinaryFactor):
    """SE(2) odometry with wrapped-Gaussian (exp-map) noise."""

    measurement_dim = 3

    def __init__(self, var1, var2, observation, covariance,
                 correlated_R_t: bool = True):
        self._vars = [var1, var2]
        self.obs = np.asarray(observation, dtype=np.float64).reshape(3)
        self.inv_obs = _se2_inverse_np(self.obs)
        self._set_covariance(covariance)
        self._obs_var = SE2Variable(name=f"O{var1.name}{var2.name}",
                                    variable_type=VariableType.Measurement)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.obs

    @property
    def observation_var(self):
        return self._obs_var

    def _noised_obs(self, z: torch.Tensor) -> torch.Tensor:
        obs = self._const("obs", z.device).expand(z.shape[0], 3)
        return geom.se2_compose(obs, self._noise(z))

    def sample(self, key, var1=None, var2=None):
        if var1 is None and var2 is None:
            raise ValueError("need samples of at least one variable")
        ref = var1 if var1 is not None else var2
        gen = torch_generator(key, ref.device)
        z = torch.randn(ref.shape, generator=gen, device=ref.device)
        if var1 is None:
            return geom.se2_compose(var2, geom.se2_inverse(
                self._noised_obs(z)))
        if var2 is None:
            return geom.se2_compose(var1, self._noised_obs(z))
        return geom.se2_compose(geom.se2_between(var1, var2),
                                self._noise(z))

    def unif_to_sample(self, u, var1=None, var2=None):
        if var1 is None and var2 is None:
            raise ValueError("need one var")
        squeeze = u.ndim == 1
        T_ij = self._noised_obs(norm_ppf(torch.atleast_2d(u)))
        if var1 is None:
            out = geom.se2_compose(torch.atleast_2d(var2),
                                   geom.se2_inverse(T_ij))
        else:
            out = geom.se2_compose(torch.atleast_2d(var1), T_ij)
        return out[0] if squeeze else out

    def log_pdf(self, x):
        rel = geom.se2_between(x[:, :3], x[:, 3:])
        inv = self._const("inv_obs", x.device).expand(rel.shape)
        return _se2_wrapped_log_pdf(geom.se2_compose(inv, rel),
                                    self._const("prec_chol", x.device),
                                    float(self.log_norm))

    def grad_x_log_pdf(self, x):
        return grad_rows(self.log_pdf, x)

    def __str__(self):
        vals = [str(self.var1.name), str(self.var2.name)] + \
            [str(v) for v in self.obs] + ["covariance"] + \
            [str(v) for v in self.covariance.reshape(-1)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        obs = np.array([float(tok[3]), float(tok[4]), float(tok[5])])
        mat = np.array([float(t) for t in tok[7:16]]).reshape(3, 3)
        if tok[6] == "information":
            mat = np.linalg.inv(mat)
        return cls(n2v[tok[1]], n2v[tok[2]], obs, mat)


# ==========================================================================
# Range factors
# ==========================================================================
class _RangeFactorBase(LikelihoodFactor, BinaryFactor):
    """Gaussian range between the translation blocks of two variables
    (each starts at column 0 of its variable)."""

    measurement_dim = 1

    def __init__(self, var1, var2, observation, sigma=1.0):
        self._vars = [var1, var2]
        self.obs = (np.asarray(observation, dtype=np.float64).reshape(1)
                    if not np.isscalar(observation)
                    else np.array([float(observation)]))
        self.sigma = float(sigma)
        self.variance = sigma ** 2
        self._obs_var = R1Variable(name=f"O{var1.name}{var2.name}",
                                   variable_type=VariableType.Measurement)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.obs

    @property
    def observation_var(self):
        return self._obs_var

    def sample(self, key, var1=None, var2=None):
        """Ring draw around the known endpoint: Gaussian radius, uniform
        angle, and a uniform heading when the drawn endpoint is SE(2);
        with both endpoints known, a noisy range observation."""
        if var1 is None and var2 is None:
            raise ValueError("need samples of at least one variable")
        ref = var1 if var1 is not None else var2
        n, device = ref.shape[0], ref.device
        gen = torch_generator(key, device)
        if var1 is not None and var2 is not None:
            noise = self.sigma * torch.randn((n, 1), generator=gen,
                                             device=device)
            return torch.linalg.vector_norm(
                var2[:, :2] - var1[:, :2], dim=1, keepdim=True) + noise
        target = self.var2 if var2 is None else self.var1
        dist = float(self.obs[0]) + self.sigma * torch.randn(
            (n, 1), generator=gen, device=device)
        ang = _uniform(gen, (n, 1), -math.pi, math.pi, device)
        xy = ref[:, :2] + torch.cat([dist * torch.cos(ang),
                                     dist * torch.sin(ang)], dim=-1)
        if target.dim != 3:
            return xy
        heading = _uniform(gen, (n, 1), -math.pi, math.pi, device)
        return torch.cat([xy, heading], dim=-1)

    def unif_to_sample(self, u, var1=None, var2=None):
        """Supports both a single ``(du,)`` draw and batched ``(n, du)``."""
        if var1 is None and var2 is None:
            raise ValueError("need one var")
        squeeze = u.ndim == 1
        u = torch.atleast_2d(u)
        dist = self.sigma * norm_ppf(u[:, 0]) + float(self.obs[0])
        ang = (u[:, 1] - 0.5) * _TWO_PI
        shift = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang)],
                            dim=-1)
        src = torch.atleast_2d(var2 if var1 is None else var1)
        target = self.var1 if var1 is None else self.var2
        xy = src[:, :2] + shift
        if target.dim == 2:
            out = xy
        else:
            heading = (u[:, 2] - 0.5) * _TWO_PI
            out = torch.cat([xy, heading[:, None]], dim=-1)
        return out[0] if squeeze else out

    def log_pdf(self, x):
        d1 = self.var1.dim
        delta = (torch.linalg.vector_norm(x[:, d1:d1 + 2] - x[:, :2], dim=1)
                 - float(self.obs[0]))
        return (-0.5 * delta ** 2 / self.variance
                - 0.5 * LOG_TWO_PI - math.log(self.sigma))

    def log_ancestral_density(self, x, var1_sampled: bool = True):
        """Density of the ring draw: Gaussian radius times uniform angle,
        N(rho; r, sigma) / (2 pi rho) in the drawn endpoint's plane (the
        polar Jacobian ``log_pdf`` lacks), and a uniform heading's
        -log(2 pi) when that endpoint is SE(2).  ``var1_sampled`` names
        the known endpoint, so the drawn one is var2 when it is True."""
        d1 = self.var1.dim
        rho = torch.clamp(torch.linalg.vector_norm(
            x[:, d1:d1 + 2] - x[:, :2], dim=1), min=1e-8)
        target = self.var2 if var1_sampled else self.var1
        out = self.log_pdf(x) - torch.log(_TWO_PI * rho)
        if target.dim == 3:
            out = out - math.log(_TWO_PI)
        return out

    def grad_x_log_pdf(self, x):
        """Analytic gradient, guarded near zero distance."""
        d1 = self.var1.dim
        diff = x[:, :2] - x[:, d1:d1 + 2]
        dist = torch.linalg.vector_norm(diff, dim=1, keepdim=True)
        coeff = (-(dist - float(self.obs[0])) / self.variance) / \
            torch.clamp(dist, min=1e-8)
        g1 = coeff * diff
        out = torch.zeros_like(x)
        out[:, :2] = g1
        out[:, d1:d1 + 2] = -g1
        return out

    def loglike_rows(self, x):
        d1 = self.var1.dim
        delta = torch.linalg.vector_norm(x[:, :2] - x[:, d1:d1 + 2],
                                         dim=1) - float(self.obs[0])
        return (-0.5 * delta ** 2 / self.variance
                - 0.5 * LOG_TWO_PI - math.log(self.sigma))

    def __str__(self):
        vals = [str(self.var1.name), str(self.var2.name), str(self.obs[0]),
                str(self.sigma)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        return cls(n2v[tok[1]], n2v[tok[2]], float(tok[3]), float(tok[4]))


@register_factor
class SE2R2RangeGaussianLikelihoodFactor(_RangeFactorBase):
    """Range from an SE(2) pose to an R^2 landmark."""


@register_factor
class R2RangeGaussianLikelihoodFactor(_RangeFactorBase):
    """Range between two R^2 variables."""


@register_factor
class SE2SE2RangeGaussianLikelihoodFactor(_RangeFactorBase):
    """Range between two SE(2) poses."""


@register_factor
class UncertainR2RangeGaussianLikelihoodFactor(_RangeFactorBase):
    """Sensor-failure-aware range factor: when observed, draws use the
    radius distribution fused with the observability kernel; when
    unobserved, the log-likelihood is the miss model."""

    def __init__(self, var1, var2, observation, sigma=1.0,
                 observed_flag=False, unobserved_sigma=0.3):
        super().__init__(var1, var2, observation, sigma)
        self.raw_sigma = float(sigma)
        self.observed_flag = bool(observed_flag)
        self.unobserved_sigma = float(unobserved_sigma)
        s2, u2 = sigma ** 2, unobserved_sigma ** 2
        self.fused_var = s2 * u2 / (s2 + u2)
        self.fused_mu = u2 * float(self.obs[0]) / (s2 + u2)
        self.obs_fused = np.array([self.fused_mu])

    def _fused(self, draw, *args):
        """``draw`` with the fused radius distribution in place of the
        raw one."""
        if not self.observed_flag:
            raise ValueError("an unobserved range has no draws")
        saved_obs, saved_sigma = self.obs, self.sigma
        try:
            self.obs = self.obs_fused
            self.sigma = float(np.sqrt(self.fused_var))
            return draw(*args)
        finally:
            self.obs, self.sigma = saved_obs, saved_sigma

    def sample(self, key, var1=None, var2=None):
        return self._fused(super().sample, key, var1, var2)

    def unif_to_sample(self, u, var1=None, var2=None):
        return self._fused(super().unif_to_sample, u, var1, var2)

    def loglike_rows(self, x):
        d1 = self.var1.dim
        delta = torch.linalg.vector_norm(x[:, :2] - x[:, d1:d1 + 2], dim=1)
        if not self.observed_flag:
            return torch.log(1.0 - torch.exp(
                -0.5 * delta ** 2 / self.unobserved_sigma ** 2))
        return -0.5 * (delta - self.fused_mu) ** 2 / self.fused_var

    def __str__(self):
        vals = [str(self.var1.name), str(self.var2.name), str(self.obs[0]),
                str(self.raw_sigma), str(int(self.observed_flag)),
                str(self.unobserved_sigma)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        return cls(n2v[tok[1]], n2v[tok[2]], float(tok[3]), float(tok[4]),
                   bool(int(tok[5])), float(tok[6]))


# ==========================================================================
# Gaussian and ring priors
# ==========================================================================
@register_factor
class GaussianPriorFactor(PriorFactor, UnaryFactor):
    """Gaussian prior on a variable of any dimension."""

    def __init__(self, var: Variable, mean, covariance=None, precision=None):
        self._vars = [var]
        self.dist = GaussianDistribution(mean, covariance, precision)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.dist.mu

    @property
    def mu(self):
        return self.dist.mu

    @property
    def covariance(self):
        return self.dist.sigma

    def log_pdf(self, x):
        return self.dist.log_pdf(x)

    def grad_x_log_pdf(self, x):
        return self.dist.grad_x_log_pdf(x)

    def sample(self, key, num_samples, device):
        return self.dist.rvs(key, num_samples, device)

    def unif_to_sample(self, u):
        return self.dist.unif_to_sample(u)

    def __str__(self):
        vals = [str(self.vars[0].name)] + [str(m) for m in self.dist.mu] + \
            ["covariance"] + [str(v) for v in self.dist.sigma.reshape(-1)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        """The ``__str__`` grammar: name, the d means, ``covariance`` or
        ``precision``, the d x d matrix row by row (d from the
        variable)."""
        tok = _tokens(cls, line)
        var = vars_by_name(variables)[tok[1]]
        d = var.dim
        mean = np.array([float(t) for t in tok[2:2 + d]])
        mat = np.array([float(t) for t in tok[3 + d:3 + d + d * d]])
        if mat.shape[0] != d * d:
            raise ValueError(f"a {d}x{d} matrix expected: {line!r}")
        mat = mat.reshape(d, d)
        if tok[2 + d] == "covariance":
            return cls(var, mean, covariance=mat)
        if tok[2 + d] == "precision":
            return cls(var, mean, precision=mat)
        raise ValueError("covariance or precision expected")


@register_factor
class UnaryR2RangeGaussianPriorFactor(PriorFactor, UnaryFactor):
    """Ring prior: a known range (``mu``, ``sigma``) from a fixed centre.
    Its text form carries the variance after ``sigma``."""

    def __init__(self, var: Variable, center, mu: float, sigma: float):
        self._vars = [var]
        self.dist = GaussianRangeDistribution(center, mu, sigma ** 2)
        self.sigma = float(sigma)

    @property
    def vars(self):
        return self._vars

    @property
    def mu(self):
        return self.dist.mu

    @property
    def center(self):
        return self.dist.center

    @property
    def covariance(self):
        return self.dist.variance

    @property
    def observation(self):
        return self.dist.mu

    def log_pdf(self, x):
        return self.dist.log_pdf(x)

    def grad_x_log_pdf(self, x):
        return grad_rows(self.dist.log_pdf, x)

    def sample(self, key, num_samples, device):
        return self.dist.rvs(key, num_samples, device)

    def unif_to_sample(self, u):
        return self.dist.unif_to_sample(u)

    def __str__(self):
        vals = [str(self.vars[0].name), "center:", str(self.center[0]),
                str(self.center[1]), "mu:", str(self.mu), "sigma",
                str(self.covariance)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        # grammar: <name> center: cx cy mu: m sigma s (bare floats too)
        vals = [t for t in tok[2:] if not t.endswith(":") and
                t not in ("sigma", "center", "mu")]
        cx, cy, mu, variance = (float(v) for v in vals[:4])
        return cls(n2v[tok[1]], np.array([cx, cy]), mu,
                   float(np.sqrt(variance)))


@register_factor
class UncertainUnaryR2RangeGaussianPriorFactor(
        UnaryR2RangeGaussianPriorFactor):
    """Sensor-failure-aware ring prior: when observed, the radius
    distribution is the product of the range noise and an observability
    kernel; when unobserved, the log-likelihood is the miss model.  Its
    text form, as in the JAX package, carries the fused radius, which a
    parse fuses again."""

    def __init__(self, var, center, mu, sigma, observed_flag=True,
                 unobserved_sigma=0.3):
        s2, u2 = sigma ** 2, unobserved_sigma ** 2
        super().__init__(var, center, u2 * mu / (s2 + u2),
                         float(np.sqrt(s2 * u2 / (s2 + u2))))
        self.raw_mu = mu
        self.raw_sigma = sigma
        self.observed_flag = observed_flag
        self.unobserved_sigma = unobserved_sigma

    def loglike_rows(self, x):
        delta = torch.linalg.vector_norm(
            x - self.dist._const("center", x.device), dim=1)
        if not self.observed_flag:
            return torch.log(1.0 - torch.exp(
                -0.5 * delta ** 2 / self.unobserved_sigma ** 2))
        return -0.5 * (delta - self.mu) ** 2 / self.covariance


@register_factor
class UnarySE2ApproximateGaussianMixturePriorFactor(PriorFactor,
                                                    UnaryFactor):
    """Multimodal SE(2) prior: a weighted mixture of exp-map Gaussians."""

    def __init__(self, var: Variable, prior_poses, weights, covariances):
        self._vars = [var]
        self.prior_poses = np.stack(
            [np.asarray(p, dtype=np.float64).reshape(3)
             for p in prior_poses])
        w = np.asarray(weights, dtype=np.float64)
        self.weights = w / w.sum()
        self.covs = np.stack([np.asarray(c, dtype=np.float64)
                              for c in covariances])
        self.cov_sqrts = np.stack([spd_sqrt(c) for c in self.covs])
        self.prec_chols = np.stack([np.linalg.cholesky(np.linalg.inv(c))
                                    for c in self.covs])
        self.log_norms = -0.5 * (3 * LOG_TWO_PI +
                                 np.log(np.linalg.det(self.covs)))

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.prior_poses

    @property
    def covariance(self):
        return self.covs

    def _from_normal(self, comps: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
        noise = torch.einsum("nd,ned->ne", z,
                             self._const("cov_sqrts", z.device)[comps])
        return geom.se2_compose(self._const("prior_poses", z.device)[comps],
                                geom.se2_exp(noise))

    def sample(self, key, num_samples, device):
        gen = torch_generator(key, device)
        u = torch.rand(num_samples, generator=gen, device=device)
        cum = self._const("weights", device).cumsum(0)
        comps = (u[:, None] >= cum[None, :-1]).sum(dim=1)
        z = torch.randn((num_samples, 3), generator=gen, device=device)
        return self._from_normal(comps, z)

    def log_pdf(self, x):
        poses = self._const("prior_poses", x.device)
        chols = self._const("prec_chols", x.device)
        lps = []
        for k in range(len(self.weights)):
            inv = geom.se2_inverse(poses[k]).expand(x.shape[0], 3)
            lps.append(_se2_wrapped_log_pdf(
                geom.se2_compose(inv, x), chols[k],
                float(self.log_norms[k])) + math.log(self.weights[k]))
        return torch.logsumexp(torch.stack(lps, -1), dim=-1)

    def grad_x_log_pdf(self, x):
        return grad_rows(self.log_pdf, x)

    def unif_to_sample(self, u):
        """One (3,) uniform draw: its first coordinate picks the component
        (and, as in the JAX package, drives the noise too)."""
        u = u.reshape(-1)
        cum = self._const("weights", u.device).cumsum(0)
        comp = torch.argmax((u[0] * 0.9999999 < cum).to(torch.int32))
        z = norm_ppf(torch.clamp(u, 1e-12, 1 - 1e-12))
        return self._from_normal(comp[None], z[None])[0]

    def __str__(self):
        line = ["Factor", type(self).__name__, str(self.vars[0].name)]
        line += [str(p) for p in self.prior_poses]
        line.append(np.array_str(self.covs))
        return " ".join(line)

    @classmethod
    def construct_from_text(cls, line, variables):
        raise ValueError(
            f"{cls.__name__} has no text form: its string, as the JAX "
            f"package's, carries no weights")


# ==========================================================================
# R^2 odometry, slip/grip odometry, bearing
# ==========================================================================
@register_factor
class R2RelativeGaussianLikelihoodFactor(LikelihoodFactor, BinaryFactor):
    """Linear displacement factor: var2 = var1 + observation + noise."""

    measurement_dim = 2

    def __init__(self, var1, var2, observation, covariance=None,
                 precision=None):
        if var1.dim != var2.dim:
            raise ValueError("vars must share dimensionality")
        self._vars = [var1, var2]
        self.obs = np.asarray(observation, dtype=np.float64).reshape(-1)
        self.noise = GaussianDistribution(np.zeros(var1.dim), covariance,
                                          precision)
        self._obs_var = R2Variable(name=f"O{var1.name}{var2.name}",
                                   variable_type=VariableType.Measurement)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.obs

    @property
    def observation_var(self):
        return self._obs_var

    @property
    def covariance(self):
        return self.noise.sigma

    def _move(self, noise, var1, var2):
        if var1 is None and var2 is None:
            raise ValueError("need samples of at least one variable")
        obs = self._const("obs", noise.device)
        if var1 is None:
            return var2 - noise - obs
        return var1 + noise + obs

    def sample(self, key, var1=None, var2=None):
        ref = var1 if var1 is not None else var2
        if ref is None:
            raise ValueError("need samples of at least one variable")
        noise = self.noise.rvs(key, ref.shape[0], ref.device)
        if var1 is not None and var2 is not None:
            return var2 - var1 + noise
        return self._move(noise, var1, var2)

    def unif_to_sample(self, u, var1=None, var2=None):
        noise = norm_ppf(u) @ self.noise._const("cov_sqrt", u.device).T
        return self._move(noise, var1, var2)

    def log_pdf(self, x):
        d = self.vars[0].dim
        return self.noise.log_pdf(x[:, d:] - x[:, :d] -
                                  self._const("obs", x.device))

    def grad_x_log_pdf(self, x):
        d = self.vars[0].dim
        g = self.noise.grad_x_log_pdf(x[:, d:] - x[:, :d] -
                                      self._const("obs", x.device))
        return torch.cat([-g, g], dim=-1)

    def __str__(self):
        c = self.covariance
        vals = [str(self.var1.name), str(self.var2.name), str(self.obs[0]),
                str(self.obs[1]), "covariance", str(c[0, 0]), str(c[0, 1]),
                str(c[1, 0]), str(c[1, 1])]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        obs = np.array([float(tok[3]), float(tok[4])])
        mat = np.array([[float(tok[6]), float(tok[7])],
                        [float(tok[8]), float(tok[9])]])
        if tok[5] not in ("covariance", "precision"):
            raise ValueError("covariance or precision expected")
        return cls(n2v[tok[1]], n2v[tok[2]], obs, **{tok[5]: mat})


@register_factor
class RelativeGaussianSlipGripSE2Factor(LikelihoodFactor, BinaryFactor):
    """Slip/grip odometry: with probability ``prob_slip`` the true
    relative motion is zero (wheel slip), otherwise an SE(2) odometry
    factor; each sample draws its own coin."""

    measurement_dim = 3

    def __init__(self, var1, var2, observation, covariance, prob_slip=0.0,
                 correlated_Rt=True):
        self._vars = [var1, var2]
        self.obs = np.asarray(observation, dtype=np.float64).reshape(3)
        self.prob_slip = float(prob_slip)
        self.grip = SE2RelativeGaussianLikelihoodFactor(
            var1, var2, observation, covariance)
        self.slip = SE2RelativeGaussianLikelihoodFactor(
            var1, var2, np.zeros(3), covariance)
        self._obs_var = SE2Variable(name=f"O{var1.name}{var2.name}",
                                    variable_type=VariableType.Measurement)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.obs

    @property
    def observation_var(self):
        return self._obs_var

    def _noise_and_slip(self, key, n: int, device):
        gen = torch_generator(key, device)
        slipped = torch.rand((n, 1), generator=gen,
                             device=device) < self.prob_slip
        z = torch.randn((n, 3), generator=gen, device=device)
        return self.grip._noise(z), slipped

    def sample(self, key, var1=None, var2=None):
        if var1 is None and var2 is None:
            raise ValueError("need samples of at least one variable")
        ref = var1 if var1 is not None else var2
        noise, slipped = self._noise_and_slip(key, ref.shape[0], ref.device)
        obs = self._const("obs", ref.device).expand(ref.shape[0], 3)
        with_obs = geom.se2_compose(obs, noise)
        if var1 is not None and var2 is not None:
            grip = geom.se2_compose(geom.se2_between(var1, var2), noise)
            return torch.where(slipped, with_obs, grip)
        rel = torch.where(slipped, noise, with_obs)
        if var1 is None:
            return geom.se2_compose(var2, geom.se2_inverse(rel))
        return geom.se2_compose(var1, rel)

    def log_pdf(self, x):
        grip_w = math.log(1.0 - self.prob_slip) if self.prob_slip < 1.0 \
            else -math.inf
        grip_lp = self.grip.log_pdf(x) + grip_w
        slip_lp = self.slip.log_pdf(x) + math.log(max(self.prob_slip,
                                                      1e-300))
        return torch.logaddexp(grip_lp, slip_lp)

    @classmethod
    def construct_from_text(cls, line, variables):
        raise ValueError(
            f"{cls.__name__} has no text form (nor in the JAX package)")


@register_factor
class SE2BearingLikelihoodFactor(LikelihoodFactor, BinaryFactor):
    """Bearing between SE(2) poses: var2's heading is var1's plus the
    observed bearing; a draw of the unknown pose puts it at a uniform
    distance in [min_range, max_range] along var1's heading."""

    measurement_dim = 1

    def __init__(self, var1, var2, observation, sigma, min_range=0.1,
                 max_range=1.0):
        if not min_range < max_range:
            raise ValueError("min_range must be below max_range")
        self._vars = [var1, var2]
        self.obs = np.asarray(observation, dtype=np.float64).reshape(1)
        self.sigma = float(sigma)
        self.variance = sigma ** 2
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self._obs_var = Bearing2DVariable(
            name=f"O{var1.name}{var2.name}",
            variable_type=VariableType.Measurement)

    @property
    def vars(self):
        return self._vars

    @property
    def observation(self):
        return self.obs

    @property
    def observation_var(self):
        return self._obs_var

    def sample(self, key, var1=None, var2=None):
        if var1 is None and var2 is None:
            raise ValueError("need samples of at least one variable")
        ref = var1 if var1 is not None else var2
        n, device = ref.shape[0], ref.device
        gen = torch_generator(key, device)
        noise = self.sigma * torch.randn((n, 1), generator=gen,
                                         device=device)
        if var1 is not None and var2 is not None:
            return geom.wrap_angle(var2[:, 2:3] - var1[:, 2:3] + noise)
        obs = float(self.obs[0])
        dist = _uniform(gen, (n, 1), self.min_range, self.max_range, device)
        if var2 is None:
            th1 = var1[:, 2:3]
            xy = var1[:, :2] + torch.cat([dist * torch.cos(th1),
                                          dist * torch.sin(th1)], -1)
            return torch.cat([xy, geom.wrap_angle(th1 + obs + noise)], -1)
        ang = geom.wrap_angle(var2[:, 2:3] - obs - noise)
        xy = var2[:, :2] - torch.cat([dist * torch.cos(ang),
                                      dist * torch.sin(ang)], -1)
        return torch.cat([xy, ang], -1)

    def unif_to_sample(self, u, var1=None, var2=None):
        """One uniform pair: u[0] the distance, u[1] the bearing noise."""
        u = u.reshape(-1)
        ang = self.sigma * norm_ppf(u[1]) + float(self.obs[0])
        dist = self.min_range + u[0] * (self.max_range - self.min_range)
        if var1 is None:
            var2 = var2.reshape(-1)
            th = geom.wrap_angle(var2[2] - ang)
            xy = var2[:2] - torch.stack([dist * torch.cos(th),
                                         dist * torch.sin(th)])
            return torch.cat([xy, th[None]])
        var1 = var1.reshape(-1)
        th1 = var1[2]
        xy = var1[:2] + torch.stack([dist * torch.cos(th1),
                                     dist * torch.sin(th1)])
        return torch.cat([xy, geom.wrap_angle(th1 + ang)[None]])

    def log_pdf(self, x):
        delta = x[:, 5] - x[:, 2] - float(self.obs[0])
        return (-0.5 * delta ** 2 / self.variance
                - 0.5 * (LOG_TWO_PI + math.log(self.variance)))

    def loglike_rows(self, x):
        delta = x[:, 5] - x[:, 2] - float(self.obs[0])
        return (-0.5 * delta ** 2 / self.variance
                - 0.5 * LOG_TWO_PI - math.log(self.sigma))

    def __str__(self):
        vals = [str(self.var1.name), str(self.var2.name), str(self.obs[0]),
                str(self.sigma), str(self.min_range), str(self.max_range)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = _tokens(cls, line)
        n2v = vars_by_name(variables)
        extras = [float(t) for t in tok[5:7]]
        return cls(n2v[tok[1]], n2v[tok[2]], float(tok[3]), float(tok[4]),
                   *extras)
