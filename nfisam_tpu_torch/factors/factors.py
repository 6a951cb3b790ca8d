"""Factor library, case1 subset, over batched tensors.

Counterpart of ``nfisam_tpu/factors/factors.py`` for the three factor
types of the case1 problem: the SE(2) prior
(``UnarySE2ApproximateGaussianPriorFactor``), SE(2) odometry
(``SE2RelativeGaussianLikelihoodFactor``) and SE(2)-R^2 range
(``SE2R2RangeGaussianLikelihoodFactor``), and the R^2 landmark prior
(``UnaryR2GaussianPriorFactor``).  Numeric methods take ``(n, d)``
tensors and compute in float32 on the tensors' device; sampling takes a
raw host key and draws from a ``torch.Generator`` seeded with it on that
device.  The ``.fg`` grammar is the JAX package's, dispatched through a
registry: a line naming a type that is not registered raises.
"""
from __future__ import annotations

import math
from abc import ABC
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..core import geometry as geom
from ..core.distributions import (LOG_TWO_PI, gaussian_log_pdf, norm_ppf,
                                  spd_sqrt)
from ..core.variables import (R1Variable, SE2Variable, Variable,
                              VariableType, circular_dim_list)
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


def _uniform(gen: torch.Generator, shape, low: float, high: float,
             device) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen,
                                           device=device)


# ==========================================================================
# Base protocol
# ==========================================================================
class Factor(ABC):
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

    def _const(self, name: str, device) -> torch.Tensor:
        """Float32 copy of the numpy attribute ``name`` on ``device``,
        made once per device: a host-to-device copy per call would
        synchronise the stream."""
        cache = self.__dict__.setdefault("_tensor_cache", {})
        key = (name, str(device))
        t = cache.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name),
                                           dtype=np.float32), device=device)
            cache[key] = t
        return t

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

    def __str__(self):
        vals = [str(self.vars[0].name)] + [str(v) for v in self.prior_pose] + \
            ["covariance"] + [str(v) for v in self.covariance.reshape(-1)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = line.strip().split()
        if tok[0] != cls.__name__:
            raise ValueError(f"not a {cls.__name__} line: {line!r}")
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

    def __str__(self):
        c = self.covariance
        vals = [str(self.vars[0].name), str(self.mu[0]), str(self.mu[1]),
                "covariance", str(c[0, 0]), str(c[0, 1]), str(c[1, 0]),
                str(c[1, 1])]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = line.strip().split()
        if tok[0] != cls.__name__:
            raise ValueError(f"not a {cls.__name__} line: {line!r}")
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

    def __str__(self):
        vals = [str(self.var1.name), str(self.var2.name)] + \
            [str(v) for v in self.obs] + ["covariance"] + \
            [str(v) for v in self.covariance.reshape(-1)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = line.strip().split()
        if tok[0] != cls.__name__:
            raise ValueError(f"not a {cls.__name__} line: {line!r}")
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

    def __str__(self):
        vals = [str(self.var1.name), str(self.var2.name), str(self.obs[0]),
                str(self.sigma)]
        return "Factor " + type(self).__name__ + " " + " ".join(vals)

    @classmethod
    def construct_from_text(cls, line, variables):
        tok = line.strip().split()
        if tok[0] != cls.__name__:
            raise ValueError(f"not a {cls.__name__} line: {line!r}")
        n2v = vars_by_name(variables)
        return cls(n2v[tok[1]], n2v[tok[2]], float(tok[3]), float(tok[4]))


@register_factor
class SE2R2RangeGaussianLikelihoodFactor(_RangeFactorBase):
    """Range from an SE(2) pose to an R^2 landmark."""
