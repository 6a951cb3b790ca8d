"""Mixture and ambiguous-data-association factors over batched tensors.

Counterpart of ``nfisam_tpu/factors/mixtures.py``: each component is
evaluated on the whole batch and the per-sample component assignment is a
select.  Sampling takes a raw host key, splits it with ``split_host``
where the JAX package does (so both consume the key stream alike), and
draws the assignment from a ``torch.Generator`` seeded with the first
half; the components draw from the second half's splits.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from ..core.variables import Variable
from ..utils.keys import split_host, torch_generator
from .factors import (FACTOR_REGISTRY, BinaryFactor, Factor,
                      LikelihoodFactor, register_factor, vars_by_name)


class KWayFactor(Factor):
    """Marker for factors connecting an observer to K candidates."""

    @property
    def root_var(self) -> Variable:
        raise NotImplementedError

    @property
    def child_vars(self) -> List[Variable]:
        raise NotImplementedError


class BinaryFactorMixture(LikelihoodFactor):
    """Weighted mixture of binary factors between one observer and its
    candidates."""

    def __init__(self, observer_var: Variable,
                 observed_vars: Sequence[Variable], weights,
                 binary_factor_class, obs_arr: Sequence, sigma_arr: Sequence):
        w = np.asarray(weights, dtype=np.float64)
        if not (np.all(w > 0) and len(w) == len(obs_arr) == len(sigma_arr)
                == len(observed_vars)):
            raise ValueError("a mixture needs one positive weight, "
                             "observation and sigma per observed variable")
        self.observer_var = observer_var
        # de-duplicate observed vars, preserving order
        seen = set()
        self.observed_vars = [v for v in observed_vars
                              if not (v in seen or seen.add(v))]
        self._vars = [observer_var] + self.observed_vars
        self.weights = w / w.sum()
        self.cum_weights = np.cumsum(self.weights)
        self.observations = list(obs_arr)
        self.sigmas = list(sigma_arr)
        self.components = [binary_factor_class(observer_var, var, obs_arr[i],
                                               sigma_arr[i])
                           for i, var in enumerate(observed_vars)]
        # column indices of each variable in the stacked (observer, observed)
        self.var2idx: Dict[Variable, np.ndarray] = {}
        start = 0
        for v in self._vars:
            self.var2idx[v] = np.arange(start, start + v.dim)
            start += v.dim
        self.comp2idx = {
            comp: np.concatenate([self.var2idx[comp.var1],
                                  self.var2idx[comp.var2]])
            for comp in self.components}

    # ------------------------------------------------------------------ meta
    @property
    def vars(self):
        return self._vars

    @property
    def observation_var(self):
        return self.components[0].observation_var

    @property
    def measurement_dim(self):
        return self.observation_var.dim

    # ------------------------------------------------------------- densities
    def _comp_index(self, i: int, device) -> torch.Tensor:
        """Component i's columns as an index tensor on ``device``, made
        once per device."""
        cache = self.__dict__.setdefault("_index_cache", {})
        key = (i, str(device))
        idx = cache.get(key)
        if idx is None:
            idx = cache[key] = torch.as_tensor(
                self.comp2idx[self.components[i]], device=device)
        return idx

    def component_log_pdfs(self, x: torch.Tensor) -> torch.Tensor:
        """(n, k) weighted per-component log densities."""
        cols = []
        for i, comp in enumerate(self.components):
            cols.append(comp.log_pdf(x[:, self._comp_index(i, x.device)]) +
                        math.log(self.weights[i]))
        return torch.stack(cols, dim=-1)

    def log_pdf(self, x):
        return torch.logsumexp(self.component_log_pdfs(x), dim=-1)

    def pdf(self, x):
        return torch.exp(self.log_pdf(x))

    def loglike_rows(self, x):
        """The mixture log-likelihood of each row, max-approximated where
        one hypothesis leads the runner-up by more than 5 nats."""
        lps = self.component_log_pdfs(x)
        if lps.shape[1] < 2:
            return lps[:, 0]
        top2 = torch.topk(lps, 2, dim=1).values
        return torch.where(top2[:, 0] - top2[:, 1] > 5.0, top2[:, 0],
                           torch.logsumexp(lps, dim=1))

    def grad_x_log_pdf(self, x):
        """The responsibility-weighted sum of the components' gradients."""
        resp = torch.softmax(self.component_log_pdfs(x), dim=-1)
        out = torch.zeros_like(x)
        for i, comp in enumerate(self.components):
            idx = self._comp_index(i, x.device)
            out[:, idx] += resp[:, i:i + 1] * comp.grad_x_log_pdf(x[:, idx])
        return out

    # -------------------------------------------------------------- sampling
    def _component_assignment(self, key, n: int, device) -> torch.Tensor:
        """(n,) component index per sample, drawn with the weights."""
        u = torch.rand(n, generator=torch_generator(key, device),
                       device=device)
        cum = self._const("cum_weights", device)
        return (u[:, None] >= cum[None, :-1]).sum(dim=1)

    def _draw_by_component(self, key, n: int, device, draw_i
                           ) -> torch.Tensor:
        """(n, ...) draws, each from the component its sample is assigned
        to: the assignment from the first half of ``key``, component i's
        draws ``draw_i(i, key_i)`` from the i-th split of the second."""
        kc, ks = split_host(key)
        comps = self._component_assignment(kc, n, device)
        keys = split_host(ks, len(self.components))
        out = draw_i(0, keys[0])
        for i in range(1, len(self.components)):
            out = torch.where((comps == i)[:, None], draw_i(i, keys[i]), out)
        return out

    def sample_observations(self, key, var_samples: Dict[Variable,
                                                         torch.Tensor]
                            ) -> torch.Tensor:
        """Observation columns given samples of every endpoint."""
        given = var_samples[self.observer_var]

        def draw(i, k):
            comp = self.components[i]
            return comp.sample(k, var1=var_samples[comp.var1],
                               var2=var_samples[comp.var2])

        return self._draw_by_component(key, given.shape[0], given.device,
                                       draw)

    def posterior_weights(self, var2x) -> np.ndarray:
        """Hypothesis weights re-evaluated on posterior samples (a mapping
        variable -> (n, dim) array or tensor): each sample's normalized
        component likelihoods, 0.5 each where all vanish, summed over
        samples and normalized."""
        x = np.concatenate(
            [var2x[v].cpu().numpy() if torch.is_tensor(var2x[v])
             else np.asarray(var2x[v]) for v in self.vars],
            axis=1).astype(np.float32)
        like = np.stack([
            torch.exp(comp.log_pdf(torch.as_tensor(
                x[:, self.comp2idx[comp]]))).numpy() * self.weights[i]
            for i, comp in enumerate(self.components)])
        tot = like.sum(axis=0)
        ok = tot > 0.0
        hypo = np.full((len(self.components), x.shape[0]), 0.5)
        hypo[:, ok] = like[:, ok] / tot[ok]
        return hypo.sum(axis=1) / hypo.sum()

    # ------------------------------------------------------------------ text
    def _str_tail(self) -> List[str]:
        line = ["Observer", str(self.observer_var.name), "Observed"]
        line += [str(v.name) for v in self.observed_vars]
        line += ["Weights"] + [str(w) for w in self.weights]
        line += ["Binary", type(self.components[0]).__name__, "Observation"]
        obs = self.observations[0]
        if isinstance(obs, (np.ndarray, list)):
            line += [str(v) for v in np.asarray(obs).reshape(-1)]
        else:
            line += [str(obs)]
        line += ["Sigma"]
        sig = self.sigmas[0]
        if np.isscalar(sig):
            line += [str(sig)]
        else:
            line += [str(v) for v in np.asarray(sig).reshape(-1)]
        return line

    @classmethod
    def _parse_common(cls, line: str, variables: Iterable[Variable]):
        """(observer, observed, weights, binary class, observation, sigma,
        tokens) of a mixture line."""
        tok = line.strip().split()
        if tok[0] != cls.__name__:
            raise ValueError(f"not a {cls.__name__} line: {line!r}")
        n2v = vars_by_name(variables)
        i_obsr = tok.index("Observer") + 1
        i_obsd = tok.index("Observed") + 1
        i_w = tok.index("Weights") + 1
        i_f = tok.index("Binary") + 1
        i_o = tok.index("Observation") + 1
        i_s = tok.index("Sigma") + 1
        observer = n2v[tok[i_obsr]]
        observed = [n2v[tok[i]] for i in range(i_obsd, i_w - 1)]
        weights = np.array(tok[i_w:i_f - 1], dtype=float)
        binary_cls = FACTOR_REGISTRY.get(tok[i_f])
        if binary_cls is None:
            raise ValueError(f"Unknown factor type {tok[i_f]}")
        obs_len = i_s - i_o - 1
        if obs_len == 1:
            observation = float(tok[i_o])
            sigma = float(tok[i_s])
        else:
            observation = np.array(tok[i_o:i_s - 1], dtype=float)
            sigma = np.array(tok[i_s:i_s + obs_len * obs_len],
                             dtype=float).reshape(obs_len, obs_len)
        return observer, observed, weights, binary_cls, observation, sigma, \
            tok


class BinaryMixtureWithSameData(BinaryFactorMixture):
    @property
    def observation(self):
        return self.components[0].observation


@register_factor
class AmbiguousDataAssociationFactor(BinaryMixtureWithSameData, KWayFactor):
    """K-way ambiguous data association: one observer, K candidate
    observed variables sharing one raw measurement."""

    def __init__(self, observer_var, observed_vars, weights,
                 binary_factor_class, observation, sigma):
        k = len(observed_vars)
        if k != len(weights):
            raise ValueError("one weight per observed variable expected")
        super().__init__(observer_var, observed_vars, weights,
                         binary_factor_class, [observation] * k, [sigma] * k)

    @property
    def root_var(self):
        return self.observer_var

    @property
    def child_vars(self):
        return self.observed_vars

    def sample_observer(self, key, var2sample: Dict[Variable, torch.Tensor]
                        ) -> torch.Tensor:
        """Draws of the observer given samples of every observed var."""
        given = var2sample[self.observed_vars[0]]

        def draw(i, k):
            comp = self.components[i]
            if comp.var1 == self.observer_var:
                return comp.sample(k, var2=var2sample[comp.var2])
            return comp.sample(k, var1=var2sample[comp.var1])

        return self._draw_by_component(key, given.shape[0], given.device,
                                       draw)

    def __str__(self):
        return "Factor " + type(self).__name__ + " " + \
            " ".join(self._str_tail())

    @classmethod
    def construct_from_text(cls, line, variables):
        observer, observed, weights, bcls, obs, sigma, _ = \
            cls._parse_common(line, variables)
        return cls(observer, observed, weights, bcls, obs, sigma)


@register_factor
class BinaryFactorWithNullHypo(BinaryMixtureWithSameData, BinaryFactor):
    """Outlier-robust binary factor: the true hypothesis and a null
    hypothesis with its noise inflated ``null_sigma_scale`` times."""

    def __init__(self, var1, var2, weights, binary_factor_class, observation,
                 sigma, null_sigma_scale=10.0):
        if len(weights) != 2:
            raise ValueError("a null-hypothesis factor has two weights")
        self.null_sigma_scale = float(null_sigma_scale)
        super().__init__(var1, [var2, var2], weights, binary_factor_class,
                         [observation] * 2,
                         [sigma, sigma * null_sigma_scale])

    def _mixture_binary_sample(self, key, var1=None, var2=None):
        given = var1 if var1 is not None else var2
        return self._draw_by_component(
            key, given.shape[0], given.device,
            lambda i, k: self.components[i].sample(k, var1=var1, var2=var2))

    def sample(self, key, var1=None, var2=None):
        if var1 is None and var2 is None:
            raise ValueError("need samples of at least one variable")
        return self._mixture_binary_sample(key, var1, var2)

    def unif_to_sample(self, u, var1=None, var2=None):
        """CDF inversion through the mixture: the first uniform coordinate
        picks the component and is rescaled into it.  Takes a single
        ``(du,)`` draw or a batch ``(n, du)``."""
        squeeze = u.ndim == 1
        u = torch.atleast_2d(u.to(torch.float32))
        cum = self._const("cum_weights", u.device)
        w = self._const("weights", u.device)
        comp_idx = torch.clamp(
            (u[:, :1] >= cum[None, :-1]).sum(dim=1), 0,
            len(self.components) - 1)
        offsets = torch.cat([torch.zeros(1, device=u.device), cum[:-1]])
        u0 = (u[:, 0] - offsets[comp_idx]) / w[comp_idx]
        u = torch.cat([torch.clamp(u0, 0.0, 1.0)[:, None], u[:, 1:]], dim=1)
        v1 = None if var1 is None else torch.atleast_2d(var1)
        v2 = None if var2 is None else torch.atleast_2d(var2)
        outs = [comp.unif_to_sample(u, var1=v1, var2=v2)
                for comp in self.components]
        out = outs[0]
        for i in range(1, len(outs)):
            out = torch.where((comp_idx == i)[:, None], outs[i], out)
        return out[0] if squeeze else out

    def __str__(self):
        tail = self._str_tail() + ["NullSigmaScale",
                                   str(self.null_sigma_scale)]
        return "Factor " + type(self).__name__ + " " + " ".join(tail)

    @classmethod
    def construct_from_text(cls, line, variables):
        observer, observed, weights, bcls, obs, sigma, tok = \
            cls._parse_common(line, variables)
        i_null = tok.index("NullSigmaScale") + 1
        return cls(observer, observed[0], weights, bcls, obs, sigma,
                   float(tok[i_null]))
