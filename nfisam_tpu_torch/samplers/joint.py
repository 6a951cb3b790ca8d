"""Joint densities over a stacked variable vector, and the ancestral
(tree) split that draws from one.

Counterpart of ``JointFactor`` and ``StructuredJointFactor`` in
``nfisam_tpu/samplers/joint.py`` (reference ``sampler_utils.py``
``JointFactor:11``, ``StructuredJointFactorForSLAM:140``): the index
maps, the joint ``log_pdf`` over ``(n, dim)`` tensors (one call per
factor, on the tensor's device), the split into tree factors and
likelihood factors, the ancestral ``sample``, which takes keys from
``split_host`` in the JAX package's order and draws with
``torch.Generator``s seeded from them, and the samplers' API: the joint's
gradient (``grad_x_log_pdf``), the prior transform from the unit cube
through the tree factors (``ptform``), the likelihood of the other
factors (``loglike``, each factor's ``evaluate_loglike`` row by row) and
the density of the measure the tree draws from (``log_prior_tree``).
Each takes ``(n, dim)`` tensors and computes in float32 on their device;
``ptform`` stays differentiable in ``u``, through a flow's masked inverse
too (its implicit-function VJP, ``flows.ar_inverse.MaskedStackInverse``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..core.variables import Variable
from ..factors.factors import Factor, grad_rows
from ..factors.utils import unpack_prior_binary_nh_da_factors
from ..utils.keys import split_host


class JointFactor:
    """Joint density = product of factors over a stacked variable vector."""

    def __init__(self, factors: Sequence[Factor],
                 vars: Sequence[Variable]) -> None:
        self._vars = list(vars)
        self._factors = list(factors)
        self.var_to_indices: Dict[Variable, List[int]] = {}
        cur = 0
        for v in self._vars:
            self.var_to_indices[v] = list(range(cur, cur + v.dim))
            cur += v.dim
        self.dim = cur
        self.factor_to_indices: Dict[Factor, List[int]] = {}
        for f in self._factors:
            idx: List[int] = []
            for v in f.vars:
                idx += self.var_to_indices[v]
            self.factor_to_indices[f] = idx
        self._index_cache: Dict[tuple, torch.Tensor] = {}

    @property
    def vars(self) -> List[Variable]:
        return self._vars

    @property
    def factors(self) -> List[Factor]:
        return self._factors

    @property
    def circular_dim_list(self) -> List[bool]:
        out: List[bool] = []
        for v in self._vars:
            out += v.circular_dim_list
        return out

    def _index(self, f: Factor, device) -> torch.Tensor:
        """``factor_to_indices[f]`` as a tensor on ``device``, made once."""
        key = (id(f), str(device))
        idx = self._index_cache.get(key)
        if idx is None:
            idx = self._index_cache[key] = torch.as_tensor(
                self.factor_to_indices[f], device=device)
        return idx

    def _cols(self, x: torch.Tensor, v: Variable) -> torch.Tensor:
        """The columns of variable ``v`` in ``x`` (a view)."""
        start = self.var_to_indices[v][0]
        return x[:, start:start + v.dim]

    def log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """(n, dim) -> (n,) joint log density on ``x``'s device."""
        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for f in self._factors:
            total = total + f.log_pdf(x[:, self._index(f, x.device)])
        return total

    def grad_x_log_pdf(self, x: torch.Tensor) -> torch.Tensor:
        """(n, dim) -> (n, dim) gradient of the joint log density."""
        return grad_rows(self.log_pdf, x.to(torch.float32))


class StructuredJointFactor(JointFactor):
    """Joint factor with an ancestral-sampling split: 'tree' factors draw
    the variables one after another; the rest are the likelihood."""

    def __init__(self, factors: Sequence[Factor],
                 variable_pattern: Sequence[Variable]) -> None:
        super().__init__(factors, variable_pattern)
        priors, binaries, nh, da = unpack_prior_binary_nh_da_factors(
            list(factors))
        sampled: set = set()
        self.tree_priors: List[Factor] = []
        self.likelihood_factors: List[Factor] = []
        for f in priors:
            if set(f.vars) & sampled:
                self.likelihood_factors.append(f)
            else:
                self.tree_priors.append(f)
                sampled.update(f.vars)
        self.tree_binaries: List = []   # (factor, var1_sampled: bool)
        queue = list(binaries)
        added_nh = False
        guard = 0
        while queue or (nh and not added_nh):
            if not added_nh and not queue:
                queue = list(nh)
                added_nh = True
            f = queue.pop(0)
            known = [v for v in f.vars if v in sampled]
            if len(known) == 0:
                queue.append(f)
                guard += 1
                if guard > 10000:
                    raise ValueError("Disconnected factors: " + str(f))
                continue
            if len(known) == 2:
                self.likelihood_factors.append(f)
                continue
            v1, v2 = f.vars[0], f.vars[1]
            if known[0] == v1:
                if v1.dim < v2.dim and queue:
                    queue.append(f)
                    continue
                if v1.dim < v2.dim:
                    raise ValueError(
                        "Only remaining factor needs landmark->pose "
                        "sampling: " + str(f))
                self.tree_binaries.append((f, True))
                sampled.add(v2)
            else:
                if v2.dim < v1.dim and queue:
                    queue.append(f)
                    continue
                if v2.dim < v1.dim:
                    raise ValueError(
                        "Only remaining factor needs landmark->pose "
                        "sampling: " + str(f))
                self.tree_binaries.append((f, False))
                sampled.add(v1)
        for f in da:
            if set(f.vars).issubset(sampled):
                self.likelihood_factors.append(f)
            else:
                raise ValueError("Unsampled DA variables in " + str(f))
        if len(sampled) != len(self._vars):
            raise ValueError("the tree factors leave variables unsampled")

    @property
    def if_direct_sampling(self) -> bool:
        return len(self.likelihood_factors) == 0

    def sample(self, key, num_samples: int, device) -> torch.Tensor:
        """(num_samples, dim) pure ancestral draw through the tree factors
        on ``device``: one key a tree factor, from ``split_host(key)``."""
        x = torch.zeros((num_samples, self.dim), device=device)
        n_ops = len(self.tree_priors) + len(self.tree_binaries)
        keys = split_host(key, max(n_ops, 1))
        ki = 0
        for f in self.tree_priors:
            x[:, self._index(f, device)] = f.sample(keys[ki], num_samples,
                                                    device)
            ki += 1
        for f, var1_sampled in self.tree_binaries:
            idx = self._index(f, device)
            d1 = f.vars[0].dim
            if var1_sampled:
                x[:, idx[d1:]] = f.sample(keys[ki], var1=x[:, idx[:d1]])
            else:
                x[:, idx[:d1]] = f.sample(keys[ki], var2=x[:, idx[d1:]])
            ki += 1
        return x


    # ------------------------------------------------- nested-sampling API
    def ptform(self, u: torch.Tensor) -> torch.Tensor:
        """(n, dim) unit cube -> (n, dim) parameters: each tree prior maps
        its variables' coordinates, then each tree binary draws its
        unknown endpoint from its known one."""
        u = u.to(torch.float32)
        blocks: Dict[Variable, torch.Tensor] = {}
        for f in self.tree_priors:
            uf = torch.cat([self._cols(u, v) for v in f.vars], dim=1)
            xf, start = f.unif_to_sample(uf), 0
            for v in f.vars:
                blocks[v] = xf[:, start:start + v.dim]
                start += v.dim
        for f, var1_sampled in self.tree_binaries:
            v1, v2 = f.vars[0], f.vars[1]
            if var1_sampled:
                blocks[v2] = f.unif_to_sample(self._cols(u, v2),
                                              var1=blocks[v1])
            else:
                blocks[v1] = f.unif_to_sample(self._cols(u, v1),
                                              var2=blocks[v2])
        return torch.cat([blocks[v] for v in self._vars], dim=1)

    def loglike(self, x: torch.Tensor) -> torch.Tensor:
        """(n, dim) parameters -> (n,) log-likelihood of the non-tree
        factors, each row by ``evaluate_loglike``'s rule."""
        x = x.to(torch.float32)
        total = torch.zeros(x.shape[0], device=x.device)
        for f in self.likelihood_factors:
            total = total + f.loglike_rows(x[:, self._index(f, x.device)])
        return total

    def log_prior_tree(self, x: torch.Tensor) -> torch.Tensor:
        """(n, dim) parameters -> (n,) log density of the measure that
        ``sample`` and ``ptform`` draw from: the tree priors' densities and
        the tree binaries' ancestral densities (a ring-drawn range carries
        the polar Jacobian its ``log_pdf`` lacks).  A Metropolis move over
        that measure needs it in its acceptance ratio."""
        x = x.to(torch.float32)
        total = torch.zeros(x.shape[0], device=x.device)
        for f in self.tree_priors:
            total = total + f.log_pdf(x[:, self._index(f, x.device)])
        for f, var1_sampled in self.tree_binaries:
            total = total + f.log_ancestral_density(
                x[:, self._index(f, x.device)], var1_sampled=var1_sampled)
        return total
