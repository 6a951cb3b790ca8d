"""Ancestral ("direct") simulation of a clique's joint density.

Counterpart of ``nfisam_tpu/samplers/simulation.py``: sample the prior
factors, propagate through binary factors in dependency order (a work
queue with deferral that refuses landmark->pose sampling; null-hypothesis
factors join the queue once it is empty), then the data-association
factors: an observation draw when every endpoint is sampled, else a draw
of the observer from its candidates.  Fully determined factors emit
simulated observation columns; these become the flow's
augmented-observation dims.  The schedule is resolved on the host once
per clique; every sampling op is a batched tensor call on the sampler's
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.variables import Variable
from ..factors.factors import Factor
from ..factors.utils import unpack_prior_binary_nh_da_factors
from ..utils.keys import split_host


@dataclass
class ScheduleOp:
    """One step of the simulation schedule."""
    kind: str          # 'prior' | 'prior_cond' | 'forward' | 'backward' |
                       # 'observe' | 'observe_da' | 'sample_observer'
    factor: Factor
    out_var: Optional[Variable] = None   # for sampling ops


@dataclass
class SimulationSchedule:
    ops: List[ScheduleOp]
    var_ordering: List[Variable]         # obs vars first, then clique pattern
    unused_obs: np.ndarray               # concatenated true observations


def compile_schedule(factors: Sequence[Factor],
                     variable_pattern: Sequence[Variable]
                     ) -> SimulationSchedule:
    """Resolve the work queue into a static op list."""
    priors, binaries, nh, da = unpack_prior_binary_nh_da_factors(
        list(factors))
    sampled: set = set()
    ops: List[ScheduleOp] = []
    obs_vars: List[Variable] = []
    unused_obs: List[float] = []

    for f in priors:
        overlap = [v for v in f.vars if v in sampled]
        if overlap:
            # Two prior factors sharing variables (sibling subtrees'
            # separator flows both carrying a shared variable).  Shared
            # vars are the latest-eliminated, so they lead the flow's
            # column order: draw the SUFFIX conditioned on the sampled
            # prefix, which keeps the simulated joint the tree
            # factorization p(shared) * prod p(rest_i | shared).
            k = len(overlap)
            if (k < len(f.vars) and overlap == f.vars[:k]
                    and hasattr(f, "sample_conditional")):
                ops.append(ScheduleOp("prior_cond", f))
                sampled.update(f.vars)
                continue
            if k == len(f.vars):
                continue    # fully determined: nothing left to draw
            # otherwise the later draw overwrites the earlier one
        ops.append(ScheduleOp("prior", f))
        sampled.update(f.vars)

    queue = list(binaries)
    added_nh = False
    unresolved: List[Factor] = []
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
                raise RuntimeError(
                    "Simulation schedule cannot make progress; "
                    "disconnected clique factors: " + str(f))
            continue
        if len(known) == 2:
            unused_obs += list(np.asarray(f.observation).reshape(-1))
            ops.append(ScheduleOp("observe", f))
            obs_vars.append(f.observation_var)
            continue
        # exactly one endpoint known
        v1, v2 = f.vars[0], f.vars[1]
        if known[0] == v1:
            if v1.dim < v2.dim:
                # refuse sampling a pose from a landmark
                if not queue:
                    unresolved.append(f)
                    continue
                queue.append(f)
                continue
            ops.append(ScheduleOp("forward", f, out_var=v2))
            sampled.add(v2)
        else:
            if v2.dim < v1.dim:
                if not queue:
                    unresolved.append(f)
                    continue
                queue.append(f)
                continue
            ops.append(ScheduleOp("backward", f, out_var=v1))
            sampled.add(v1)

    for f in da:
        if set(f.vars).issubset(sampled):
            unused_obs += list(np.asarray(f.observation).reshape(-1))
            ops.append(ScheduleOp("observe_da", f))
            obs_vars.append(f.observation_var)
        else:
            missing = set(f.vars) - sampled
            if missing == {f.observer_var}:
                ops.append(ScheduleOp("sample_observer", f,
                                      out_var=f.observer_var))
                sampled.add(f.observer_var)
            else:
                raise ValueError(
                    "Unsampled data-association variables: " +
                    " ".join(str(v.name) for v in missing))

    for f in unresolved:
        if set(f.vars).issubset(sampled):
            unused_obs += list(np.asarray(f.observation).reshape(-1))
            ops.append(ScheduleOp("observe", f))
            obs_vars.append(f.observation_var)
        else:
            raise ValueError(
                "Clique requires landmark->pose sampling; consider a "
                "different elimination ordering: " + str(f))

    missing_pattern = [v for v in variable_pattern if v not in sampled]
    if missing_pattern:
        raise ValueError("Pattern variables never sampled: " +
                         " ".join(str(v.name) for v in missing_pattern))

    return SimulationSchedule(
        ops=ops,
        var_ordering=obs_vars + list(variable_pattern),
        unused_obs=np.asarray(unused_obs, dtype=np.float64))


def execute_schedule(key, schedule: SimulationSchedule,
                     variable_pattern: Sequence[Variable],
                     num_samples: int, device
                     ) -> Dict[Variable, torch.Tensor]:
    """Run the schedule: per-variable sample blocks plus an ``_obs`` entry
    of observation columns.  Op ``j`` draws with the ``j``-th key split
    from ``key``."""
    var_samples: Dict[Variable, torch.Tensor] = {}
    obs_cols: List[torch.Tensor] = []
    keys = split_host(key, max(len(schedule.ops), 1))
    for op, k in zip(schedule.ops, keys):
        f = op.factor
        if op.kind == "prior":
            s = f.sample(k, num_samples, device)
            start = 0
            for v in f.vars:
                var_samples[v] = s[:, start:start + v.dim]
                start += v.dim
        elif op.kind == "prior_cond":
            known = [v for v in f.vars if v in var_samples]
            prefix = torch.cat([var_samples[v] for v in known], dim=1)
            s = f.sample_conditional(k, prefix)
            start = 0
            for v in f.vars[len(known):]:
                var_samples[v] = s[:, start:start + v.dim]
                start += v.dim
        elif op.kind == "forward":
            var_samples[op.out_var] = f.sample(
                k, var1=var_samples[f.vars[0]])
        elif op.kind == "backward":
            var_samples[op.out_var] = f.sample(
                k, var2=var_samples[f.vars[1]])
        elif op.kind == "observe":
            obs_cols.append(f.sample(k, var1=var_samples[f.vars[0]],
                                     var2=var_samples[f.vars[1]]))
        elif op.kind == "observe_da":
            vs = {v: var_samples[v] for v in f.vars}
            obs_cols.append(f.sample_observations(k, vs))
        elif op.kind == "sample_observer":
            var_samples[op.out_var] = f.sample_observer(
                k, {v: var_samples[v] for v in f.vars if v in var_samples})
        else:  # pragma: no cover
            raise ValueError(op.kind)
    var_samples["_obs"] = obs_cols
    return var_samples


class SimulationBasedSampler:
    """Clique simulator over the clique's factors and variable pattern."""

    def __init__(self, factors: Sequence[Factor], vars: Sequence[Variable],
                 device) -> None:
        self.factors = list(factors)
        self.vars = list(vars)
        self.device = torch.device(device)
        self.schedule = compile_schedule(self.factors, self.vars)

    def sample(self, key, num_samples: int
               ) -> Tuple[torch.Tensor, List[Variable], np.ndarray]:
        """Returns (samples (n, obs+clique dims), var ordering, true obs)."""
        out = execute_schedule(key, self.schedule, self.vars, num_samples,
                               self.device)
        cols = list(out["_obs"])
        cols += [out[v] for v in self.vars]
        samples = torch.cat(cols, dim=1) if cols else \
            torch.zeros((num_samples, 0), device=self.device)
        return samples, self.schedule.var_ordering, self.schedule.unused_obs
