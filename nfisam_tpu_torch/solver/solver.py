"""Incremental factor-graph solver core.

Counterpart of ``nfisam_tpu/solver/solver.py``: physical vs working graph
split, elimination orderings, incremental Bayes-tree surgery with
density-model recycling and mode repair, leaves-to-root clique fitting,
and the root-to-leaf posterior pass: fused over one buffer
(``posterior_pass.py``), or clique by clique.  All numeric work runs on the
solver's device (``cuda`` unless the caller names another); the solver
only sequences it.

Mode repair reads the posterior synchronously: where the JAX package
checks new evidence against a 256-row subsample fetched by a background
thread (possibly one step stale, and different run to run), the port
copies the first 256 rows of the current posterior to the host at the
check, and only when a new range or range-mixture factor touches an old
variable.
"""
from __future__ import annotations

import json
import time
from collections.abc import Mapping
from dataclasses import dataclass, fields
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.variables import Variable, VariableType
from ..factors.factors import (Factor, ImplicitPriorFactor,
                               R2RelativeGaussianLikelihoodFactor,
                               SE2RelativeGaussianLikelihoodFactor,
                               _RangeFactorBase)
from ..factors.mixtures import BinaryFactorMixture
from ..graph.bayes_tree import BayesTree, CliqueNode
from ..graph.factor_graph import FactorGraph, pose_first_ordering
from ..samplers.simulation import SimulationBasedSampler
from ..utils.device import resolve_device
from ..utils.keys import KeyStream
from .posterior_pass import fused_sample_posterior, topological_cliques

# mode repair: posterior rows the check reads; a new range contradicts its
# endpoints when (almost) no sample lies within this many sigma of the
# measured ring; thrash rails: at most this many repaired variables an
# update, and a repaired variable is immune for this many updates after
REPAIR_SNAPSHOT_ROWS = 256
MODE_REPAIR_SIGMA = 4.0
MODE_REPAIR_MAX_PER_STEP = 3
MODE_REPAIR_COOLDOWN = 10
# argument fields holding run-time objects (a solver's meshes), kept out of
# the arguments' JSON as the JAX package keeps them
RUNTIME_FIELDS = ("data_parallel_mesh", "sample_mesh")


@dataclass
class SolverArgs:
    elimination_method: str = "natural"  # natural | pose_first | ccolamd
    posterior_sample_num: int = 500
    local_sample_num: int = 500
    # clique training samples: ancestral simulation ("direct"), or nested
    # sampling of the clique's joint ("nested"; "dynamic nested" runs the
    # static sampler too, as in the JAX package: ROADMAP C3)
    local_sampling_method: str = "direct"
    seed: int = 0
    # evidence-aware recycling (mode repair): when a NEW range factor is
    # inconsistent with the whole committed posterior of its endpoints
    # (no sample within ``MODE_REPAIR_SIGMA`` of the measured ring), the
    # contradicted landmark's cliques are re-eliminated instead of
    # recycled, so their flows retrain against all current evidence
    mode_repair: bool = True

    def json_str(self) -> str:
        return self._json({})

    def _json(self, constants: dict) -> str:
        """The arguments as JSON under the JAX package's keys: settings
        that are constants here (``constants``, and mode repair's) join
        the fields, at their values."""
        d = {f.name: getattr(self, f.name) for f in fields(self)
             if f.name not in RUNTIME_FIELDS}
        d.update(store_clique_samples=False,
                 mode_repair_sigma=MODE_REPAIR_SIGMA,
                 mode_repair_max_per_step=MODE_REPAIR_MAX_PER_STEP,
                 mode_repair_cooldown=MODE_REPAIR_COOLDOWN, **constants)
        return json.dumps(d)


class CliqueSeparatorFactor(ImplicitPriorFactor):
    """Marker base for separator-marginal factors pushed up the tree."""


class ConditionalSampler:
    def conditional_sample_given_observation(self, conditional_dim,
                                             obs_samples=None,
                                             sample_number=None):
        raise NotImplementedError


class FactorGraphSolver:
    """Incremental solver; density modeling is subclass policy."""

    def __init__(self, args: SolverArgs, device=None):
        if args.elimination_method not in ("natural", "pose_first",
                                           "ccolamd"):
            raise NotImplementedError(
                f"elimination method {args.elimination_method!r} is not "
                f"ported; use 'pose_first', 'natural' or 'ccolamd'")
        self._args = args
        self.device = resolve_device(device)
        self._physical_graph = FactorGraph()
        self._working_graph = FactorGraph()
        self._physical_bayes_tree: Optional[BayesTree] = None
        self._working_bayes_tree: Optional[BayesTree] = None
        self._implicit_factors: Dict[CliqueNode, Factor] = {}
        self._samples: Dict[Variable, torch.Tensor] = {}
        self._new_nodes: List[Variable] = []
        self._new_factors: List[Factor] = []
        self._clique_true_obs: Dict[CliqueNode, np.ndarray] = {}
        self._clique_density_model: Dict[CliqueNode, object] = {}
        self._clique_variable_pattern: Dict[CliqueNode, List[Variable]] = {}
        self._elimination_ordering: List[Variable] = []
        self._reverse_ordering_map: Dict[Variable, int] = {}
        self._temp_training_loss: Dict[str, tuple] = {}
        self._keys = KeyStream(args.seed)
        # variables re-eliminated by mode repair, in trigger order (one
        # entry per repaired variable per step)
        self.mode_repair_log: List[str] = []
        self._update_count = 0
        self._repair_cooldown: Dict[Variable, int] = {}
        self._repair_vars: set = set()

    # ------------------------------------------------------------ plumbing
    def _next_key(self):
        """Raw key derived on host."""
        return self._keys()

    def _clock(self) -> float:
        """Host seconds once the device's queued work is done (a
        synchronize on a card), so that a timer measures device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @property
    def elimination_ordering(self) -> List[Variable]:
        return self._elimination_ordering

    @property
    def physical_vars(self) -> List[Variable]:
        return self._physical_graph.vars

    @property
    def physical_factors(self) -> List[Factor]:
        return self._physical_graph.factors

    @property
    def working_vars(self) -> List[Variable]:
        return self._working_graph.vars

    @property
    def working_factors(self) -> List[Factor]:
        return self._working_graph.factors

    @property
    def physical_bayes_tree(self) -> Optional[BayesTree]:
        return self._physical_bayes_tree

    @property
    def working_bayes_tree(self) -> Optional[BayesTree]:
        return self._working_bayes_tree

    def add_node(self, var: Variable) -> "FactorGraphSolver":
        self._new_nodes.append(var)
        return self

    def add_factor(self, factor: Factor) -> "FactorGraphSolver":
        self._new_factors.append(factor)
        return self

    # ------------------------------------------------------------ ordering
    def generate_ordering(self) -> None:
        """The elimination ordering over the physical graph and the new
        nodes.  ``ccolamd`` keeps the previous ordering's variables that
        left the working graph first (their cliques are kept), then orders
        the working graph by constrained minimum degree with its newest
        pose last."""
        method = self._args.elimination_method
        natural = self._physical_graph.vars + self._new_nodes
        if method == "natural":
            self._elimination_ordering = natural
        elif method == "pose_first":
            self._elimination_ordering = pose_first_ordering(natural)
        else:
            working = set(self._working_graph.vars)
            fixed = [v for v in self._elimination_ordering
                     if v not in working]
            poses = [v for v in self._working_graph.vars
                     if v.type == VariableType.Pose]
            self._elimination_ordering = fixed + \
                self._working_graph.analyze_elimination_ordering(
                    "ccolamd", last_vars=[poses[-1]] if poses else None)
        self._reverse_ordering_map = {
            v: i for i, v in enumerate(self._elimination_ordering[::-1])}

    # -------------------------------------------------------- incremental
    def update_physical_and_working_graphs(
            self, timer: Optional[List[float]] = None
    ) -> "FactorGraphSolver":
        """Fold new nodes/factors in, rebuild the working tree over affected
        variables, recycle untouched models; ``timer`` gets the seconds."""
        start = self._clock() if timer is not None else 0.0
        old_nodes = set(self.physical_vars)
        touched = set()
        for f in self._new_factors:
            touched |= set(f.vars)
        touched &= old_nodes
        repaired: set = set()
        self._update_count += 1
        if self._args.mode_repair and self._samples:
            cool = self._repair_cooldown
            repaired = {
                v for v in self._mode_contradicted_vars(old_nodes)
                if self._update_count - cool.get(v, -10 ** 9)
                > MODE_REPAIR_COOLDOWN}
            if len(repaired) > MODE_REPAIR_MAX_PER_STEP:
                repaired = set(sorted(
                    repaired, key=str)[:MODE_REPAIR_MAX_PER_STEP])
            for v in repaired:
                cool[v] = self._update_count
            self.mode_repair_log.extend(
                sorted(str(v.name) for v in repaired))
            touched |= repaired
        self._repair_vars = repaired

        if self._physical_bayes_tree is not None:
            affected, sub_trees = \
                self._physical_bayes_tree.prune_affected(touched,
                                                         deep=repaired)
            # canonical subtree order: it decides separator-prior factor
            # order in the working graph (=> schedules, key assignment)
            sub_trees = sorted(sub_trees, key=lambda t: str(t.root))
            self._working_graph = \
                self._physical_graph.subgraph_with_separator_priors(
                    affected, sub_trees, self._implicit_factors)
        else:
            sub_trees = []
            self._working_graph = FactorGraph()
        for node in self._new_nodes:
            self._working_graph.add_node(node)
        for factor in self._new_factors:
            self._working_graph.add_factor(factor)

        old_ordering = self._elimination_ordering
        self.generate_ordering()
        working_set = set(self.working_vars)
        self._working_bayes_tree = self._working_graph.build_bayes_tree(
            ordering=[v for v in self._elimination_ordering
                      if v in working_set])

        for node in self._new_nodes:
            self._physical_graph.add_node(node)
        for factor in self._new_factors:
            self._physical_graph.add_factor(factor)

        self._physical_bayes_tree = self._working_bayes_tree.copy()
        self._physical_bayes_tree.graft_subtrees(sub_trees)

        # a clique whose FRONTALS are touched by one of this step's factors
        # is never recycled: the stale model predates the new evidence
        new_factor_vars: set = set()
        for f in self._new_factors:
            new_factor_vars |= set(f.vars)
        self._recycle_root_models(old_ordering, no_recycle=repaired,
                                  no_recycle_frontal=new_factor_vars)

        self._new_nodes = []
        self._new_factors = []
        if timer is not None:
            timer.append(self._clock() - start)
        return self

    def _mode_contradicted_vars(self, old_nodes) -> set:
        """Old variables whose committed posterior the NEW evidence cannot
        explain, landmarks first.

        A new range(-mixture) factor with an old endpoint is contradicted
        when, for every hypothesis, (almost) no posterior sample lies
        within ``MODE_REPAIR_SIGMA`` of the measured ring: the 2nd
        percentile of |dist - r|, so a couple of stray samples cannot mask
        a wrong-mode commitment.  New poses are dead-reckoned through the
        new SE(2) and R^2 odometry from committed samples, so a range from
        the current pose to an old landmark is tested too.  The snapshot
        is read (one device-to-host copy) only if such a factor exists."""
        if not any(isinstance(f, (BinaryFactorMixture, _RangeFactorBase))
                   and any(v in old_nodes for v in f.vars)
                   for f in self._new_factors):
            return set()
        col_view = self._snapshot_columns()
        if col_view is None:
            return set()

        dr: Dict[Variable, np.ndarray] = {}

        def lookup(v):
            s = col_view(v)
            return dr.get(v) if s is None else s

        progress = True
        while progress:
            progress = False
            for f in self._new_factors:
                if not isinstance(f, (SE2RelativeGaussianLikelihoodFactor,
                                      R2RelativeGaussianLikelihoodFactor)):
                    continue
                v1, v2 = f.vars[0], f.vars[1]
                s1 = lookup(v1)
                if s1 is None or lookup(v2) is not None:
                    continue
                progress = True
                if isinstance(f, R2RelativeGaussianLikelihoodFactor):
                    dr[v2] = s1[:, :2] + np.asarray(f.obs[:2],
                                                    dtype=s1.dtype)
                    continue
                c, s = np.cos(s1[:, 2]), np.sin(s1[:, 2])
                dx, dy, dth = (float(f.obs[0]), float(f.obs[1]),
                               float(f.obs[2]))
                dr[v2] = np.stack(
                    [s1[:, 0] + c * dx - s * dy,
                     s1[:, 1] + s * dx + c * dy,
                     s1[:, 2] + dth], axis=1)

        specs = []          # (factor, [(v1, v2, r, sigma), ...])
        for f in self._new_factors:
            if isinstance(f, BinaryFactorMixture):
                rings = [(c.vars[0], c.vars[1], float(c.obs[0]),
                          float(c.sigma)) for c in f.components
                         if isinstance(c, _RangeFactorBase)]
            elif isinstance(f, _RangeFactorBase):
                rings = [(f.vars[0], f.vars[1], float(f.obs[0]),
                          float(f.sigma))]
            else:
                continue
            if not rings or any(
                    lookup(v) is None
                    for (v1, v2, _, _) in rings for v in (v1, v2)):
                continue        # an endpoint has neither committed
            if not any(v in old_nodes       # posterior nor dead-reckon
                       for (v1, v2, _, _) in rings for v in (v1, v2)):
                continue        # nothing committed to repair
            specs.append((f, rings))

        out: set = set()
        for f, rings in specs:
            consistent = False
            for (v1, v2, r, sg) in rings:
                d = np.linalg.norm(lookup(v2)[:, :2] - lookup(v1)[:, :2],
                                   axis=1)
                if np.quantile(np.abs(d - r), 0.02) <= \
                        MODE_REPAIR_SIGMA * sg:
                    consistent = True
                    break
            if consistent:
                continue
            for (v1, v2, r, sg) in rings:
                lmks = [v for v in (v1, v2)
                        if v.type == VariableType.Landmark
                        and v in old_nodes]
                out.update(lmks if lmks else
                           (v for v in (v1, v2) if v in old_nodes))
        return out

    def _snapshot_columns(self):
        """Accessor ``v -> (m, v.dim)`` host array over the first
        m = min(256, n) rows of the current posterior, copied one variable
        at a time as the check asks for it; None before the first
        posterior."""
        samples = self._samples
        if not samples:
            return None
        rows = REPAIR_SNAPSHOT_ROWS
        cache: Dict = {}

        def view(v):
            if v not in samples:
                return None
            out = cache.get(v)
            if out is None:
                out = cache[v] = samples[v][:rows].cpu().numpy()
            return out

        return view

    def _recycle_root_models(self, old_ordering: List[Variable],
                             no_recycle: set = frozenset(),
                             no_recycle_frontal: set = frozenset()
                             ) -> None:
        """An old clique that reappears with the same variables and
        in-clique ordering keeps its density model after a
        separator/frontal re-split.  ``no_recycle`` (mode-repaired
        variables) blocks recycling of any old clique containing one, so
        the flow the repair evicted does not come back; ``no_recycle_frontal``
        blocks recycling where one of those variables is frontal."""
        stale = set(self._clique_density_model.keys()) - \
            self._physical_bayes_tree.clique_nodes
        if not stale:
            return
        by_vars: Dict[frozenset, CliqueNode] = {}
        for nc in self._working_bayes_tree.clique_nodes:
            by_vars[frozenset(nc.vars)] = nc
        old_pos = {v: i for i, v in enumerate(old_ordering)}
        new_pos = {v: i for i, v in enumerate(self._elimination_ordering)}
        matches = []
        for old_clique in sorted(stale, key=str):
            if no_recycle & old_clique.vars:
                continue
            new_clique = by_vars.get(frozenset(old_clique.vars))
            if new_clique is None:
                continue
            if no_recycle_frontal & new_clique.frontal:
                continue
            old_cols = sorted(old_clique.vars, key=old_pos.__getitem__)
            new_cols = sorted(new_clique.vars, key=new_pos.__getitem__)
            if old_cols != new_cols:
                continue
            matches.append((old_clique, new_clique))
        # leaf-to-root (deepest first): each without_clique drops a
        # clique's frontals, so a parent goes only after every recycled
        # child whose separator references them; ties str-sorted
        depth: Dict[CliqueNode, int] = {}
        for _, nc in matches:
            d, node = 0, nc
            while node.parent is not None:
                node = node.parent
                d += 1
            depth[nc] = d
        matches.sort(key=lambda on: (-depth[on[1]], str(on[0])))
        for old_clique, new_clique in matches:
            # a working-graph factor touching the frontals from outside
            # the clique would dangle after elimination: retrain instead
            frontal = new_clique.frontal
            cvars = new_clique.vars
            if any((set(f.vars) & frontal) and
                   not set(f.vars).issubset(cvars)
                   for f in self._working_graph.factors):
                continue
            self._clique_true_obs[new_clique] = \
                self._clique_true_obs[old_clique]
            if old_clique in self._clique_variable_pattern:
                self._clique_variable_pattern[new_clique] = \
                    self._clique_variable_pattern[old_clique]
            model = self.root_clique_density_model_to_leaf(old_clique,
                                                           new_clique)
            self._clique_density_model[new_clique] = model
            self._finish_clique(new_clique, model)
        for old_clique in stale:
            self._clique_density_model.pop(old_clique, None)
            self._clique_true_obs.pop(old_clique, None)
            self._clique_variable_pattern.pop(old_clique, None)

    # ----------------------------------------------------------- inference
    def incremental_inference(self, timer: Optional[List[float]] = None,
                              clique_dim_timer: Optional[List] = None
                              ) -> Mapping:
        """Fit the working tree, then draw the posterior.  ``timer`` gets
        the seconds of each clique's simulation and training and of the
        posterior pass, in that order; ``clique_dim_timer`` a [dim, seconds
        since the fit began] pair as each clique is done."""
        self.fit_tree_density_models(timer=timer,
                                     clique_dim_timer=clique_dim_timer)
        self._samples = self.sample_posterior(timer=timer)
        return self._samples

    def fit_clique_density_model(self, clique, samples, var_ordering,
                                 timer=None) -> "ConditionalSampler":
        raise NotImplementedError

    def try_load_clique_model(self, clique):
        """(model, true observations) of a clique from a checkpoint store,
        or None to simulate and train it (subclass policy)."""
        return None

    def root_clique_density_model_to_leaf(self, old_clique, new_clique):
        raise NotImplementedError

    def clique_density_to_separator_factor(self, separator_var_list,
                                           density_model, true_obs):
        raise NotImplementedError

    def _evict_stale_value_matches(self) -> None:
        """Evict models claimed by value-identical re-formed cliques:
        ``CliqueNode`` equality is by variable content, so a working-tree
        clique re-formed with the same frontal/separator sets hits its
        pre-update model.  A re-form still has non-separator factors
        touching its frontals (recycling eliminated them); drop its model
        so it retrains."""
        if self._working_bayes_tree is None:
            return
        for clique in list(self._working_bayes_tree.clique_nodes):
            if clique not in self._clique_density_model:
                continue
            sub = self._working_graph.clique_subgraph(clique)
            live = any(
                (set(f.vars) & clique.frontal)
                and not isinstance(f, CliqueSeparatorFactor)
                for f in sub.factors)
            if live:
                self._clique_density_model.pop(clique, None)
                self._clique_true_obs.pop(clique, None)
                self._clique_variable_pattern.pop(clique, None)

    def fit_tree_density_models(self, timer: Optional[List[float]] = None,
                                clique_dim_timer: Optional[List] = None
                                ) -> None:
        """Leaves-to-root clique loop: load from the checkpoint store or
        simulate and fit, push the separator marginal up as a prior
        factor.  Timers as ``incremental_inference``'s."""
        self._temp_training_loss = {}
        self._evict_stale_value_matches()
        clique_ordering = self._working_bayes_tree.clique_ordering()
        t_begin = self._clock() if clique_dim_timer is not None else 0.0
        while clique_ordering:
            clique = clique_ordering.pop()
            if clique not in self._clique_density_model:
                restored = self.try_load_clique_model(clique)
                if restored is not None:
                    model, true_obs = restored
                else:
                    t0 = self._clock() if timer is not None else 0.0
                    local_samples, sample_var_ordering, true_obs = \
                        self.clique_training_sampler(
                            clique, num_samples=self._args.local_sample_num)
                    if timer is not None:
                        timer.append(self._clock() - t0)
                    model = self.fit_clique_density_model(
                        clique=clique, samples=local_samples,
                        var_ordering=sample_var_ordering, timer=timer)
                self._clique_true_obs[clique] = true_obs
                self._clique_density_model[clique] = model
                self._finish_clique(clique, model)
            if clique_dim_timer is not None:
                clique_dim_timer.append([clique.dim,
                                         self._clock() - t_begin])

    def _finish_clique(self, clique: CliqueNode, model) -> None:
        """Push the clique's separator marginal up as a prior factor and
        eliminate the clique from the working graph."""
        new_sep_factor = None
        if clique.separator:
            sep_list = sorted(
                clique.separator,
                key=lambda v: self._reverse_ordering_map[v])
            new_sep_factor = self.clique_density_to_separator_factor(
                sep_list, model, self._clique_true_obs[clique])
            self._implicit_factors[clique] = new_sep_factor
        self._working_graph = self._working_graph.without_clique(
            clique=clique, new_factor=new_sep_factor)

    def clique_training_sampler(self, clique: CliqueNode, num_samples: int):
        """Training samples for one clique, by ``local_sampling_method``:
        (samples on the solver's device, their variable order, the
        observations the samples leave unused)."""
        subgraph = self._working_graph.clique_subgraph(clique)
        pattern = self._working_bayes_tree.clique_variable_pattern(clique)
        method = self._args.local_sampling_method
        if method == "direct":
            sampler = SimulationBasedSampler(factors=subgraph.factors,
                                             vars=pattern,
                                             device=self.device)
            return sampler.sample(self._next_key(), num_samples)
        if method in ("nested", "dynamic nested"):
            from .nested_adapter import nested_clique_samples
            samples = nested_clique_samples(
                self._next_key(), pattern, subgraph.factors, num_samples,
                dynamic=(method == "dynamic nested"), device=self.device)
            return (torch.as_tensor(samples, device=self.device), pattern,
                    np.array([]))
        raise ValueError(f"Unknown sampling method {method}")

    def sample_posterior(self, timer: Optional[List[float]] = None
                         ) -> Mapping:
        """Root-to-leaf conditional sampling of the physical tree: the
        fused pass (``posterior_pass.py``) when every clique's model is a
        flow, else the per-clique walk.  Returns Variable -> (n, dim)
        tensors on the solver's device; the fused pass's are read-only
        views of one buffer.  ``timer`` gets the seconds."""
        start = self._clock() if timer is not None else 0.0
        samples = fused_sample_posterior(self,
                                         self._args.posterior_sample_num)
        if samples is None:
            samples = self.sample_posterior_per_clique()
        if timer is not None:
            timer.append(self._clock() - start)
        return samples

    def training_losses(self) -> Dict[str, List[float]]:
        """The last fit's loss curve of each trained clique, by its sorted
        variable names (one copy to the host a clique)."""
        return {name: [float(v) for v in
                       iter_loss[:int(n_iters)].cpu().tolist()]
                for name, (iter_loss, n_iters) in
                self._temp_training_loss.items()}

    def sample_posterior_per_clique(self) -> Dict[Variable, torch.Tensor]:
        """Root-to-leaf conditional sampling, one clique at a time: each
        clique draws its frontals given [observations | separator samples]
        already drawn above it.  Takes one key a clique in the fused pass's
        order, so on the same key stream both give the same samples."""
        num_samples = self._args.posterior_sample_num
        samples: Dict[Variable, torch.Tensor] = {}
        for clique in topological_cliques(self._physical_bayes_tree.root):
            frontal_list = sorted(
                clique.frontal, key=lambda v: self._reverse_ordering_map[v])
            separator_list = sorted(
                clique.separator,
                key=lambda v: self._reverse_ordering_map[v])
            model = self._clique_density_model[clique]
            obs = self._clique_true_obs[clique]

            blocks = []
            if len(obs) != 0:
                blocks.append(torch.as_tensor(
                    np.asarray(obs, np.float32), device=self.device
                ).expand(num_samples, len(obs)))
            for v in separator_list:
                blocks.append(samples[v])
            if blocks:
                frontal = model.conditional_sample_given_observation(
                    conditional_dim=clique.frontal_dim,
                    obs_samples=torch.cat(blocks, dim=1))
            else:
                frontal = model.conditional_sample_given_observation(
                    conditional_dim=clique.frontal_dim,
                    sample_number=num_samples)
            cur = 0
            for v in frontal_list:
                samples[v] = frontal[:, cur:cur + v.dim]
                cur += v.dim
        return samples
