"""Incremental batching of parsed factor graphs.

Splits (nodes, factors) into per-step batches for incremental replay,
emitting each factor as soon as all its endpoints exist; the counterpart
of ``nfisam_tpu/io/runbatch.py``.  An ambiguous-data-association factor
arrives with its observer (its root variable); its candidates must all be
in the graph by then.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.variables import Variable, VariableType
from ..factors.factors import (BinaryFactor, Factor, PriorFactor,
                               SE2RelativeGaussianLikelihoodFactor,
                               UnaryFactor)
from ..factors.mixtures import AmbiguousDataAssociationFactor
from .fg_io import read_factor_graph_from_file

StepBatch = Tuple[List[Variable], List[Factor]]


def graph_file_parser(data_file: str, data_format: str = "fg",
                      prior_cov_scale: float = 0.1):
    """(nodes, truth, factors) of a ``.fg`` file, or of a g2o / TORO pose
    graph with a prior of ``prior_cov_scale`` I anchoring its first node."""
    if data_format == "fg":
        return read_factor_graph_from_file(data_file)
    if data_format in ("g2o", "toro"):
        from .g2o import G2oToroPoseGraphReader
        nodes, factors, truth = G2oToroPoseGraphReader(
            data_file).data_for_solver(prior_cov_scale=prior_cov_scale)
        return nodes, truth, factors
    raise ValueError(f"Unknown data format {data_format}")


def group_nodes_factors_incrementally(
        nodes: List[Variable], factors: List[Factor],
        incremental_step: Optional[int] = None,
        multirobot: bool = True) -> List[StepBatch]:
    if multirobot and _names_look_multirobot(nodes):
        return _group_multirobot(nodes, factors, incremental_step)
    return _group_single_robot(nodes, factors, incremental_step)


def _names_look_multirobot(nodes: List[Variable]) -> bool:
    """Pose names like ``A12`` (robot letter + step index)."""
    for v in nodes:
        if v.type == VariableType.Pose:
            name = str(v.name)
            if not (len(name) > 1 and name[1:].isdigit()):
                return False
    return True


def _split_factors(factors):
    """(pose-pose, pose-landmark, data-association) factors; unary ones
    are skipped and anything else raises."""
    p2p, p2l, ada = [], [], []
    for f in factors:
        if isinstance(f, UnaryFactor):
            continue
        if isinstance(f, AmbiguousDataAssociationFactor):
            ada.append(f)
        elif not isinstance(f, BinaryFactor):
            raise ValueError("Unsupported factor: " + str(f))
        elif f.var1.type == f.var2.type == VariableType.Pose:
            p2p.append(f)
        elif (f.var1.type == VariableType.Pose and
              f.var2.type == VariableType.Landmark):
            p2l.append(f)
        else:
            raise ValueError("Unsupported factor endpoints: " + str(f))
    return p2p, p2l, ada


def _group_single_robot(nodes, factors, incremental_step):
    rbt_nodes = [v for v in nodes if v.type == VariableType.Pose]
    if not incremental_step or incremental_step > len(rbt_nodes) or \
            incremental_step <= 0:
        incremental_step = len(rbt_nodes)

    priors = [f for f in factors if isinstance(f, UnaryFactor)]
    p2p, p2l, ada = _split_factors(factors)

    batches: List[StepBatch] = []
    new_vars: List[Variable] = []
    new_factors: List[Factor] = []
    added_rbts, added_lmks = set(), set()
    for k, rbt in enumerate(rbt_nodes):
        new_vars.append(rbt)
        added_rbts.add(rbt)
        take = [f for f in priors if f.vars[0] == rbt]
        priors = [f for f in priors if f not in take]
        new_factors += take

        take = [f for f in p2p if set(f.vars).issubset(added_rbts)]
        p2p = [f for f in p2p if f not in take]
        new_factors += take

        take = [f for f in p2l if f.var1 == rbt]
        for f in take:
            if f.var2 not in added_lmks:
                added_lmks.add(f.var2)
                new_vars.append(f.var2)
        p2l = [f for f in p2l if f not in take]
        new_factors += take

        take = [f for f in ada if f.root_var == rbt]
        for f in take:
            kids = set(f.child_vars)
            if not (kids.issubset(added_rbts) or kids.issubset(added_lmks)):
                raise ValueError("ADA factor references future vars: "
                                 + str(f))
        ada = [f for f in ada if f not in take]
        new_factors += take

        # priors on just-added landmarks
        take = [f for f in priors if f.vars[0] in new_vars]
        priors = [f for f in priors if f not in take]
        new_factors += take

        if (k + 1) % incremental_step == 0 or k == len(rbt_nodes) - 1:
            batches.append((list(new_vars), list(new_factors)))
            new_vars, new_factors = [], []
    return batches


def _group_multirobot(nodes, factors, incremental_step):
    """Pose names encode robot id + time step (``A12`` -> robot A, t=12);
    one batch bundles all robots' poses for ``incremental_step`` steps."""
    per_robot: Dict[str, List[Tuple[int, Variable]]] = {}
    max_step = 0
    for v in nodes:
        if v.type == VariableType.Pose:
            rid, step = str(v.name)[0], int(str(v.name)[1:])
            per_robot.setdefault(rid, []).append((step, v))
            max_step = max(max_step, step)
    for rid in per_robot:
        per_robot[rid].sort(key=lambda p: p[0])

    var2factors: Dict[Variable, Dict[str, List[Factor]]] = {}

    def push(var, kind, f):
        var2factors.setdefault(var, {}).setdefault(kind, []).append(f)

    pose_pose = {id(f) for f in _split_factors(factors)[0]}
    for f in factors:
        if isinstance(f, UnaryFactor):
            push(f.vars[0], "prior", f)
        elif isinstance(f, AmbiguousDataAssociationFactor):
            kind = ("pose_obsv" if f.child_vars[0].type == VariableType.Pose
                    else "lmk_obsv")
            push(f.root_var, kind, f)
        elif id(f) in pose_pose:
            if isinstance(f, SE2RelativeGaussianLikelihoodFactor) and \
                    str(f.var1.name)[0] == str(f.var2.name)[0] and \
                    int(str(f.var2.name)[1:]) - \
                    int(str(f.var1.name)[1:]) == 1:
                push(f.var2, "odom", f)
            else:
                push(f.var1, "pose_obsv", f)
        else:
            push(f.var1, "lmk_obsv", f)

    if not incremental_step or incremental_step > max_step + 1 or \
            incremental_step <= 0:
        incremental_step = max_step + 1

    batches: List[StepBatch] = []
    new_vars: List[Variable] = []
    new_factors: List[Factor] = []
    added_lmks = set()
    for t in range(max_step + 1):
        for rid, steps in per_robot.items():
            match = [v for (s, v) in steps if s == t]
            for var in match:
                new_vars.append(var)
                groups = var2factors.get(var, {})
                for fs in groups.values():
                    new_factors += fs
                for f in groups.get("lmk_obsv", []):
                    for lmk in f.vars[1:]:
                        if lmk.type == VariableType.Landmark and \
                                lmk not in added_lmks:
                            added_lmks.add(lmk)
                            new_vars.append(lmk)
                            lmk_groups = var2factors.get(lmk, {})
                            new_factors += lmk_groups.get("prior", [])
        if (t + 1) % incremental_step == 0 or t == max_step:
            batches.append((list(new_vars), list(new_factors)))
            new_vars, new_factors = [], []
    return batches


def inc_var_factor_to_dead_reckoning(
        nodes_factors_by_step: List[StepBatch]) -> "np.ndarray":
    """Dead-reckoned robot path from incremental batches: each SE(2)
    prior starts a chain, each odometry factor from the chain's last pose
    composes its mean onto it (float32, as the JAX package), with no
    inference; returns the (T, 2) float64 x/y of the poses reached."""
    import numpy as np
    import torch

    from ..core.geometry import se2_compose

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32))

    rbt_vars: List[Variable] = []
    var2pose: Dict[Variable, torch.Tensor] = {}
    for _, step_factors in nodes_factors_by_step:
        for f in step_factors:
            if isinstance(f, PriorFactor) and len(f.vars) == 1 and \
                    f.vars[0].dim == 3:
                var2pose[f.vars[0]] = f32(f.observation)
                rbt_vars.append(f.vars[0])
            elif isinstance(f, SE2RelativeGaussianLikelihoodFactor) and \
                    rbt_vars and f.var1 == rbt_vars[-1]:
                var2pose[f.var2] = se2_compose(var2pose[f.var1],
                                               f32(f.observation))
                rbt_vars.append(f.var2)
    return np.asarray([var2pose[v][:2].numpy() for v in rbt_vars],
                      dtype=np.float64).reshape(-1, 2)
