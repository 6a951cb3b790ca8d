"""The port's data-association path against the JAX package's, on the CPU.

- Batching: ``group_nodes_factors_incrementally`` gives the same per-step
  node names and factor strings on case1_da (one pose a step),
  plaza1_ada0.2 (five a step) and a multi-robot graph with both kinds of
  ambiguous factor (landmark candidates and pose candidates).
- Stream policy: ``defer_ambiguous`` gives the same stream on
  plaza1_ada0.6 (five poses a step).
- Schedules and the solve: case1_da (6 steps) and plaza1_ada0.2's first
  3 steps solved by both packages' ``ParallelNFiSAM`` at the reduced
  settings of ``test_torch_solver.py`` with mode repair off.  Every
  clique's simulation schedule (op kinds, factors by text, drawn
  variables, flow column ordering, true observations), every step's
  trees and trained cliques must agree exactly; the port's samples are
  finite and shaped.  Exact comparisons: no tolerance.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_ada.py``,
it solves plaza1_ada0.2's first 5 steps with the JAX package's
``ParallelNFiSAM`` at ``chip_smoke.PLAZA_ADA_ARGS`` (mode repair on) on
the CPU and prints the max posterior-mean translation error after each
step: the reference for how deep the card's prefix must be to hold its
15 m gate."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import nfisam_tpu.samplers.simulation as j_simulation  # noqa: E402
import nfisam_tpu_torch.samplers.simulation as t_simulation  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.io.stream_policy import defer_ambiguous as j_defer  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.io import (defer_ambiguous, graph_file_parser,  # noqa: E402
                                 group_nodes_factors_incrementally)
from nfisam_tpu_torch.parallel import ParallelNFiSAM  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAMArgs  # noqa: E402
from test_torch_solver import SMALL, _solve  # noqa: E402

torch.set_num_threads(1)
DATA = os.path.join(REPO, "data")
PLAZA_ADA = chip_smoke.PLAZA_ADA_FG
PLAZA_ADA_STEPS = 3


def _stream(batches):
    return [([str(v.name) for v in ns], [str(f) for f in fs])
            for ns, fs in batches]


def _both_streams(path, step):
    nodes, _, factors = graph_file_parser(path)
    ours = group_nodes_factors_incrementally(nodes, factors, step)
    nodes, _, factors = j_parse(path, "fg")
    theirs = j_group(nodes, factors, incremental_step=step)
    return ours, theirs


@pytest.mark.parametrize("name,step", [("case1_da_factor_graph.fg", 1),
                                       ("plaza1_ada0.2_factor_graph.fg", 5)])
def test_batches_match_jax(name, step):
    ours, theirs = _both_streams(os.path.join(DATA, name), step)
    assert _stream(ours) == _stream(theirs)
    assert any("Ambiguous" in f for _, fs in _stream(ours) for f in fs)


MULTI_ROBOT_FG = """\
Variable Pose SE2 A0 0.0 0.0 0.0
Variable Pose SE2 A1 5.0 0.0 0.0
Variable Pose SE2 A2 10.0 0.0 0.0
Variable Pose SE2 B0 0.0 10.0 0.0
Variable Pose SE2 B1 5.0 10.0 0.0
Variable Pose SE2 B2 10.0 10.0 0.0
Variable Landmark R2 L1 5.0 5.0
Variable Landmark R2 L2 12.0 5.0
Factor UnarySE2ApproximateGaussianPriorFactor A0 0.0 0.0 0.0 covariance 0.01 0.0 0.0 0.0 0.01 0.0 0.0 0.0 0.001
Factor UnarySE2ApproximateGaussianPriorFactor B0 0.0 10.0 0.0 covariance 0.01 0.0 0.0 0.0 0.01 0.0 0.0 0.0 0.001
Factor SE2RelativeGaussianLikelihoodFactor A0 A1 5.0 0.0 0.0 covariance 0.01 0.0 0.0 0.0 0.01 0.0 0.0 0.0 0.001
Factor SE2RelativeGaussianLikelihoodFactor A1 A2 5.0 0.0 0.0 covariance 0.01 0.0 0.0 0.0 0.01 0.0 0.0 0.0 0.001
Factor SE2RelativeGaussianLikelihoodFactor B0 B1 5.0 0.0 0.0 covariance 0.01 0.0 0.0 0.0 0.01 0.0 0.0 0.0 0.001
Factor SE2RelativeGaussianLikelihoodFactor B1 B2 5.0 0.0 0.0 covariance 0.01 0.0 0.0 0.0 0.01 0.0 0.0 0.0 0.001
Factor SE2R2RangeGaussianLikelihoodFactor A0 L1 7.0710678 0.3
Factor AmbiguousDataAssociationFactor Observer A1 Observed L1 L2 Weights 0.5 0.5 Binary SE2R2RangeGaussianLikelihoodFactor Observation 5.0 Sigma 0.3
Factor AmbiguousDataAssociationFactor Observer B2 Observed A1 A2 Weights 0.4 0.6 Binary SE2R2RangeGaussianLikelihoodFactor Observation 10.0 Sigma 0.3
Factor SE2R2RangeGaussianLikelihoodFactor B1 L2 8.6023253 0.3
"""


def test_multi_robot_batches_match_jax(tmp_path):
    """A landmark-candidate DA factor arrives with its observer and brings
    its landmarks in (``lmk_obsv``); a pose-candidate one arrives with its
    observer (``pose_obsv``)."""
    path = tmp_path / "multi_robot_ada.fg"
    path.write_text(MULTI_ROBOT_FG)
    ours, theirs = _both_streams(str(path), 1)
    assert _stream(ours) == _stream(theirs)
    assert len(ours) == 3


def test_defer_ambiguous_matches_jax():
    ours, theirs = _both_streams(os.path.join(DATA,
                                              "plaza1_ada0.6_factor_graph.fg"),
                                 5)
    ours_d, theirs_d = _stream(defer_ambiguous(ours)), \
        _stream(j_defer(theirs))
    assert ours_d == theirs_d
    # the same factors as the undeferred stream, some later
    assert sorted(f for _, fs in ours_d for f in fs) == \
        sorted(f for _, fs in _stream(ours) for f in fs)
    assert ours_d != _stream(ours)


def _schedule_summary(schedule):
    return ([op.kind for op in schedule.ops],
            [str(op.factor) for op in schedule.ops],
            [None if op.out_var is None else str(op.out_var.name)
             for op in schedule.ops],
            [str(v.name) for v in schedule.var_ordering],
            schedule.unused_obs.tolist())


def _recorded_solve(solver, batches, to_numpy, module):
    """``_solve`` with every clique schedule the solve compiles recorded."""
    log = []
    compile_fn = module.compile_schedule

    def recording(factors, pattern):
        schedule = compile_fn(factors, pattern)
        log.append(_schedule_summary(schedule))
        return schedule

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "compile_schedule", recording)
        steps, solver = _solve(solver, batches, to_numpy)
    return steps, solver, log


def _solve_both(path, step, n_steps=None):
    nodes, _, factors = j_parse(path, "fg")
    batches = j_group(nodes, factors, incremental_step=step)[:n_steps]
    theirs = _recorded_solve(JParallel(JNFiSAMArgs(**SMALL)), batches,
                             np.asarray, j_simulation)
    nodes, _, factors = graph_file_parser(path)
    batches = group_nodes_factors_incrementally(nodes, factors,
                                                step)[:n_steps]
    ours = _recorded_solve(ParallelNFiSAM(NFiSAMArgs(**SMALL), device="cpu"),
                           batches, lambda x: x.numpy(), t_simulation)
    return ours, theirs


@pytest.fixture(scope="module")
def runs():
    return {"case1_da": _solve_both(chip_smoke.CASE1_DA_FG, 1),
            "plaza1_ada0.2": _solve_both(PLAZA_ADA, 5, PLAZA_ADA_STEPS)}


@pytest.mark.parametrize("which", ["case1_da", "plaza1_ada0.2"])
def test_clique_schedules_match_jax(runs, which):
    ours, theirs = runs[which]
    assert ours[2] == theirs[2]
    kinds = {k for summary in ours[2] for k in summary[0]}
    assert {"observe_da", "sample_observer"} & kinds


@pytest.mark.parametrize("which", ["case1_da", "plaza1_ada0.2"])
def test_solve_matches_jax_structure(runs, which):
    ours, theirs = runs[which]
    assert len(ours[0]) == len(theirs[0])
    for a, b in zip(ours[0], theirs[0]):
        assert a["working"] == b["working"]
        assert a["physical"] == b["physical"]
        assert a["trained"] == b["trained"]
        assert sorted(a["samples"]) == sorted(b["samples"])
    assert ours[1].bucket_log == theirs[1].bucket_log
    for step in ours[0]:
        for x in step["samples"].values():
            assert x.shape[0] == SMALL["posterior_sample_num"]
            assert np.isfinite(x).all()


if __name__ == "__main__":
    # the JAX package's ParallelNFiSAM on plaza1_ada0.2's first
    # chip_smoke.PLAZA_ADA_STEPS steps at the card's configuration
    # (PLAZA_ADA_ARGS, mode repair on), on the CPU: the max posterior-mean
    # translation error after each step, the reference for the depth at
    # which the card's 15 m gate can hold
    import jax
    jax.config.update("jax_platforms", "cpu")
    nodes, truth, factors = j_parse(chip_smoke.PLAZA_ADA_FG, "fg")
    truth = {str(v.name): np.asarray(t) for v, t in truth.items()}
    solver = JParallel(JNFiSAMArgs(**chip_smoke.PLAZA_ADA_ARGS))
    for i, (ns, fs) in enumerate(j_group(nodes, factors, incremental_step=5)
                                 [:chip_smoke.PLAZA_ADA_STEPS]):
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        samples = solver.incremental_inference()
        worst, rmse = chip_smoke.translation_errors(
            {str(v.name): np.asarray(x)
             for v, x in samples.materialize().items()}, truth)
        print(f"JAX on CPU, plaza1_ada0.2 after step {i + 1}: max "
              f"posterior-mean translation error {worst:.3f} m, RMSE "
              f"{rmse:.3f} m (gate {chip_smoke.PLAZA_GATE_M} m)", flush=True)
