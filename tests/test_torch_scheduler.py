"""The port's wavefront scheduler and ``ParallelNFiSAM`` against the JAX
package's, on the CPU at the reduced settings of ``test_torch_solver.py``
(mode repair off in both): the waves of a hand-built tree, then case1 (6
steps) and the first 2 incremental steps of plaza1 solved by both
packages.  Trees, trained cliques and the bucket log must agree exactly;
the posteriors in distribution (the bounds of ``test_torch_solver.py``).
A graph of disjoint robots fills the batched trainer's buckets.

Run as a script, ``python tests/test_torch_scheduler.py``, it solves the
first ``chip_smoke.PLAZA_STEPS`` incremental steps of plaza1 (or as many
as ``jax_plaza_reference`` is given) with the JAX package's
``ParallelNFiSAM`` on the CPU at ``chip_smoke.py``'s plaza configuration
(mode repair off) and prints the posterior-mean translation error against
the ground truth: the reference point for the port's plaza1 gate on the
card."""
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import nfisam_tpu.core as jcore  # noqa: E402
import nfisam_tpu.factors as jfactors  # noqa: E402
import nfisam_tpu.graph as jgraph  # noqa: E402
import nfisam_tpu_torch.core as tcore  # noqa: E402
import nfisam_tpu_torch.factors as tfactors  # noqa: E402
import nfisam_tpu_torch.graph as tgraph  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.parallel import wavefronts as j_wavefronts  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.eval import mmd  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.parallel import ParallelNFiSAM, wavefronts  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAMArgs  # noqa: E402
from test_torch_solver import CASE1_POSE_GAP_M, SMALL, _solve  # noqa: E402

torch.set_num_threads(1)
PLAZA_STEPS = 2


def _tree_waves(core, graph, wavefronts_fn):
    """The five-clique tree of ``test_scheduler.py``'s wavefront test, in
    one package; returns its waves as sorted frontal names."""
    A, B, C, D, E = (core.SE2Variable(n) for n in "ABCDE")
    root = graph.CliqueNode(frontal={E})
    c1 = graph.CliqueNode(frontal={C}, separator={E})
    c2 = graph.CliqueNode(frontal={D}, separator={E})
    c3 = graph.CliqueNode(frontal={A}, separator={C})
    c4 = graph.CliqueNode(frontal={B}, separator={C})
    root.attach_child(c1)
    root.attach_child(c2)
    c1.attach_child(c3)
    c1.attach_child(c4)
    tree = graph.BayesTree(root=root)
    waves = wavefronts_fn(tree.clique_ordering(), {})
    skip = wavefronts_fn(tree.clique_ordering(), {c3: object()})
    return [[sorted(str(v.name) for v in c.frontal) for c in w]
            for w in (*waves, *skip)]


def test_wavefronts_match_jax():
    ours = _tree_waves(tcore, tgraph, wavefronts)
    theirs = _tree_waves(jcore, jgraph, j_wavefronts)
    assert ours == theirs
    assert [len(w) for w in ours[:3]] == [3, 1, 1]


def _structure(run, step):
    s = run[0][step]
    return s["working"], s["physical"], s["trained"], sorted(s["samples"])


def _solve_both(path, step, n_steps=None):
    """JAX's and the port's ParallelNFiSAM on the first ``n_steps``
    incremental steps of a ``.fg`` (all by default), grouped ``step``
    poses a step."""
    nodes, _, factors = j_parse(path, "fg")
    batches = j_group(nodes, factors, incremental_step=step)[:n_steps]
    jax_run = _solve(JParallel(JNFiSAMArgs(**SMALL)), batches, np.asarray)
    nodes, _, factors = graph_file_parser(path)
    batches = group_nodes_factors_incrementally(nodes, factors,
                                                step)[:n_steps]
    torch_run = _solve(ParallelNFiSAM(NFiSAMArgs(**SMALL), device="cpu"),
                       batches, lambda x: x.numpy())
    return jax_run, torch_run


@pytest.fixture(scope="module")
def case1_runs():
    return _solve_both(chip_smoke.CASE1_FG, 1)


@pytest.fixture(scope="module")
def plaza_runs():
    """Plaza1 grouped 5 poses a step, as the plaza runs group it."""
    return _solve_both(chip_smoke.PLAZA1_FG, 5, PLAZA_STEPS)


@pytest.mark.parametrize("step", range(6))
def test_case1_structure_matches_jax(case1_runs, step):
    jax_run, torch_run = case1_runs
    assert _structure(torch_run, step) == _structure(jax_run, step)


@pytest.mark.parametrize("step", range(PLAZA_STEPS))
def test_plaza1_structure_matches_jax(plaza_runs, step):
    jax_run, torch_run = plaza_runs
    assert _structure(torch_run, step) == _structure(jax_run, step)


@pytest.mark.parametrize("which", ["case1", "plaza1"])
def test_bucket_log_matches_jax(case1_runs, plaza_runs, which):
    jax_run, torch_run = case1_runs if which == "case1" else plaza_runs
    assert torch_run[1].bucket_log == jax_run[1].bucket_log
    assert torch_run[1].host_trained_cliques == []


def _posterior_bounds(ours, theirs, pose_gap: float):
    """``test_torch_solver``'s bounds: every pose's posterior mean within
    ``pose_gap`` of JAX's, every landmark's within 12 m, joint translation
    MMD below 0.15.  A landmark still on its range ring (a JAX posterior std
    above 12 m on an axis: plaza1's first steps leave three of its four
    landmarks on 30-40 m rings) has no mean to compare and is left to the
    joint MMD."""
    for name in ours:
        if theirs[name][:, :2].std(0).max() > 12.0:
            continue
        gap = np.linalg.norm(ours[name][:, :2].mean(0) -
                             theirs[name][:, :2].mean(0))
        assert gap < (12.0 if name.startswith("L") else pose_gap), \
            (name, gap)
    names = sorted(ours)
    joint = mmd(np.hstack([ours[n][:, :2] for n in names]),
                np.hstack([theirs[n][:, :2] for n in names]))
    assert joint < 0.15


@pytest.mark.parametrize("which", ["case1", "plaza1"])
def test_posterior_matches_jax_in_distribution(case1_runs, plaza_runs,
                                               which):
    """Case1's poses within ``CASE1_POSE_GAP_M`` (the JAX package's own
    spread between its seeds), plaza1's within 3 m."""
    jax_run, torch_run = case1_runs if which == "case1" else plaza_runs
    _posterior_bounds(torch_run[0][-1]["samples"],
                      jax_run[0][-1]["samples"],
                      CASE1_POSE_GAP_M if which == "case1" else 3.0)
    for step in torch_run[0]:
        for x in step["samples"].values():
            assert x.shape[0] == SMALL["posterior_sample_num"]
            assert np.isfinite(x).all()


def _multi_robot_graph(core, factors, R, T):
    """``test_scheduler.py``'s disjoint robots, in one package: R chains
    of T poses, each with its own landmark ranged from its last pose."""
    vars_, fs = [], []
    cov3 = np.diag([0.01, 0.01, 0.001])
    for r in range(R):
        xs = [core.SE2Variable(f"{chr(65 + r)}{t}") for t in range(T)]
        lm = core.R2Variable(f"L{r}", core.VariableType.Landmark)
        vars_ += xs + [lm]
        fs.append(factors.UnarySE2ApproximateGaussianPriorFactor(
            xs[0], np.array([20.0 * r, 0, 0]), cov3))
        for a, b in zip(xs, xs[1:]):
            fs.append(factors.SE2RelativeGaussianLikelihoodFactor(
                a, b, np.array([5.0, 0, 0]), cov3))
        fs.append(factors.SE2R2RangeGaussianLikelihoodFactor(
            xs[-1], lm, 5.0, 0.5))
    return vars_, fs


def _one_step(solver, vars_, fs):
    for v in vars_:
        solver.add_node(v)
    for f in fs:
        solver.add_factor(f)
    solver.update_physical_and_working_graphs()
    solver.incremental_inference()
    return solver


def test_multi_robot_buckets_reach_four_in_both():
    """Four disjoint robots: each wave holds one same-signature clique a
    robot, so both packages train buckets of 4 (the port through
    ``fit_flows_batched``), with the same bucket log."""
    args = {**SMALL, "flow_iterations": 30}
    ours = _one_step(ParallelNFiSAM(NFiSAMArgs(**args), device="cpu"),
                     *_multi_robot_graph(tcore, tfactors, 4, 3))
    theirs = _one_step(JParallel(JNFiSAMArgs(**args)),
                       *_multi_robot_graph(jcore, jfactors, 4, 3))
    assert max(b for _, _, b in ours.bucket_log) == 4
    assert ours.bucket_log == theirs.bucket_log
    assert sorted(ours._temp_training_loss) == \
        sorted(theirs._temp_training_loss)


def test_chip_smoke_paths_run_on_cpu_at_small_size():
    """``chip_smoke.py``'s plaza1, robots, mode-repair, separator-trap,
    case1_da, plaza1_ada0.2, MAP-floor and Manhattan-scale paths, and its
    fused-pass check, driven on the CPU at a small size: one plaza1 step,
    two robots of three poses, two plaza1_ada0.2 steps, 30 Adam
    iterations; the prefixes' floors, the full g16 floor, case1's
    Laplace MAP and the MAP's product timing; three Manhattan g8 steps."""
    small = dict(local_sample_num=200, flow_iterations=30,
                 posterior_sample_num=300)
    _, steps, samples, truth, _, solver, launches = chip_smoke.plaza_prefix(
        "plaza1", 1, "cpu", **{**chip_smoke.PLAZA_ARGS, **small})
    assert steps[0]["trained"] == 4 and steps[0]["launches"] == 0
    assert launches == 0 and not solver._args.mode_repair
    worst, rmse = chip_smoke.translation_errors(samples, truth)
    assert np.isfinite([worst, rmse]).all() and len(samples) == 9
    assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0
    moments, solvers = [], []
    for parallel in (True, False):
        _, samples, solver = chip_smoke.solve_robots("cpu", parallel, R=2,
                                                     T=3, **small)
        moments.append(chip_smoke.range_moments(samples, R=2, T=3))
        solvers.append(solver)
        assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0
    assert max(b for _, _, b in solvers[0].bucket_log) == 2
    assert moments[0].shape == moments[1].shape == (2, 2)
    assert np.isfinite(moments).all()
    # the mode-repair graph, case1_da and two plaza1_ada0.2 steps
    _, samples, solver = chip_smoke.solve_repair("cpu", **small)
    log_, med, share = chip_smoke.repair_gates(solver, samples)
    assert log_ == ["L1"] and np.isfinite([med, share]).all()
    assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0
    for x0_ranges in (True, False):
        _, samples, solver = chip_smoke.solve_separator_repair(
            "cpu", x0_ranges, **small)
        holding, sep_only, kept = chip_smoke.separator_repair_cliques(solver)
        assert solver.mode_repair_log == ["L1"]
        assert sep_only and kept == [] and set(sep_only) < set(holding)
        assert all(np.isfinite(x).all() for x in samples.values())
        assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0
    with tempfile.TemporaryDirectory() as case_dir:
        _, samples, truth, weights, solver, _ = chip_smoke.solve_case1_da(
            0, "cpu", case_dir, **small)
    assert sorted(weights) == sorted(chip_smoke.DA_TRUE)
    assert all(abs(sum(w.values()) - 1.0) < 1e-9 for w in weights.values())
    assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0
    result, steps, samples, truth, floor, solver, _ = \
        chip_smoke.plaza_prefix("plaza1_ada0.2", 2, "cpu",
                                **{**chip_smoke.PLAZA_ADA_ARGS, **small})
    assert solver._args.mode_repair and len(steps) == 2
    snap = result["hypo_curve"][-1]
    assert snap["step"] == 1 and snap["n"] == 1
    assert 0.0 <= snap["resolved_frac"] <= 1.0
    assert 0.0 < snap["mean_true_weight"] < 1.0
    assert np.isfinite(chip_smoke.translation_errors(samples, truth)).all()
    assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0
    # the MAP floors: a prefix's floor and its divergence gate, the full
    # g16 floor against the JAX figure's gate, case1's Laplace MAP
    from nfisam_tpu_torch.solver import (GaussNewtonMAP,
                                         IncrementalGaussNewtonMAP)
    assert floor["iters"] >= 1 and 0.0 < floor["rmse"] < floor["max"]
    bound = max(3.0 * chip_smoke.JAX_PREFIX_FLOOR_MAX["plaza1_ada0.2"],
                15.0)
    chip_smoke.plaza_floor_gate("plaza1_ada0.2", bound - 0.01, floor)
    with pytest.raises(SystemExit):
        chip_smoke.plaza_floor_gate("plaza1_ada0.2", bound + 0.01, floor)
    g16 = "manhattan g16 truth floor"
    r = chip_smoke.map_case(g16, graph_file_parser,
                            lambda: IncrementalGaussNewtonMAP(device="cpu"))
    assert chip_smoke.map_gate(g16, r)
    assert not chip_smoke.map_gate(g16, {**r, "rmse": r["rmse"] + 0.02})
    assert not chip_smoke.map_gate(g16, {**r, "nll": r["nll"] + 0.1})
    nodes, truth, factors = graph_file_parser(chip_smoke.CASE1_FG)
    r = chip_smoke.laplace_from_truth(
        GaussNewtonMAP(nodes, factors, device="cpu"), truth)
    assert r["iters"] == 100 and r["rmse"] < 1e-3

    def once(fn, warmup, repeats):      # a host call for the CUDA events
        fn()
        return 0.0

    assert chip_smoke.time_map_products("cpu", timer=once) <= 1e-6
    # three Manhattan g8 steps by ccolamd, the MAP solved each step
    _, steps, m, samples, solver = chip_smoke.solve_manhattan(
        chip_smoke.parse_args(chip_smoke.MANHATTAN_G8_ARGV + [
            "--limit-steps", "3", "--device", "cpu"]), **small)
    assert [st["floor_iters"] for st in steps][0] >= 1
    assert all(d == 16 for st in steps for d, _, _ in st["buckets"])
    assert np.isfinite([v for v in m.values()
                        if isinstance(v, float)]).all()
    assert chip_smoke.manhattan_gate(m) == (
        m["trans_rmse"] <= 40.0 and
        m["anchored_trans_rmse"] <= 2.0 * m["incremental_map_rmse"])
    assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0


def test_parallel_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ParallelNFiSAM(NFiSAMArgs(**SMALL))


def jax_plaza_reference(steps: int = chip_smoke.PLAZA_STEPS):
    """The JAX package's ParallelNFiSAM on the first ``steps`` steps of
    plaza1 at chip_smoke's plaza configuration (mode repair off).
    Returns (last step's samples by name, ground truth by name)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    nodes, truth, factors = j_parse(chip_smoke.PLAZA1_FG, "fg")
    batches = j_group(nodes, factors, incremental_step=5)[:steps]
    solver = JParallel(JNFiSAMArgs(**chip_smoke.PLAZA_ARGS))
    for ns, fs in batches:
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        samples = solver.incremental_inference()
    return ({str(v.name): np.asarray(x)
             for v, x in samples.materialize().items()},
            {str(v.name): np.asarray(t) for v, t in truth.items()})


if __name__ == "__main__":
    samples, truth = jax_plaza_reference()
    worst, rmse = chip_smoke.translation_errors(samples, truth)
    print(f"JAX on CPU, plaza1 first {chip_smoke.PLAZA_STEPS} steps, "
          f"mode_repair=False: max posterior-mean translation error "
          f"{worst:.3f} m, RMSE {rmse:.3f} m (gate {chip_smoke.PLAZA_GATE_M}"
          f" m)")
    for name in sorted(samples):
        err = chip_smoke.translation_errors({name: samples[name]}, truth)[0]
        print(f"  {name}: error {err:.3f} m, posterior std "
              f"{np.round(samples[name][:, :2].std(0), 3).tolist()}")
