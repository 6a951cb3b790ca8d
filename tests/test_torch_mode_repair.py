"""The port's mode repair against the JAX package's, on the CPU.

- ``_mode_contradicted_vars`` returns the same variables as JAX's on the
  same posterior arrays and the same new factors: a range contradicting
  a committed landmark, a consistent one, a range from a new pose
  dead-reckoned through new odometry (contradicted and consistent), and
  a data-association mixture (every hypothesis contradicted, and one
  consistent), and a range from a new R^2 pose dead-reckoned through new
  R^2 odometry (contradicted and consistent).  200 posterior rows, so both read every row (the port
  reads at most 256, JAX's fallback all).
- ``prune_affected(touched, deep=...)`` gives the same affected variables
  and detached subtree roots as JAX on plaza1_ada0.2's first 6 steps.
- The mode-repair graph solved by the port at small settings logs
  exactly ["L1"]; a stream of consistent ranges logs nothing.
- On ``chip_smoke.separator_repair_graph`` (the landmark also sits in the
  separators of cliques below its own) both packages, with repair on and
  off, prune the same variables, recycle the same models into the same
  cliques, and train the same cliques, step by step; with repair on every
  clique holding the landmark retrains, with it off the separator-only
  ones keep their models.
- The per-step cap and the cooldown hold over six updates.
Exact comparisons: no tolerance.

Run as a script, ``python tests/test_torch_mode_repair.py``, it solves
the mode-repair graph at ``chip_smoke.py``'s settings for seeds 0-4 with
both packages on the CPU and prints each one's repair log and median
|X1 - L1|, and whether the port's samples with repair off equal those
with it on; then both variants of the separator trap at those settings,
seed 0, repair on and off, with each package's share of L1 at x > 0 and
median |X3 - L1|."""
import os
import sys

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
import nfisam_tpu_torch.solver.solver as t_solver  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.graph.bayes_tree import BayesTree as JBayesTree  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.graph.bayes_tree import BayesTree as TBayesTree  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.parallel import ParallelNFiSAM  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAMArgs, SolverArgs  # noqa: E402
from test_torch_solver import SMALL  # noqa: E402

torch.set_num_threads(1)
REPAIR = {**SMALL, "mode_repair": True}
COV3 = np.diag([0.01, 0.01, 0.001])

# landmark positions the committed posterior holds, the new factors, and
# the variables each case must return
CASES = {
    "contradicted": ({"L1": (-4.0, 0.0)}, [("range", "X0", "L1", 1.0)],
                     {"L1"}),
    "consistent": ({"L1": (4.0, 0.0)}, [("range", "X0", "L1", 4.0)],
                   set()),
    "dead_reckoned": ({"L1": (-4.0, 0.0)},
                      [("odom", "X0", "X1"), ("range", "X1", "L1", 1.0)],
                      {"L1"}),
    "dead_reckoned_consistent": ({"L1": (4.0, 0.0)},
                                 [("odom", "X0", "X1"),
                                  ("range", "X1", "L1", 1.0)], set()),
    "mixture_contradicted": ({"L1": (-4.0, 0.0), "L2": (0.0, -6.0)},
                             [("odom", "X0", "X1"),
                              ("ada", "X1", ("L1", "L2"), 1.0)],
                             {"L1", "L2"}),
    "mixture_consistent": ({"L1": (-4.0, 0.0), "L2": (4.0, 0.5)},
                           [("odom", "X0", "X1"),
                            ("ada", "X1", ("L1", "L2"), 1.0)], set()),
    # R^2 poses: the new pose X1 is dead-reckoned through R^2 odometry
    "r2_dead_reckoned": ({"L1": (-4.0, 0.0)},
                         [("r2odom", "X0", "X1"),
                          ("range", "X1", "L1", 1.0)], {"L1"}),
    "r2_dead_reckoned_consistent": ({"L1": (4.0, 0.0)},
                                    [("r2odom", "X0", "X1"),
                                     ("range", "X1", "L1", 1.0)], set()),
}


def _case_inputs(core, factors, case):
    """(variables by name, committed posterior arrays by name, new
    factors) of one case in one package."""
    lmks, specs, _ = CASES[case]
    r2 = any(spec[0] == "r2odom" for spec in specs)
    pose = core.R2Variable if r2 else core.SE2Variable
    vs = {"X0": pose("X0"), "X1": pose("X1")}
    for name in lmks:
        vs[name] = core.R2Variable(name, core.VariableType.Landmark)
    rng = np.random.default_rng(5)
    post = {"X0": (rng.normal(size=(200, 3)) * [0.05, 0.05, 0.01]).astype(
        np.float32)[:, :vs["X0"].dim]}
    for name, xy in lmks.items():
        post[name] = (np.asarray(xy) + rng.normal(size=(200, 2)) * 0.1
                      ).astype(np.float32)
    new = []
    for spec in specs:
        if spec[0] == "odom":
            new.append(factors.SE2RelativeGaussianLikelihoodFactor(
                vs[spec[1]], vs[spec[2]], np.array([3.0, 0.0, 0.0]), COV3))
        elif spec[0] == "r2odom":
            new.append(factors.R2RelativeGaussianLikelihoodFactor(
                vs[spec[1]], vs[spec[2]], np.array([3.0, 0.0]),
                COV3[:2, :2]))
        elif spec[0] == "range":
            rng_cls = factors.R2RangeGaussianLikelihoodFactor if r2 else \
                factors.SE2R2RangeGaussianLikelihoodFactor
            new.append(rng_cls(vs[spec[1]], vs[spec[2]], spec[3], 0.3))
        else:
            new.append(factors.AmbiguousDataAssociationFactor(
                vs[spec[1]], [vs[n] for n in spec[2]], [0.5, 0.5],
                factors.SE2R2RangeGaussianLikelihoodFactor, spec[3], 0.3))
    return vs, post, new


def _contradicted(solver, core, factors, case, to):
    vs, post, new = _case_inputs(core, factors, case)
    solver._samples = {vs[n]: to(x) for n, x in post.items()}
    solver._new_factors = new
    return {str(v.name) for v in solver._mode_contradicted_vars(
        {vs[n] for n in post})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_contradicted_vars_match_jax(case, monkeypatch):
    # no solve follows: keep the JAX solver from starting background
    # compiles that would outlive the test process
    monkeypatch.setenv("NFISAM_PREWARM", "0")
    ours = _contradicted(ParallelNFiSAM(NFiSAMArgs(**REPAIR), device="cpu"),
                         tcore, tfactors, case, torch.as_tensor)
    theirs = _contradicted(JParallel(JNFiSAMArgs(**REPAIR)), jcore,
                           jfactors, case, np.asarray)
    assert ours == theirs == CASES[case][2]


def _plaza_tree(parse, group, graph, steps=6):
    """One package's pose_first Bayes tree over plaza1_ada0.2's first
    ``steps`` incremental steps, and its variables by name."""
    nodes, _, factors = parse(chip_smoke.PLAZA_ADA_FG)
    fg = graph.FactorGraph()
    for ns, fs in group(nodes, factors)[:steps]:
        for n in ns:
            fg.add_node(n)
        for f in fs:
            fg.add_factor(f)
    tree = fg.build_bayes_tree(ordering=graph.pose_first_ordering(fg.vars))
    return tree, {str(v.name): v for v in fg.vars}


def _pruned(tree, by_name, touched, deep):
    affected, detached = tree.prune_affected(
        {by_name[n] for n in touched}, deep={by_name[n] for n in deep})
    roots = {(frozenset(str(v.name) for v in t.root.frontal),
              frozenset(str(v.name) for v in t.root.separator))
             for t in detached}
    return {str(v.name) for v in affected}, roots


@pytest.mark.parametrize("touched,deep", [
    (("X20",), ()), (("X20",), ("L1",)), (("X5",), ("L0", "L3")),
    ((), ("L2",))])
def test_prune_affected_deep_matches_jax(touched, deep):
    ours = _pruned(*_plaza_tree(
        graph_file_parser,
        lambda n, f: group_nodes_factors_incrementally(n, f, 5), tgraph),
        touched, deep)
    theirs = _pruned(*_plaza_tree(
        lambda p: j_parse(p, "fg"),
        lambda n, f: j_group(n, f, incremental_step=5), jgraph),
        touched, deep)
    assert ours == theirs
    if deep:
        shallow = _pruned(*_plaza_tree(
            graph_file_parser,
            lambda n, f: group_nodes_factors_incrementally(n, f, 5),
            tgraph), touched, ())
        assert shallow[0] < ours[0]


SMALL_SOLVE = dict(local_sample_num=300, flow_iterations=40,
                   posterior_sample_num=300)


def test_repair_graph_logs_the_landmark():
    _, samples, solver = chip_smoke.solve_repair("cpu", **SMALL_SOLVE)
    assert solver.mode_repair_log == ["L1"]
    assert {str(v.name) for v in solver._repair_vars} == {"L1"}
    assert all(np.isfinite(x).all() for x in samples.values())


def test_consistent_ranges_log_nothing():
    """The JAX package's consistent stream: the landmark prior sits at the
    truth, so the new range agrees with the committed posterior."""
    steps = chip_smoke.repair_graph(tcore, tfactors)
    l1 = steps[0][0][1]
    steps[0][1][1] = tfactors.UnaryR2GaussianPriorFactor(
        l1, np.array([4.0, 0.0]), covariance=np.eye(2))
    solver = ParallelNFiSAM(
        NFiSAMArgs(**{**chip_smoke.REPAIR_ARGS, **SMALL_SOLVE}),
        device="cpu")
    chip_smoke.run_incremental(solver, steps, "cpu")
    assert solver.mode_repair_log == []


def _names(vs):
    return "".join(sorted(str(v.name) for v in vs))


def _surgery_log(solver, tree_cls, core, factors, mp, x0_ranges):
    """Per update of the separator trap: the pruned variables, the
    recycled (old clique, new clique) pairs, the trained cliques, the
    physical tree, and at the end the repair log."""
    pruned, recycled = [], []
    prune = tree_cls.prune_affected

    def recording_prune(tree, touched, deep=frozenset()):
        affected, detached = prune(tree, touched, deep=deep)
        pruned.append(_names(affected))
        return affected, detached

    mp.setattr(tree_cls, "prune_affected", recording_prune)
    to_leaf = solver.root_clique_density_model_to_leaf

    def recording_to_leaf(old, new):
        recycled.append((_names(old.vars), repr(new)))
        return to_leaf(old, new)

    solver.root_clique_density_model_to_leaf = recording_to_leaf
    steps = []
    for ns, fs in chip_smoke.separator_repair_graph(core, factors,
                                                    x0_ranges):
        del recycled[:]
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        solver.incremental_inference()
        thread = getattr(solver, "_snapshot_thread", None)
        if thread is not None:
            thread.join(timeout=10)
        steps.append((sorted(recycled), sorted(solver._temp_training_loss),
                      repr(solver.physical_bayes_tree)))
    return pruned, steps, list(solver.mode_repair_log)


@pytest.mark.parametrize("x0_ranges", [True, False])
@pytest.mark.parametrize("on", [True, False])
def test_separator_repair_surgery_matches_jax(on, x0_ranges, monkeypatch):
    """With ``x0_ranges`` only deep pruning retrains X0's clique; without,
    only ``no_recycle`` keeps the old root's model out of its re-split."""
    args = {**REPAIR, **SMALL_SOLVE, "mode_repair": on}
    ours = ParallelNFiSAM(NFiSAMArgs(**args), device="cpu")
    ours_log = _surgery_log(ours, TBayesTree, tcore, tfactors, monkeypatch,
                            x0_ranges)
    theirs = _surgery_log(JParallel(JNFiSAMArgs(**args)), JBayesTree,
                          jcore, jfactors, monkeypatch, x0_ranges)
    assert ours_log == theirs
    holding, sep_only, kept = chip_smoke.separator_repair_cliques(ours)
    assert sep_only and set(sep_only) < set(holding)
    if on:
        assert ours_log[2] == ["L1"] and kept == []
    else:
        assert ours_log[2] == [] and kept == sep_only


def test_repair_rails_cap_and_cool_down(monkeypatch):
    """Every update all five landmarks are contradicted: at most 3 are
    repaired an update (sorted by name) and each is then immune for 2
    updates."""
    monkeypatch.setattr(t_solver, "MODE_REPAIR_MAX_PER_STEP", 3)
    monkeypatch.setattr(t_solver, "MODE_REPAIR_COOLDOWN", 2)
    x = [tcore.SE2Variable(f"X{i}") for i in range(6)]
    lmks = [tcore.R2Variable(f"L{i}", tcore.VariableType.Landmark)
            for i in range(1, 6)]
    first = ([x[0]] + lmks,
             [tfactors.UnarySE2ApproximateGaussianPriorFactor(
                 x[0], np.zeros(3), COV3)] +
             [tfactors.UnaryR2GaussianPriorFactor(
                 lm, np.array([3.0 * i, 4.0]), covariance=np.eye(2))
              for i, lm in enumerate(lmks)] +
             [tfactors.SE2R2RangeGaussianLikelihoodFactor(
                 x[0], lm, float(np.hypot(3.0 * i, 4.0)), 0.3)
              for i, lm in enumerate(lmks)])
    steps = [first] + [
        ([x[i]], [tfactors.SE2RelativeGaussianLikelihoodFactor(
            x[i - 1], x[i], np.array([1.0, 0.0, 0.0]), COV3)])
        for i in range(1, 6)]
    args = NFiSAMArgs(**{**REPAIR, "local_sample_num": 100,
                         "flow_iterations": 3, "posterior_sample_num": 50})
    solver = ParallelNFiSAM(args, device="cpu")
    solver._mode_contradicted_vars = \
        lambda old_nodes: {v for v in lmks if v in old_nodes}
    per_update = []
    for ns, fs in steps:
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        per_update.append(sorted(str(v.name) for v in solver._repair_vars))
        solver.incremental_inference()
    assert per_update == [[], ["L1", "L2", "L3"], ["L4", "L5"], [],
                          ["L1", "L2", "L3"], ["L4", "L5"]]
    assert solver.mode_repair_log == [n for u in per_update for n in u]


def test_mode_repair_is_on_by_default():
    assert SolverArgs().mode_repair and NFiSAMArgs().mode_repair


def seed_sweep(seeds=range(5)):
    """The mode-repair graph at ``chip_smoke.REPAIR_ARGS`` on the CPU, per
    seed: the JAX package's and the port's repair log and median |X1 -
    L1|, and whether the port's samples with repair off equal those with
    it on bit for bit."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    for seed in seeds:
        solver = JParallel(JNFiSAMArgs(**{**chip_smoke.REPAIR_ARGS,
                                          "seed": seed}))
        for ns, fs in chip_smoke.repair_graph(jcore, jfactors):
            for n in ns:
                solver.add_node(n)
            for f in fs:
                solver.add_factor(f)
            solver.update_physical_and_working_graphs()
            samples = solver.incremental_inference()
            thread = getattr(solver, "_snapshot_thread", None)
            if thread is not None:
                thread.join(timeout=10)
        theirs = chip_smoke.host_samples(samples)
        print(f"seed {seed}: JAX {chip_smoke.repair_gates(solver, theirs)}")
        _, on, solver = chip_smoke.solve_repair("cpu", seed=seed)
        _, off, _ = chip_smoke.solve_repair("cpu", seed=seed,
                                            mode_repair=False)
        same = all(np.array_equal(on[k], off[k]) for k in on)
        print(f"seed {seed}: port {chip_smoke.repair_gates(solver, on)}; "
              f"repair off gives the same samples bit for bit: {same}")


def separator_sweep():
    """Both packages on both separator-trap variants at
    ``chip_smoke.REPAIR_ARGS``, seed 0, repair on and off (CPU): the
    repair log, L1's share at x > 0 and the median |X3 - L1|."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    for x0_ranges in (True, False):
        for on in (True, False):
            args = {**chip_smoke.REPAIR_ARGS, "mode_repair": on}
            solver = JParallel(JNFiSAMArgs(**args))
            for ns, fs in chip_smoke.separator_repair_graph(jcore, jfactors,
                                                            x0_ranges):
                for n in ns:
                    solver.add_node(n)
                for f in fs:
                    solver.add_factor(f)
                solver.update_physical_and_working_graphs()
                samples = solver.incremental_inference()
                thread = getattr(solver, "_snapshot_thread", None)
                if thread is not None:
                    thread.join(timeout=10)
            theirs = chip_smoke.host_samples(samples)
            _, ours, port = chip_smoke.solve_separator_repair(
                "cpu", x0_ranges, mode_repair=on)
            for who, sv, x in (("JAX", solver, theirs), ("port", port, ours)):
                d = np.linalg.norm(x["X3"][:, :2] - x["L1"], axis=1)
                print(f"x0_ranges={x0_ranges} repair={on} {who}: log "
                      f"{list(sv.mode_repair_log)}, L1 at x > 0 "
                      f"{np.mean(x['L1'][:, 0] > 0):.4f}, median |X3 - L1| "
                      f"{np.median(d):.4f} m", flush=True)


if __name__ == "__main__":
    seed_sweep()
    separator_sweep()
