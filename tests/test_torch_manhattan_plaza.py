"""The port's manhattan_plaza runner
(``nfisam_tpu_torch.scripts.manhattan_plaza_run``) against the JAX
package's ``scripts/manhattan_plaza_run.py`` on the CPU.

The JAX script is read as source (``torch_script_ast``), never imported.
Its ``main``'s read-out of a run directory and its floor gate, run on a
synthetic run directory and MAP point, equal the port's within 1e-9, key
for key.  ``--limit-steps`` builds the solver ``nfisam_empirical_study``
builds, in both packages.  A 3-step CPU run at tiny sizes writes the JAX
script's keys and the JAX package's artifact set (its own
``run_incrementally`` at the same sizes) but the plots; without a card and
without ``--device cpu`` the runner exits 1.  ``chip_smoke``'s
manhattan_plaza child runs on the CPU at a tiny size, and its gates fail
where they should.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_manhattan_plaza.py
[--prefixes P ... --] [seed ...]`` runs the JAX package's
``run_incrementally`` with the solver its ``nfisam_empirical_study`` builds
at the runner's arguments, for solver seeds 0-2 (or those given), and
prints, for each prefix P (default ``chip_smoke.MANHATTAN_PLAZA_STEPS``
and the one before it), the translation RMSE of step P-1's artifacts, the
JAX package's ``GaussNewtonMAP`` over the prefix started from the truth
column, whether the runner's 1.1x rule holds there, and the worst RMSE
over the seeds: the figures behind ``chip_smoke.MANHATTAN_PLAZA_STEPS``
and ``JAX_MANHATTAN_PLAZA_WORST``.
"""
import json
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
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.scripts import manhattan_plaza_run as mpr  # noqa: E402
from torch_script_ast import (dict_keys, function_statements,  # noqa: E402
                              script_path)

torch.set_num_threads(1)
JAX_SCRIPT = script_path("manhattan_plaza_run.py")
TINY = dict(flow_iterations=20, local_sample_num=200,
            posterior_sample_num=100)


class _StubMAP:
    """A ``GaussNewtonMAP`` stand-in whose solve returns ``x_map``."""

    def __init__(self, nodes, x_map):
        self.joint = type("Joint", (), {"vars": list(nodes)})()
        self._x = x_map

    def solve(self, x0=None):
        return self._x, None, 0.0, 0


def _synthetic_run(run_dir, nodes, truth, rng, last: int):
    """A run directory holding steps 0 ... ``last``: each step's samples
    (the truth of its first variables, shifted and scattered, in a
    shuffled ordering), its ordering and the step timing."""
    os.makedirs(run_dir)
    for i in range(last + 1):
        order = list(nodes[:10 + 3 * i])
        rng.shuffle(order)
        cols = [np.asarray(truth[v], np.float64) + rng.normal(0, 2.0, v.dim)
                + rng.normal(0, 1.0, (50, v.dim)) for v in order]
        np.savetxt(f"{run_dir}/step{i}", np.hstack(cols))
        with open(f"{run_dir}/step{i}_ordering", "w") as fh:
            fh.write(" ".join(str(v.name) for v in order))
    for name, vals in (("step_timing", rng.uniform(0.1, 2.0, last + 1)),
                       ("fitting_timer", rng.uniform(0.1, 1.0, last + 1)),
                       ("posterior_sampling_timer",
                        rng.uniform(0.0, 0.1, last + 1))):
        with open(f"{run_dir}/{name}", "w") as fh:
            fh.write(" ".join(str(t) for t in vals))
    with open(f"{run_dir}/step{last}.hypoweights", "w") as fh:
        fh.write("")


@pytest.mark.parametrize("rng_seed, shift", [(0, 0.5), (1, 8.0), (2, 2.0)])
def test_readout_and_floor_gate_match_the_jax_script(tmp_path, rng_seed,
                                                     shift):
    """A synthetic run directory and a MAP point ``shift`` m off the truth:
    the port's ``artifact_readout``, ``floor_errors`` and
    ``result_record`` against the JAX script's own statements (:55-115),
    every JAX key within 1e-9."""
    nodes, truth, factors = graph_file_parser(mpr.DATA)
    j_nodes, j_truth, j_factors = j_parse(mpr.DATA, "fg")
    rng = np.random.default_rng(rng_seed)
    case_dir = str(tmp_path)
    with open(mpr.DATA) as src, open(f"{case_dir}/factor_graph.fg",
                                     "w") as dst:
        dst.write(src.read())
    run_dir = f"{case_dir}/run1"
    _synthetic_run(run_dir, nodes, truth, rng, 4)
    x_map = np.concatenate([np.asarray(truth[v], np.float64) +
                            rng.normal(0, shift, v.dim) for v in nodes])
    ns = {"np": np, "os": os, "CASE_DIR": case_dir, "run_dir": run_dir,
          "total": 12.75, "graph_file_parser": j_parse,
          "GaussNewtonMAP": lambda n, f: _StubMAP(j_nodes, x_map)}
    exec(function_statements(JAX_SCRIPT, "main", "nodes, truth, factors",
                             "print(json.dumps(res)"), ns)
    errs, lmk, steps = mpr.artifact_readout(run_dir, nodes, truth)
    floor = {"draws": mpr.floor_errors(_StubMAP(nodes, x_map), x_map, truth),
             "truth": (1.0, None)}
    mine = mpr.result_record(run_dir, errs, lmk, steps, floor, 12.75, "cpu")
    theirs = ns["res"]
    assert set(theirs) <= set(mine)
    for k, v in theirs.items():
        if isinstance(v, float):
            assert abs(mine[k] - v) <= 1e-9, (k, mine[k], v)
        else:
            assert mine[k] == v, (k, mine[k], v)
    assert mpr.last_step(run_dir) == 4


def test_limit_steps_solver_is_the_studys(monkeypatch):
    """The solver ``--limit-steps`` builds (``solver_args(study_args())``)
    has the arguments the port's ``nfisam_empirical_study`` gives its
    solver, and those the JAX package's gives its own."""
    import nfisam_tpu.solver.run as j_run
    from nfisam_tpu_torch.solver import NFiSAMArgs
    from nfisam_tpu_torch.solver import run as t_run

    seen = {}

    def grab(who):
        def run_incrementally(case_dir, solver, *a, **k):
            seen[who] = solver._args
            return "run1"
        return run_incrementally
    monkeypatch.setattr(t_run, "run_incrementally", grab("port"))
    monkeypatch.setattr(j_run, "run_incrementally", grab("jax"))
    monkeypatch.setenv("NFISAM_PREWARM", "0")
    study = {k: v for k, v in mpr.study_args().items() if k != "plot_args"}
    t_run.nfisam_empirical_study(case_dir=os.path.dirname(mpr.DATA),
                                 device="cpu", **{
                                     **study, "data_file": os.path.basename(
                                         mpr.DATA)})
    j_run.nfisam_empirical_study(case_dir=os.path.dirname(mpr.DATA), **{
        **study, "data_file": os.path.basename(mpr.DATA)})
    ours = NFiSAMArgs(**mpr.solver_args(mpr.study_args()))
    assert seen["port"] == ours
    fields = mpr.solver_args(mpr.study_args())
    assert {k: getattr(seen["jax"], k) for k in fields} == fields
    assert (ours.flow_iterations, ours.loss_delta_tol, ours.average_window,
            ours.training_set_frac) == (500, 1e-9, 50, 1.0)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The port's runner (``main``, 3 steps, tiny sizes, no ``--out``) and
    the JAX package's ``run_incrementally`` at the same sizes: (the result,
    the port's run directory, the JAX package's)."""
    import nfisam_tpu.solver.run as j_run
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs

    tmp = tmp_path_factory.mktemp("mp")
    mp = pytest.MonkeyPatch()
    study_args = mpr.study_args
    mp.setattr(mpr, "study_args", lambda **o: study_args(**{**TINY, **o}))
    mp.setenv("TMPDIR", str(tmp))
    mp.setattr(tempfile, "tempdir", None)
    try:
        assert mpr.main(["--limit-steps", "3", "--device", "cpu"]) == 0
    finally:
        mp.undo()
    result = json.loads((tmp / "manhattan_plaza_results.json").read_text())
    nodes, truth, factors = j_parse(mpr.DATA, "fg")
    batches = j_group(nodes, factors, incremental_step=1)[:3]
    j_dir = j_run.run_incrementally(
        str(tmp / "jax"), JParallel(JNFiSAMArgs(
            **mpr.solver_args(mpr.study_args(**TINY)))), batches, truth,
        verbose=False)
    return result, result["run_dir"], j_dir


def test_three_cpu_steps_write_the_jax_scripts_keys(tiny_runs):
    result, run_dir, _ = tiny_runs
    jax_keys = dict_keys(JAX_SCRIPT, "main", "res")
    assert set(result) == jax_keys | {
        "truth_start_floor_trans_rmse", "truth_start_floor_landmark_rmse",
        "fit_s", "posterior_s", "outside_solve_s", "backend"}
    assert result["n_steps"] == 3 and result["backend"] == "cpu"
    assert run_dir == os.path.join(os.path.dirname(run_dir), "run1")
    assert os.path.basename(os.path.dirname(run_dir)) == "manhattan_plaza"
    assert np.isfinite(result["trans_rmse"])
    assert result["truth_start_floor_trans_rmse"] > 0


def test_run_dir_holds_the_jax_artifact_set(tiny_runs):
    """The same files as the JAX package's run directory, the plots
    aside (``step{i}.png``, ``hypoweights.png``)."""
    _, run_dir, j_dir = tiny_runs

    def files(d):
        return {f for f in os.listdir(d) if not f.endswith(".png")}
    assert files(run_dir) == files(j_dir)
    assert "step2.hypoweights" in files(run_dir)
    nodes, _, factors = graph_file_parser(mpr.DATA)
    assert chip_smoke.manhattan_plaza_artifacts(
        group_nodes_factors_incrementally(nodes, factors, 1)[:3]) == \
        files(run_dir)


def test_runner_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert mpr.main(["--limit-steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_manhattan_plaza_child_readings_and_gates_on_cpu(monkeypatch):
    """``chip_smoke``'s manhattan_plaza child on the CPU at a tiny size (3
    steps): its readings survive JSON; ``manhattan_plaza_report`` fails on
    no launch of the specialised kernel, on a missing artifact, on the
    1.1x rule, on JAX parity, and passes otherwise."""
    r = json.loads(json.dumps(chip_smoke.manhattan_plaza_readings(
        "cpu", 3, **TINY)))
    assert r["finite"] and r["artifact_finite"] and r["fused_vs_walk"] == 0.0
    assert r["result"]["n_steps"] == 3 and len(r["files"]) == 21
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_PLAZA_WORST", 1e3)
    with pytest.raises(SystemExit, match="never launched"):
        chip_smoke.manhattan_plaza_report(r, 3)
    r["launches"]["specialized"] = 9
    r["trans_rmse"] = 1.05 * r["floor"]["truth"][0]
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_PLAZA_WORST",
                        r["trans_rmse"] / 1.9)
    chip_smoke.manhattan_plaza_report(r, 3)
    r["files"].remove("step2.hypoweights")
    with pytest.raises(SystemExit, match="artifact set"):
        chip_smoke.manhattan_plaza_report(r, 3)
    r["files"].append("step2.hypoweights")
    r["trans_rmse"] = 1.15 * r["floor"]["truth"][0]
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_PLAZA_WORST",
                        r["trans_rmse"])
    with pytest.raises(SystemExit, match="floor gate"):
        chip_smoke.manhattan_plaza_report(r, 3)
    r["trans_rmse"] = 1.05 * r["floor"]["truth"][0]
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_PLAZA_WORST",
                        r["trans_rmse"] / 2.1)
    with pytest.raises(SystemExit, match="JAX-parity"):
        chip_smoke.manhattan_plaza_report(r, 3)


# --------------------------------------------------------------------------
# the JAX package's CPU figures behind chip_smoke's constants
# --------------------------------------------------------------------------
def jax_prefix_floor(p: int) -> float:
    """The JAX package's ``GaussNewtonMAP`` over the stream's first ``p``
    steps from the truth column: its translation RMSE."""
    from nfisam_tpu.solver.map_solver import GaussNewtonMAP as JMAP

    nodes, truth, factors = j_parse(mpr.DATA, "fg")
    batches = j_group(nodes, factors, incremental_step=1)[:p]
    m = JMAP([n for ns, _ in batches for n in ns],
             [f for _, fs in batches for f in fs])
    x0 = np.concatenate([np.asarray(truth[v], np.float32)[:v.dim]
                         for v in m.joint.vars])
    return mpr.floor_errors(m, m.solve(x0=x0)[0], truth)[0]


def jax_run(seed: int, n_steps: int) -> str:
    """The JAX package's ``run_incrementally`` on the first ``n_steps``
    steps at the runner's solver, seed ``seed``: its run directory."""
    import nfisam_tpu.solver.run as j_run
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs

    nodes, truth, factors = j_parse(mpr.DATA, "fg")
    batches = j_group(nodes, factors, incremental_step=1)
    solver = JParallel(JNFiSAMArgs(**{**mpr.solver_args(mpr.study_args()),
                                      "seed": seed}))
    return j_run.run_incrementally(tempfile.mkdtemp(), solver,
                                   batches[:n_steps], truth)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    argv = sys.argv[1:]
    prefixes = [chip_smoke.MANHATTAN_PLAZA_STEPS - 1,
                chip_smoke.MANHATTAN_PLAZA_STEPS]
    if argv[:1] == ["--prefixes"]:
        k = next((i for i, a in enumerate(argv[1:], 1) if a == "--"),
                 len(argv))
        prefixes, argv = [int(a) for a in argv[1:k]], argv[k + 1:]
    floors = {p: jax_prefix_floor(p) for p in prefixes}
    nodes, truth, _ = j_parse(mpr.DATA, "fg")
    worst = {p: 0.0 for p in prefixes}
    for seed in [int(a) for a in argv] or [0, 1, 2]:
        run_dir = jax_run(seed, max(prefixes))
        for p in prefixes:
            errs, _, _ = mpr.artifact_readout(run_dir, nodes, truth, p - 1)
            rmse = mpr._rms(errs)
            worst[p] = max(worst[p], rmse)
            print(f"JAX, manhattan_plaza first {p} steps, seed {seed}: "
                  f"trans RMSE {rmse!r} m, GaussNewtonMAP from the truth "
                  f"over the prefix {floors[p]!r} m, ratio "
                  f"{rmse / floors[p]:.4f} (the 1.1x rule "
                  f"{'holds' if rmse <= 1.1 * floors[p] else 'fails'})",
                  flush=True)
    for p in prefixes:
        print(f"first {p} steps: worst trans RMSE over these seeds "
              f"{worst[p]!r} m", flush=True)
