"""The port's plaza-family runner
(``nfisam_tpu_torch.scripts.plaza_family_run``) against the JAX package's
``scripts/plaza_family_run.py`` on the CPU.

The JAX script is read as source (``torch_script_ast``), never imported.
On synthetic samples: ``geometric_true_component`` and ``hypo_snapshot``
equal the JAX script's, and the read-out with the divergence rule equals
its ``main``'s arithmetic within 1e-9, key for key.  ``map_floor`` on a
plaza prefix equals the JAX script's (its own ``map_floor``, the JAX MAP
run in float64 as the port solves) within ``test_torch_incremental_map``'s
tolerance.  The runner: a 2-step CPU run at tiny sizes writes the JAX
script's keys (without ``--out``, under ``TMPDIR``); ``--defer-da
--limit-steps`` solves the JAX stream's factors step for step; without a
card and without ``--device cpu`` it exits 1.  ``chip_smoke``'s
plaza-family child runs on the CPU at a tiny size, and its gates fail
where they should.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_plaza_family.py
[--steps N] [stream ...] [--seeds S ...]`` runs the JAX package's
``ParallelNFiSAM`` through the port runner's loop (``run_plaza``) on each
stream of ``chip_smoke.PLAZA_FAMILY`` (or those named: ``plaza2``,
``plaza1_ada0.4``, ``plaza1_ada0.6``, ``plaza1_ada0.6_deferda``) at the
runner's configuration, cut to ``chip_smoke.PLAZA_STEPS`` steps (or N),
for solver seeds 0-2, and prints each run's max error, DA resolution and
divergence reasons (and each step's max error and DA snapshot, the
read-out of a run cut there), and the JAX package's float32
truth-initialised floor over the prefix: the figures behind
``chip_smoke.PLAZA_FAMILY_STEPS``, ``JAX_PREFIX_FLOOR_MAX`` and
``JAX_PLAZA_FAMILY``.
``--steps N --floors [stream ...]`` prints that floor over each prefix of
1 ... N steps.
"""
import json
import os
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.io.stream_policy import defer_ambiguous as j_defer  # noqa: E402
from nfisam_tpu.solver import banked_joint as jb  # noqa: E402
from nfisam_tpu_torch.scripts import plaza_family_run as pfr  # noqa: E402
from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP  # noqa: E402
from torch_script_ast import (dict_keys, function_statements,  # noqa: E402
                              script_functions, script_path)

torch.set_num_threads(1)
JAX_SCRIPT = script_path("plaza_family_run.py")
ADA = pfr.data_path("plaza1_ada0.4")


def jax_script(names=("geometric_true_component", "hypo_snapshot",
                      "map_floor")) -> dict:
    return script_functions(JAX_SCRIPT, names, {"np": np, "jax": jax})


def jax_stream(path, defer_da=False, limit=0):
    return pfr.load_stream(path, defer_da, limit, parse=j_parse,
                           group=j_group, defer=j_defer)


@pytest.fixture(scope="module")
def ada_streams():
    """plaza1_ada0.4 cut to 8 steps in both packages, the port's nodes by
    name beside the JAX package's."""
    ours = pfr.load_stream(ADA, False, 8)
    theirs = jax_stream(ADA, False, 8)
    return ours, theirs


def _synthetic(rng, nodes, keep, spread=3.0, n=200):
    """Samples of the variables named in ``keep``: each truth shifted and
    scattered; {name: (n, dim)} from the port's truth."""
    nodes_, truth = nodes
    out = {}
    for v in nodes_:
        if str(v.name) not in keep:
            continue
        t = np.asarray(truth[v], np.float64)
        out[str(v.name)] = (t + rng.normal(0.0, spread, t.shape) +
                            rng.normal(0.0, rng.uniform(0.1, 2.0),
                                       (n, len(t)))).astype(np.float32)
    return out


@pytest.mark.parametrize("dataset", ["plaza1_ada0.2", "plaza1_ada0.4",
                                     "plaza1_ada0.6"])
def test_geometric_true_component_matches_jax_script(dataset):
    """Every ambiguous range of the stream: the same true association."""
    nodes, truth, factors = pfr.load_stream(pfr.data_path(dataset))[:3]
    j_nodes, j_truth, j_factors = j_parse(pfr.data_path(dataset), "fg")
    fn = jax_script(("geometric_true_component",))["geometric_true_component"]
    mine = [pfr.geometric_true_component(f, truth)
            for f in factors if len(f.vars) >= 3]
    jaxs = [fn(f, j_truth) for f in j_factors if len(f.vars) >= 3]
    assert len(mine) == len(jaxs) > 100 and mine == jaxs


@pytest.mark.parametrize("seed, spread, solved", [(0, 0.3, None),
                                                  (1, 4.0, None),
                                                  (2, 1.0, 22)])
def test_hypo_snapshot_matches_jax_script(ada_streams, seed, spread, solved):
    """Over the 8-step prefix's factors, samples near the truth (most
    factors resolved), scattered (few), and of the first ``solved``
    variables only (factors with an unsolved variable left out)."""
    ours, theirs = ada_streams
    names = [str(v.name) for ns, _ in ours[3] for v in ns][:solved]
    s = _synthetic(np.random.default_rng(seed), (ours[0], ours[1]),
                   set(names), spread)
    by_port = {v: s[str(v.name)] for v in ours[0] if str(v.name) in s}
    by_jax = {v: s[str(v.name)] for v in theirs[0] if str(v.name) in s}
    fs_ours = [f for _, fs in ours[3] for f in fs]
    fs_jax = [f for _, fs in theirs[3] for f in fs]
    mine = pfr.hypo_snapshot(fs_ours, by_port, ours[1])
    jaxs = jax_script(("geometric_true_component",
                       "hypo_snapshot"))["hypo_snapshot"](fs_jax, by_jax,
                                                          theirs[1])
    assert mine is not None and set(mine) == set(jaxs)
    for k in jaxs:
        assert abs(mine[k] - jaxs[k]) <= 1e-9, (k, mine, jaxs)
    assert pfr.hypo_snapshot(fs_ours[:3], by_port, ours[1]) is None


def jax_main_readout(samples, truth, nodes, factors, batches, hypo_curve,
                     step_times, total, floor, dataset="plaza1_ada0.4",
                     seed=0, defer=False) -> dict:
    """The JAX script's ``main`` from the final samples to its ``result``
    (:162-200): its own statements, with ``map_floor`` returning
    ``floor``."""
    ns = {"np": np, "samples": samples, "truth": truth, "nodes": nodes,
          "factors": factors, "batches": batches, "hypo_curve": hypo_curve,
          "step_times": step_times, "total": total, "DATASET": dataset,
          "SEED": seed, "DEFER_DA": defer,
          "map_floor": lambda *a: floor}
    exec(function_statements(JAX_SCRIPT, "main", "if hasattr(samples",
                             "print(json.dumps(result)"), ns)
    return ns["result"]


@pytest.mark.parametrize("case", ["passes", "max error", "resolution",
                                  "both", "no snapshot"])
def test_readout_and_divergence_rule_match_jax_script(ada_streams, case):
    """The runner's result (``result_record``) against the JAX script's
    statements on the same samples, timings, snapshots and floor: every
    key of the JAX result within 1e-9 (strings and flags equal)."""
    ours, theirs = ada_streams
    rng = np.random.default_rng(["passes", "max error", "resolution",
                                 "both", "no snapshot"].index(case))
    spread = 30.0 if case in ("max error", "both") else 1.0
    s = _synthetic(rng, (ours[0], ours[1]),
                   {str(v.name) for ns_, _ in ours[3] for v in ns_}, spread)
    resolved = 0.5 if case in ("resolution", "both") else 0.8
    hypo = [] if case == "no snapshot" else [
        {"step": 0, "n": 4, "mean_true_weight": 0.61, "resolved_frac": 0.25},
        {"step": 7, "n": 12, "mean_true_weight": 0.83,
         "resolved_frac": resolved}]
    step_times = list(rng.uniform(1.0, 9.0, 8))
    floor = (float(rng.uniform(0.2, 1.0)), float(rng.uniform(1.0, 7.0)))
    theirs_r = jax_main_readout(
        {v: s[str(v.name)] for v in theirs[0] if str(v.name) in s},
        theirs[1], theirs[0], theirs[2], theirs[3], hypo, step_times, 42.25,
        floor)
    steps = [{"s": t, "surgery_s": 0.0, "fit_s": t, "posterior_s": 0.0,
              "trained": 1, "launches": 0} for t in step_times]
    args = pfr.parse_args(["plaza1_ada0.4", "--device", "cpu"])
    by_name = {str(v.name): np.asarray(t) for v, t in ours[1].items()}
    mine = pfr.result_record(args, steps, hypo, s, by_name, 42.25, floor,
                             "cpu")
    assert set(theirs_r) <= set(mine)
    for k, v in theirs_r.items():
        if isinstance(v, (float, int)) and not isinstance(v, bool):
            assert abs(mine[k] - v) <= 1e-9, (k, mine[k], v)
        else:
            assert mine[k] == v, (k, mine[k], v)
    assert mine["diverged"] == (case != "passes" and case != "no snapshot")


@pytest.mark.parametrize("dataset, steps", [("plaza1_ada0.4", 1),
                                            ("plaza1_ada0.6", 1),
                                            ("plaza2", 1)])
def test_map_floor_on_a_plaza_prefix_matches_jax(monkeypatch, dataset,
                                                 steps):
    """The runner's floor over a plaza prefix against the JAX script's own
    ``map_floor`` on the same prefix, its MAP solving in float64 as the
    port's does (``test_torch_map.JaxFloat64MAP``): RMSE and max error
    within 1e-3 m, the same LM iterations, the final NLL within 1e-6 of it
    (``test_torch_incremental_map``'s tolerance).  The prefix is one that
    both solves finish before their 15-iteration cap: at 5 steps both stop
    at the cap, each where its own rounding took it (plaza1_ada0.4: RMSE
    1.276 m in the port, 0.949 m in the JAX package in float64, the port's
    NLL the lower; PERF.md, ROADMAP C)."""
    from test_torch_map import JaxFloat64MAP

    path = pfr.data_path(dataset)
    nodes, truth, factors, batches, _ = pfr.load_stream(path, False, steps)
    m = IncrementalGaussNewtonMAP(device="cpu")
    m.update(*pfr.solved_graph(nodes, factors, batches, True))
    rmse, worst, r = pfr.map_floor(m, truth)
    j_nodes, j_truth, j_factors, j_batches, _ = jax_stream(path, False,
                                                           steps)
    made = []

    class Recording(JaxFloat64MAP):
        def __init__(self):
            super().__init__()
            made.append(self)
    monkeypatch.setattr(jb, "IncrementalGaussNewtonMAP", Recording)
    j_solved, j_fs = pfr.solved_graph(j_nodes, j_factors, j_batches, True)
    j_rmse, j_max = jax_script(("map_floor",))["map_floor"](
        j_solved, j_truth, j_fs)
    assert abs(rmse - j_rmse) <= 1e-3 and abs(worst - j_max) <= 1e-3
    assert r["iters"] == made[0].last_iterations
    assert abs(r["nll"] - made[0].last_nll) <= 1e-6 * abs(made[0].last_nll)


def test_two_cpu_steps_write_the_jax_scripts_keys(tmp_path, monkeypatch):
    """A 2-step run of plaza1_ada0.2 at tiny sizes: the JAX script's result
    keys (its ``result`` literal, ``hypo_final``, and the file's
    ``hypo_curve`` and ``step_times``) plus the port's two, written under
    ``TMPDIR`` with the JAX script's file name; the snapshot at step 0 and
    at the last step."""
    solver_args = pfr.solver_args
    monkeypatch.setattr(pfr, "solver_args", lambda seed: {
        **solver_args(seed), "flow_iterations": 30, "local_sample_num": 200,
        "posterior_sample_num": 100})
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert pfr.main(["plaza1_ada0.2", "1", "--limit-steps", "2",
                     "--device", "cpu"]) == 0
    r = json.loads((tmp_path / "plaza1_ada0.2_seed1_results.json")
                   .read_text())
    jax_keys = dict_keys(JAX_SCRIPT, "main", "result") | {
        "hypo_final", "hypo_curve", "step_times"}
    assert set(r) == jax_keys | {"step_rows", "backend"}
    assert r["n_steps"] == 2 and r["seed"] == 1 and r["backend"] == "cpu"
    assert r["hypo_curve"][-1]["step"] == 1
    assert r["hypo_final"] == r["hypo_curve"][-1]
    assert len(r["step_times"]) == len(r["step_rows"]) == 2
    assert np.isfinite(r["trans_rmse"]) and r["map_floor_max_err"] > 0


@pytest.mark.parametrize("limit, n_dropped", [(2, 5), (4, 11), (5, 0)])
def test_defer_da_then_cut_solves_the_jax_streams_factors(limit, n_dropped,
                                                          capsys):
    """``--defer-da --limit-steps``: plaza1_ada0.6 deferred over the whole
    stream by the JAX package's ``defer_ambiguous``, then cut, is the
    port's stream factor for factor, step for step; the runner prints how
    many deferred mixtures the cut dropped."""
    path = pfr.data_path("plaza1_ada0.6")
    *_, batches, dropped = pfr.load_stream(path, True, limit)
    assert f"{dropped} deferred mixture(s)" in capsys.readouterr().out
    j_nodes, _, j_factors = j_parse(path, "fg")
    j_all = j_group(j_nodes, j_factors, incremental_step=5)
    theirs = j_defer(j_all, max_steps=6)[:limit]
    assert [sorted(map(str, fs)) for _, fs in batches] == \
        [sorted(map(str, fs)) for _, fs in theirs]
    assert [[str(v.name) for v in ns] for ns, _ in batches] == \
        [[str(v.name) for v in ns] for ns, _ in theirs]
    n_mix = [sum(1 for _, fs in b for f in fs if len(f.vars) > 2)
             for b in (j_all[:limit], theirs)]
    assert dropped == n_mix[0] - n_mix[1] == n_dropped


def test_runner_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert pfr.main(["plaza2", "--limit-steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


TINY = dict(flow_iterations=10, local_sample_num=100, posterior_sample_num=50)


def test_plaza_family_child_readings_and_gates_on_cpu():
    """``chip_smoke``'s plaza-family child on the CPU at a tiny size (one
    step a stream): its readings survive JSON as the parent reads them;
    ``plaza_family_report`` fails on no launch of the specialised kernel
    (the CPU runs the plain version), on the divergence rule's max error
    and on its resolution, and passes otherwise."""
    r = json.loads(json.dumps(chip_smoke.plaza_family_readings(
        "cpu", {label: 1 for label in chip_smoke.PLAZA_FAMILY}, **TINY)))
    assert set(r["streams"]) == set(chip_smoke.PLAZA_FAMILY)
    deferred = r["streams"]["plaza1_ada0.6_deferda"]["result"]
    assert deferred["defer_da"] and deferred["n_steps"] == 1
    for st in r["streams"].values():
        assert st["finite"] and st["fused_vs_walk"] == 0.0
        assert st["launches"] == {"specialized": 0, "generic": 0}
        assert np.isfinite(st["max_err"]) and st["floor"]["iters"] >= 1
    assert r["launched_shapes"] == []
    with pytest.raises(SystemExit, match="never launched"):
        chip_smoke.plaza_family_report(r)
    for st in r["streams"].values():
        st["launches"]["specialized"] = 5
        st["max_err"] = 14.0
        st["result"]["hypo_final"] = {"step": 0, "n": 3,
                                      "mean_true_weight": 0.5,
                                      "resolved_frac": 0.5}
    with pytest.raises(SystemExit, match="DA resolution 0.5 < 0.7"):
        chip_smoke.plaza_family_report(r)
    for st in r["streams"].values():
        st["result"]["hypo_final"]["resolved_frac"] = 0.7
    chip_smoke.plaza_family_report(r)
    r["streams"]["plaza2"]["max_err"] = 15.5
    with pytest.raises(SystemExit, match="plaza2 divergence gate"):
        chip_smoke.plaza_family_report(r)


# --------------------------------------------------------------------------
# the JAX package's CPU figures behind chip_smoke's constants
# --------------------------------------------------------------------------
def jax_prefix_floor(label: str, steps: int) -> dict:
    """The JAX package's float32 truth-initialised floor (the runner's
    ``map_floor``) over a stream's first ``steps`` steps."""
    dataset, defer_da = chip_smoke.PLAZA_FAMILY.get(label, (label, False))
    nodes, truth, factors, batches, _ = jax_stream(
        pfr.data_path(dataset), defer_da, steps)
    m = jb.IncrementalGaussNewtonMAP()
    m.update(*pfr.solved_graph(nodes, factors, batches, True))
    return pfr.map_floor(m, truth)[2]


def jax_plaza_prefix(label: str, seed: int, steps: int) -> tuple:
    """The JAX package's ``ParallelNFiSAM`` through ``run_plaza`` on a
    plaza-family stream (``chip_smoke.PLAZA_FAMILY``'s label), its first
    ``steps`` steps at the runner's configuration, seed ``seed``, with
    each step's max posterior-mean error and DA snapshot (the read-out of
    a run cut there); then its float32 truth-initialised floor over the
    prefix.  Returns (the result record, the floor's record, per-step
    (max error, snapshot))."""
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs

    dataset, defer_da = chip_smoke.PLAZA_FAMILY[label]
    args = pfr.parse_args([dataset, str(seed), "--limit-steps", str(steps)]
                          + (["--defer-da"] if defer_da else []))
    nodes, truth, factors, batches, _ = jax_stream(
        pfr.data_path(dataset), defer_da, steps)
    by_name = {str(v.name): np.asarray(t) for v, t in truth.items()}
    solver = JParallel(JNFiSAMArgs(**pfr.solver_args(seed)))
    per_step = []

    def after_step(i, step):
        cur = {str(v.name): np.asarray(x) for v, x in
               solver._samples.materialize().items()}
        worst = float(pfr.posterior_errors(cur, by_name).max())
        snap = pfr.hypo_snapshot(solver.physical_factors, solver._samples,
                                 truth) if "ada" in dataset else None
        per_step.append((worst, snap))
        print(f"  {label} seed {seed} step {i}: max error {worst!r} m, DA "
              f"{snap}", flush=True)
    timings, hypo, samples, total = pfr.run_plaza(
        solver, batches, "cpu", truth, "ada" in dataset, after_step)
    floor = jax_prefix_floor(label, steps)
    return pfr.result_record(args, timings, hypo, samples, by_name, total,
                             (floor["rmse"], floor["max"]), "cpu"), \
        floor, per_step


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    argv = sys.argv[1:]
    n_steps = chip_smoke.PLAZA_STEPS
    if argv[:1] == ["--steps"]:
        n_steps, argv = int(argv[1]), argv[2:]
    seeds = [0, 1, 2]
    if "--seeds" in argv:
        k = argv.index("--seeds")
        seeds, argv = [int(a) for a in argv[k + 1:]], argv[:k]
    if argv[:1] == ["--floors"]:
        # the float32 floor over each prefix of 1 ... n_steps steps
        for label in argv[1:] or list(chip_smoke.PLAZA_FAMILY):
            for p in range(1, n_steps + 1):
                floor = jax_prefix_floor(label, p)
                print(f"JAX float32 floor, {label} first {p} steps: max "
                      f"{floor['max']!r} m, RMSE {floor['rmse']!r} m, "
                      f"{floor['iters']} LM iterations", flush=True)
        sys.exit(0)
    for label in argv or list(chip_smoke.PLAZA_FAMILY):
        for seed in seeds:
            r, floor, _ = jax_plaza_prefix(label, seed, n_steps)
            print(f"JAX, {label} first {n_steps} steps, seed {seed}: max "
                  f"error {r['max_err']} m, trans RMSE {r['trans_rmse']} m, "
                  f"DA snapshots {r['hypo_curve']}; the JAX float32 floor "
                  f"over the prefix: max {floor['max']!r} m, RMSE "
                  f"{floor['rmse']!r} m, {floor['iters']} LM iterations; "
                  f"diverged {r['diverged']} {r['diverged_reasons']}; "
                  f"{r['solve_s']} s of steps", flush=True)
