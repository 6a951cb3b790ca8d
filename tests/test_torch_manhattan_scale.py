"""The port's Manhattan-scale runner
(``nfisam_tpu_torch.scripts.manhattan_scale_run``) against the JAX
package's ``scripts/manhattan_scale_run.py`` on the CPU.

Byte for byte: ``generate`` writes the committed g8 and headline ``.fg``
files from the JAX script's arguments.  Host only: each of the headline
stream's first 40 pose_first Bayes trees (frontal and separator names)
equals the JAX package's.  The read-out: on synthetic samples, truth and
MAP estimates, ``scale_metrics`` equals the JAX script's arithmetic
(:251-376, evaluated here with the JAX package's ``kabsch_umeyama`` and
``rigid_gauge_transform``) within 1e-9.  The runner: a 3-step CPU run at
tiny sizes writes the JAX script's result keys (without ``--out``, into
the temporary directory); its loop calls the solver and the MAP in the
JAX script's order, step by step; without a card and without ``--device
cpu`` it exits 1; ``--defer-da --limit-steps`` solves the JAX script's
factors step for step and prints what the cut dropped.

Run as a script, ``JAX_PLATFORMS=cpu python
tests/test_torch_manhattan_scale.py [--steps N] [seed ...]`` runs the
JAX package's runner loop (its ``ParallelNFiSAM`` and
``IncrementalGaussNewtonMAP``) at chip_smoke's headline prefix
(``MANHATTAN_G16_ARGV``: pose_first, the runner's configuration,
``MANHATTAN_G16_STEPS`` steps, or N) for seeds 0-2 (or the seeds
given) and prints each seed's read-out and the worst anchored RMSE, the
figure behind ``chip_smoke.JAX_MANHATTAN_G16_WORST``.
"""
import ast
import filecmp
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
import chip_smoke  # noqa: E402
from nfisam_tpu.eval.metrics import kabsch_umeyama as j_kabsch  # noqa: E402
from nfisam_tpu.eval.metrics import rigid_gauge_transform as j_rigid  # noqa: E402
from nfisam_tpu.graph import FactorGraph as JFactorGraph  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.io.stream_policy import defer_ambiguous as j_defer  # noqa: E402
from nfisam_tpu_torch.graph import FactorGraph  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.scripts import manhattan_scale_run as msr  # noqa: E402

G8 = chip_smoke.MANHATTAN_G8_FG
G16 = chip_smoke.MANHATTAN_SCALE_FG
JAX_SCRIPT = os.path.join(REPO, "scripts", "manhattan_scale_run.py")
TREE_STEPS = 40


@pytest.mark.parametrize("argv, committed", [
    (chip_smoke.MANHATTAN_G8_ARGV, G8),
    (chip_smoke.MANHATTAN_G16_ARGV, G16)])
def test_generate_writes_the_committed_file(argv, committed, tmp_path):
    a = msr.parse_args(argv)
    assert os.path.basename(committed) == \
        f"manhattan_{msr.dataset_tag(a)}.fg"
    out = str(tmp_path / "g.fg")
    msr.generate(out, grid=a.grid, n_landmarks=a.landmarks, ada_prob=a.ada,
                 sensing_range=a.sensing, range_prob=a.range_prob,
                 traj=a.traj, waypoints=a.waypoints)
    assert filecmp.cmp(out, committed, shallow=False)


@pytest.fixture(scope="module")
def headline_streams():
    nodes, _, factors = graph_file_parser(G16)
    j_nodes, _, j_factors = j_parse(G16, "fg")
    return (group_nodes_factors_incrementally(nodes, factors, 1),
            j_group(j_nodes, j_factors, incremental_step=1))


def _tree(graph_cls, batches):
    g = graph_cls()
    for ns, fs in batches:
        for v in ns:
            g.add_node(v)
        for f in fs:
            g.add_factor(f)
    tree = g.build_bayes_tree(g.analyze_elimination_ordering("pose_first"))
    return [(sorted(str(v.name) for v in c.frontal),
             sorted(str(v.name) for v in c.separator))
            for c in tree.clique_ordering()]


@pytest.mark.parametrize("steps", range(1, TREE_STEPS + 1))
def test_headline_pose_first_bayes_tree_matches_jax(steps,
                                                    headline_streams):
    ours, theirs = headline_streams
    assert _tree(FactorGraph, ours[:steps]) == \
        _tree(JFactorGraph, theirs[:steps])


def jax_readout(samples, truth, factors, fest, floor_est):
    """The JAX script's read-out arithmetic (:251-376) on dicts keyed by
    the JAX package's variables, unrounded."""
    means = {v: np.asarray(samples[v]).mean(0) for v in samples}
    errs = np.array([np.linalg.norm(means[v][:2] - truth[v][:2])
                     for v in samples if v in truth])
    lmk_errs = np.array([np.linalg.norm(means[v][:2] - truth[v][:2])
                         for v in samples
                         if v in truth and str(v.name).startswith("L")])
    keys_t = [v for v in samples if v in truth]
    A = np.stack([np.asarray(truth[v])[:2] for v in keys_t])
    B = np.stack([means[v][:2] for v in keys_t])
    R, c, t = j_kabsch(A, B)
    B_al = (c * (R @ B.T)).T + t
    mah, spread = [], []
    for v in keys_t:
        s = np.asarray(samples[v])[:, :2]
        mu, cov = s.mean(0), np.cov(s.T) + 1e-9 * np.eye(2)
        dvec = np.asarray(truth[v])[:2] - mu
        mah.append(float(dvec @ np.linalg.solve(cov, dvec)))
        spread.append(float(np.sqrt(np.trace(cov))))
    mah, spread = np.asarray(mah), np.asarray(spread)
    resid = []
    for f in factors:
        base = getattr(f, "components", [f])[0]
        if not hasattr(base, "sigma") or base.measurement_dim != 1:
            continue
        comps = [c_ for c_ in getattr(f, "components", [f])
                 if c_.vars[0] in means and c_.vars[1] in means]
        if not comps:
            continue
        resid.append(min(abs(float(np.linalg.norm(
            means[c_.vars[0]][:2] - means[c_.vars[1]][:2]))
            - float(c_.obs[0])) / float(c_.sigma) for c_ in comps))
    resid = np.asarray(resid) if resid else np.zeros(1)
    lmk_diag = []
    for v in samples:
        if not str(v.name).startswith("L") or v not in truth:
            continue
        s = np.asarray(samples[v])[:, :2]
        lmk_diag.append({"name": str(v.name),
                         "err": float(np.linalg.norm(s.mean(0)
                                                     - truth[v][:2])),
                         "std": float(np.sqrt(s.var(0).sum()))})
    ferrs = np.array([np.linalg.norm(fest[v][:2] - truth[v][:2])
                      for v in fest if v in truth])
    keys_f = [v for v in fest if v in truth]
    Af = np.stack([np.asarray(truth[v])[:2] for v in keys_f])
    Bf = np.stack([fest[v][:2] for v in keys_f])
    Rf, cf, tf_ = j_kabsch(Af, Bf)
    Bf_al = (cf * (Rf @ Bf.T)).T + tf_
    common = [v for v in means if v in fest]
    Rg, tg = j_rigid(np.stack([fest[v][:2] for v in common]),
                     np.stack([means[v][:2] for v in common]))
    anch = np.array([np.linalg.norm(Rg @ means[v][:2] + tg
                                    - np.asarray(truth[v])[:2])
                     for v in means if v in truth])
    anch_lmk = np.array([np.linalg.norm(Rg @ means[v][:2] + tg
                                        - np.asarray(truth[v])[:2])
                         for v in means
                         if v in truth and str(v.name).startswith("L")])
    flerrs = np.array([np.linalg.norm(floor_est[v][:2] - truth[v][:2])
                       for v in floor_est if v in truth])
    return {
        "trans_rmse": float(np.sqrt((errs ** 2).mean())),
        "aligned_trans_rmse": float(np.sqrt(((A - B_al) ** 2).sum(1)
                                            .mean())),
        "gauge_angle_deg": float(np.degrees(np.arctan2(R[1, 0], R[0, 0]))),
        "coverage_95_frac": float((mah <= 5.99).mean()),
        "mahalanobis_median": float(np.median(mah)),
        "posterior_spread_m": {"median": float(np.median(spread)),
                               "p90": float(np.percentile(spread, 90))},
        "range_resid_sigmas": {
            "median": float(np.median(resid)),
            "p90": float(np.percentile(resid, 90)),
            "frac_gt_4sigma": float((resid > 4.0).mean())},
        "landmark_diag": sorted(lmk_diag, key=lambda d: -d["err"]),
        "landmark_rmse": float(np.sqrt((lmk_errs ** 2).mean()))
        if len(lmk_errs) else None,
        "map_floor_rmse": float(np.sqrt((flerrs ** 2).mean())),
        "incremental_map_rmse": float(np.sqrt((ferrs ** 2).mean())),
        "incremental_map_aligned_rmse": float(np.sqrt(
            ((Af - Bf_al) ** 2).sum(1).mean())),
        "anchored_trans_rmse": float(np.sqrt((anch ** 2).mean())),
        "anchored_landmark_rmse": float(np.sqrt((anch_lmk ** 2).mean()))
        if len(anch_lmk) else None}


def _assert_close(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _assert_close(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_close(a, b, f"{path}[{i}]")
    elif isinstance(theirs, str) or theirs is None:
        assert ours == theirs, path
    else:
        assert abs(ours - theirs) <= 1e-9, (path, ours, theirs)


@pytest.mark.parametrize("seed, solved", [(0, None), (1, 40), (2, 9)])
def test_readout_matches_the_jax_scripts_arithmetic(seed, solved):
    """Synthetic posteriors of the g8 graph's first ``solved`` variables
    (all of them for None; 9 leaves ranges to unsolved poses out): samples
    scattered and shifted about the truth, a biased incremental MAP and a
    near-truth floor, keyed by name for the port and by the JAX package's
    variables for its arithmetic."""
    nodes, truth, factors = graph_file_parser(G8)
    j_nodes, j_truth, j_factors = j_parse(G8, "fg")
    keep = [str(v.name) for v in nodes[:solved]]
    rng = np.random.default_rng(seed)
    by_name = {str(v.name): np.asarray(truth[v], np.float64)
               for v in nodes}
    samples, inc, floor = {}, {}, {}
    for name in keep:
        t = by_name[name]
        shift = rng.normal(0.0, 3.0, t.shape)
        samples[name] = t + shift + rng.normal(
            0.0, rng.uniform(0.2, 4.0), (300, len(t)))
        inc[name] = (t + rng.normal(0.0, 1.5, t.shape)).astype(np.float32)
        floor[name] = (t + rng.normal(0.0, 0.2, t.shape)).astype(np.float32)
    j_of = {str(v.name): v for v in j_nodes}
    ours = msr.scale_metrics(samples, by_name, factors, inc, floor)

    def jkeyed(d):
        return {j_of[n]: x for n, x in d.items()}
    theirs = jax_readout(jkeyed(samples), j_truth, j_factors, jkeyed(inc),
                         jkeyed(floor))
    _assert_close(ours, theirs)
    assert msr.manhattan_gate(ours) == (
        theirs["trans_rmse"] <= 40.0 and theirs["anchored_trans_rmse"] <=
        2.0 * theirs["incremental_map_rmse"])


def jax_result_keys() -> set:
    """The keys of the JAX script's result file: its ``result`` dict
    literal's, ``err_curve``, ``step_rows`` and ``floor_times``."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets):
            keys = {k.value for k in node.value.keys}
            return keys | {"err_curve", "step_rows", "floor_times"}
    raise AssertionError("no result dict in the JAX script")


HEADLINE_TINY = chip_smoke.MANHATTAN_G16_ARGV + [
    "--limit-steps", "3", "--iters", "5", "--local-samples", "100",
    "--err-every", "2"]


def test_three_cpu_steps_write_the_jax_scripts_keys(tmp_path, monkeypatch,
                                                   capsys):
    """Without ``--out`` the result lands in the temporary directory,
    the JAX script's file name under this process's ``TMPDIR``; the
    ``# run:`` line beside it has no launches and no device memory on the
    CPU."""
    solver_args = msr.solver_args
    monkeypatch.setattr(msr, "solver_args", lambda a: {
        **solver_args(a), "posterior_sample_num": 50})
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert msr.main(HEADLINE_TINY + ["--device", "cpu"]) == 0
    out = tmp_path / "manhattan_scale_g16_l6_ada0.2_rp1_rw_results.json"
    r = json.loads(out.read_text())
    assert set(r) == jax_result_keys()
    assert r["n_steps"] == 3 and r["backend"] == "cpu"
    assert r["dataset"] == "scale_g16_l6_ada0.2_rp1_rw"
    assert (r["n_poses"], r["n_factors"], r["n_ambiguous"]) == \
        (1101, 2202, 236)
    assert [e["step"] for e in r["err_curve"]] == [0, 2]
    assert [row["step"] for row in r["step_rows"]] == [0, 1, 2]
    assert len(r["floor_times"]) == 3
    assert all(d == 16 for row in r["step_rows"]
               for d, _, _ in row["buckets"])
    assert np.isfinite(r["trans_rmse"]) and np.isfinite(
        r["anchored_trans_rmse"])
    run = [json.loads(line[len("# run: "):]) for line in
           capsys.readouterr().out.splitlines() if line.startswith("# run: ")]
    assert run == [{"launches_by_shape": [], "peak_device_mem_bytes": None}]


def test_stream_curve_reads_a_result(tmp_path, capsys):
    """``scripts/stream_curve`` on a result's rows: the split's totals,
    the quarter medians, every K-th row and the last, each with the error
    recorded at its step."""
    from nfisam_tpu_torch.scripts import stream_curve
    rows = [{"step": i, "wall": 1.0 + i, "surgery": 0.1, "fit": 0.5,
             "posterior": 0.4 + i, "floor": 0.2, "n_vars": i + 2,
             "launches": i + 1, "buckets": []} for i in range(10)]
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"step_rows": rows, "err_curve": [
        {"step": 0, "rmse": 5.0, "max": 9.0},
        {"step": 9, "rmse": 4.0, "max": 8.0}]}))
    assert stream_curve.main([str(path), "--every", "4"]) == 0
    head, *curve = [json.loads(x) for x in
                    capsys.readouterr().out.splitlines()]
    assert head["steps"] == 10 and head["totals"]["launches"] == 55
    np.testing.assert_allclose(
        [head["totals"][k] for k in ("wall", "surgery", "fit", "posterior",
                                     "floor")], [55.0, 1.0, 5.0, 49.0, 2.0])
    assert head["quarter_median_wall"] == [1.5, 4.0, 6.5, 9.0]
    assert [c["step"] for c in curve] == [0, 4, 8, 9]
    assert curve[0]["err"] == {"rmse": 5.0, "max": 9.0}
    assert curve[1]["err"] is None and curve[-1]["err"]["rmse"] == 4.0
    assert "buckets" not in curve[0]


def jax_loop_calls() -> tuple:
    """The JAX script's calls on its solver and its MAP inside the per-step
    loop (``for i, (ns, fs) in enumerate(batches)``, :210-249), in source
    order, and those of them made once per item of an inner loop."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For) and
             ast.unparse(n.iter) == "enumerate(batches)"]
    assert len(loops) == 1

    def calls(node):
        found = [c for c in ast.walk(node) if isinstance(c, ast.Call) and
                 isinstance(c.func, ast.Attribute) and
                 getattr(c.func.value, "id", None) in ("solver", "floor")]
        found.sort(key=lambda c: (c.lineno, c.col_offset))
        return [f"{c.func.value.id}.{c.func.attr}" for c in found]
    inner = {c for n in ast.walk(loops[0]) if isinstance(n, ast.For) and
             n is not loops[0] for c in calls(n)}
    return calls(loops[0]), inner


class _Recorder:
    """``obj`` with each call of one of its public methods appended to
    ``log`` as "who.method"; attributes read and set pass through."""

    def __init__(self, obj, who: str, log: list):
        object.__setattr__(self, "_target", (obj, who, log))

    def __getattr__(self, name):
        obj, who, log = object.__getattribute__(self, "_target")
        attr = getattr(obj, name)
        if name.startswith("_") or not callable(attr):
            return attr

        def call(*a, **k):
            log.append(f"{who}.{name}")
            return attr(*a, **k)
        return call

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_target")[0], name, value)


def test_runner_loop_calls_in_the_jax_scripts_order():
    """``run_manhattan`` (the loop that ``JAX_MANHATTAN_G16_WORST``'s
    figures come from, with the JAX package's solver and MAP) makes, step
    by step, the JAX script's calls in its order: nodes, factors, surgery,
    fit, posterior, then the incremental MAP's update and solve."""
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP, NFiSAMArgs

    args = msr.parse_args(chip_smoke.MANHATTAN_G8_ARGV + [
        "--limit-steps", "2", "--iters", "5", "--local-samples", "100"])
    _, truth, factors, batches, _ = msr.load_stream(
        args, msr.dataset_tag(args))
    log = []
    solver = _Recorder(ParallelNFiSAM(NFiSAMArgs(**{
        **msr.solver_args(args), "posterior_sample_num": 50}),
        device="cpu"), "solver", log)
    floor = _Recorder(IncrementalGaussNewtonMAP(device="cpu"), "floor", log)
    msr.run_manhattan(solver, floor, batches, "cpu", truth, factors, 1)
    per_step, inner = jax_loop_calls()
    assert per_step[-2:] == ["floor.update", "floor.solve"]
    # one entry for each run of an inner loop's calls (one a node, one a
    # factor)
    runs = [c for i, c in enumerate(log)
            if i == 0 or c not in inner or c != log[i - 1]]
    assert runs[:len(per_step) * len(batches)] == per_step * len(batches)


def test_runner_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert msr.main(HEADLINE_TINY) == 1
    assert "no CUDA device" in capsys.readouterr().err


STREAMS = {"g8": (chip_smoke.MANHATTAN_G8_ARGV, G8),
           "g16": (chip_smoke.MANHATTAN_G16_ARGV, G16)}


@pytest.mark.parametrize("stream, limit, n_dropped", [
    ("g8", 20, 2), ("g8", 40, 0), ("g16", 12, 1), ("g16", 40, 0)])
def test_defer_da_then_cut_solves_the_jax_scripts_factors(
        stream, limit, n_dropped, capsys):
    """``--defer-da --limit-steps``: the JAX script defers over the whole
    stream and then cuts (:190-195); the port's stream is the same factors
    step for step, and it prints how many deferred mixtures the cut
    dropped (those that arrived before the cut but were deferred past
    it)."""
    argv, path = STREAMS[stream]
    args = msr.parse_args(argv + ["--defer-da", "--limit-steps",
                                  str(limit)])
    *_, batches, dropped = msr.load_stream(args, msr.dataset_tag(args))
    j_nodes, _, j_factors = j_parse(path, "fg")
    j_all = j_group(j_nodes, j_factors, incremental_step=1)
    theirs = j_defer(j_all)[:limit]
    assert [sorted(map(str, fs)) for _, fs in batches] == \
        [sorted(map(str, fs)) for _, fs in theirs]
    assert [[str(v.name) for v in ns] for ns, _ in batches] == \
        [[str(v.name) for v in ns] for ns, _ in theirs]
    n_mix = [sum(1 for _, fs in b for f in fs if len(f.vars) > 2)
             for b in (j_all[:limit], theirs)]
    assert dropped == n_mix[0] - n_mix[1] == n_dropped
    assert f"{dropped} deferred mixture(s)" in capsys.readouterr().out


def test_headline_child_readings_and_gates_on_cpu(monkeypatch):
    """``chip_smoke``'s headline child on the CPU at a tiny size (2 steps):
    its readings survive JSON as the parent reads them, and
    ``manhattan_g16_report`` fails on no launch at (32, 16, 9) (the CPU
    runs the plain version), on the JAX-parity bound and on the runner's
    accuracy gate, and passes otherwise."""
    r = json.loads(json.dumps(chip_smoke.manhattan_g16_readings(
        "cpu", steps=2, local_sample_num=100, flow_iterations=5,
        posterior_sample_num=50)))
    assert len(r["steps"]) == 2 and r["finite"]
    assert r["launches"] == {"specialized": 0, "generic": 0}
    assert r["launched_shapes"] == [] and r["fused_vs_walk"] == 0.0
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_G16_WORST", 2.0)
    with pytest.raises(SystemExit, match="never launched"):
        chip_smoke.manhattan_g16_report(r)
    r["launched_shapes"] = [["specialized", 1000, 32, 16, 9]]
    r["metrics"].update(trans_rmse=5.0, anchored_trans_rmse=3.0,
                        incremental_map_rmse=4.0)
    chip_smoke.manhattan_g16_report(r)
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_G16_WORST", 1.0)
    with pytest.raises(SystemExit, match="JAX-parity"):
        chip_smoke.manhattan_g16_report(r)
    r["metrics"]["incremental_map_rmse"] = 1.0
    with pytest.raises(SystemExit, match="accuracy gate"):
        chip_smoke.manhattan_g16_report(r)


def jax_headline_prefix(seed: int,
                        steps: int = chip_smoke.MANHATTAN_G16_STEPS) -> tuple:
    """The JAX package's runner loop at ``MANHATTAN_G16_ARGV`` (its
    ``ParallelNFiSAM``, its ``IncrementalGaussNewtonMAP`` on the CPU),
    seed ``seed``, the first ``steps`` steps: (per-step timings, the
    read-out, the solver)."""
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs
    from nfisam_tpu.solver.banked_joint import IncrementalGaussNewtonMAP

    args = msr.parse_args(chip_smoke.MANHATTAN_G16_ARGV + [
        "--seed", str(seed), "--limit-steps", str(steps)])
    nodes, truth, factors = j_parse(G16, "fg")
    batches = j_group(nodes, factors,
                      incremental_step=args.step)[:args.limit_steps]
    solver = JParallel(JNFiSAMArgs(**msr.solver_args(args)))
    steps, m, _ = msr.run_manhattan(solver, IncrementalGaussNewtonMAP(),
                                    batches, "cpu", truth, factors,
                                    args.err_every)
    return steps, m, solver


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    argv = sys.argv[1:]
    n_steps = chip_smoke.MANHATTAN_G16_STEPS
    if argv[:1] == ["--steps"]:
        n_steps, argv = int(argv[1]), argv[2:]
    worst = 0.0
    for seed in [int(a) for a in argv] or [0, 1, 2]:
        steps, m, solver = jax_headline_prefix(seed, n_steps)
        at32 = sum(1 for st in steps
                   if any(d == 32 for d, _, _ in st["buckets"]))
        print(f"JAX, manhattan g16 pose_first first {n_steps} steps, seed "
              f"{seed}: "
              f"{chip_smoke.scale_line(m)}; anchored "
              f"{m['anchored_trans_rmse']!r} m; steps at the 32 bucket "
              f"{at32}; repairs {solver.mode_repair_log}; the runner's "
              f"gate {msr.manhattan_gate(m)}; "
              f"{sum(st['s'] for st in steps):.1f} s of steps", flush=True)
        worst = max(worst, m["anchored_trans_rmse"])
    print(f"worst anchored RMSE over these seeds: {worst!r} m", flush=True)
