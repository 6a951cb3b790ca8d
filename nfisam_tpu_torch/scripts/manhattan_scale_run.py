"""The Manhattan-scale runner: the JAX package's
``scripts/manhattan_scale_run.py`` in the port.

A Manhattan-world range-SLAM stream past the reference's scale: a random
walk of up to ~1,100 SE(2) poses over a grid, ranges to landmarks,
ambiguous data association.  Each step adds one pose (``--step``), redoes
the graph surgery, trains the new cliques (``ParallelNFiSAM``), draws the
posterior (the fused pass), and updates and warm-solves the incremental
MAP (``IncrementalGaussNewtonMAP``), the yardstick of the accuracy gate.
The read-out and the gates are the JAX script's, key for key::

    python -m nfisam_tpu_torch.scripts.manhattan_scale_run --grid 16 \\
        --landmarks 6 --range-prob 1.0 --sensing 0 --traj random_walk \\
        --waypoints 1100 --ordering pose_first        # headline
    python -m nfisam_tpu_torch.scripts.manhattan_scale_run --grid 8 \\
        --limit-steps 11 --device cpu --iters 30 --local-samples 200

The run takes the JAX script's flags and defaults, plus ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``) and ``--out`` (the result JSON, by default the JAX script's
``manhattan_{tag}_results.json`` in the temporary directory,
``tempfile.gettempdir()``, so that each ``TMPDIR`` keeps its own).
Every timer ends in a synchronize on a card.  A missing ``.fg`` is
generated into ``data/`` by ``generate`` (the port's simulator writes
the JAX script's bytes).

Gates (exit 1, as in the JAX script, and only without ``--limit-steps``,
which prints failed gates instead): accuracy, raw translation RMSE <=
``--rmse-bound`` and the posterior anchored in the incremental MAP's
gauge <= 2x that MAP's raw RMSE; flatness, the median step wall of the
last quartile of steps <= 1.5x the second quartile's.  ``--defer-da``
with ``--limit-steps`` defers over the whole stream and then cuts, as the
JAX script does, and prints how many deferred mixtures the cut dropped.
Beside the JAX script's result, a ``# run:`` line prints the kernel's
launches by (kernel, d, h, K) and, on a card, the peak device memory the
run allocated.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the accuracy gate: raw translation RMSE <= --rmse-bound (default
# RMSE_BOUND_M) and the anchored posterior <= ANCHORED_FACTOR x the
# incremental MAP's raw RMSE; flatness: last-quartile median step wall <=
# FLAT_FACTOR x the second quartile's; the 95% ellipse of a 2-D Gaussian
RMSE_BOUND_M = 40.0
ANCHORED_FACTOR = 2.0
FLAT_FACTOR = 1.5
CHI2_2_95 = 5.99


def generate(path, grid=32, cell=10.0, n_landmarks=24, seed=7,
             ada_prob=0.2, range_std=2.0, range_prob=0.8,
             sensing_range=60.0, traj="lawnmower", waypoints=0):
    """The JAX script's deterministic dataset (``generate``), through the
    port's simulator, written to ``path`` in the ``.fg`` grammar.  Returns
    (nodes, truth, factors).

    Landmarks are scattered over the grid (interior included) when the
    sensor has a finite ``sensing_range``, else placed on the boundary; a
    ``random_walk`` trajectory of ``waypoints`` steps (default grid^2) or
    the grid's lawnmower path."""
    from ..io.fg_io import write_factor_graph_to_file
    from ..sim import (GridBeacon, GridRobot, ManhattanGrid,
                       ManhattanSimulator, SimulationArgs)
    env = ManhattanGrid((grid + 2, grid + 2), cell,
                        robot_area=[(1, 1), (grid, grid)])
    rng = np.random.default_rng(seed)
    if sensing_range:
        env.landmark_feasibility[:] = True
    cand = np.argwhere(env.landmark_feasibility)
    placed = 0
    for k in rng.permutation(len(cand)):
        i, j = cand[k]
        if env.add_landmark(GridBeacon(f"L{placed + 1}"), int(i), int(j)):
            placed += 1
        if placed >= n_landmarks:
            break
    rbt = GridRobot("X", step_scale=cell, range_std=range_std,
                    odom_cov=np.diag([0.01, 0.01, 0.001]))
    env.add_robot(rbt, 1, 1)
    sim = ManhattanSimulator(env, SimulationArgs(
        range_sensing_prob=range_prob, seed=seed, range_std=range_std,
        ambiguous_data_association_prob=ada_prob, max_da_lmk=3,
        max_sensing_range=sensing_range))
    if traj == "random_walk":
        rbt_vars, lmk_vars, factors, var2truth = sim.random_walk_slam(
            rbt, num_waypoints=waypoints or grid * grid)
    else:
        rbt_vars, lmk_vars, factors, var2truth = sim.waypoint_slam(
            rbt, env.lawnmower_path()[1:])
    nodes = rbt_vars + lmk_vars
    write_factor_graph_to_file(nodes, factors, var2truth, path)
    return nodes, var2truth, factors


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX script's flags and defaults, plus ``--device`` and
    ``--out``."""
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.manhattan_scale_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--landmarks", type=int, default=24)
    ap.add_argument("--ada", type=float, default=0.2)
    ap.add_argument("--step", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--limit-steps", type=int, default=0)
    ap.add_argument("--no-floor", action="store_true")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--local-samples", type=int, default=2000)
    ap.add_argument("--rmse-bound", type=float, default=RMSE_BOUND_M,
                    help="catastrophe bound on the raw-frame RMSE (m)")
    ap.add_argument("--err-every", type=int, default=64,
                    help="record the running translation RMSE every K "
                         "steps (one posterior copy each)")
    ap.add_argument("--sensing", type=float, default=60.0,
                    help="max sensing range in meters (0 = unbounded)")
    ap.add_argument("--range-prob", type=float, default=0.8)
    ap.add_argument("--traj", default="lawnmower",
                    choices=["lawnmower", "random_walk"])
    ap.add_argument("--waypoints", type=int, default=0,
                    help="random-walk waypoint count (default grid^2)")
    ap.add_argument("--ordering", default="ccolamd",
                    choices=["ccolamd", "pose_first", "natural"])
    ap.add_argument("--defer-da", action="store_true",
                    help="hold each ambiguous-DA mixture until its "
                         "candidate landmarks have >= 2 unambiguous "
                         "factors (at most 6 steps)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default manhattan_{tag}_"
                         "results.json in the temporary directory)")
    return ap.parse_args(argv)


def dataset_tag(args) -> str:
    tag = f"scale_g{args.grid}_l{args.landmarks}_ada{args.ada}"
    if args.sensing:
        tag += f"_s{args.sensing:g}"
    if args.range_prob != 0.8:
        tag += f"_rp{args.range_prob:g}"
    if args.traj != "lawnmower":
        tag += "_rw"
    return tag


def solver_args(args) -> dict:
    """The runner's ``NFiSAMArgs`` (the JAX script's :197-202): 1000
    draws, K=9, hidden 8 (max(8, d/2) at a bucket of d), lr 0.01, mode
    repair on."""
    return dict(posterior_sample_num=1000,
                local_sample_num=args.local_samples,
                flow_iterations=args.iters, num_knots=9, learning_rate=0.01,
                hidden_dim=8, elimination_method=args.ordering,
                seed=args.seed)


def n_mixtures(batches) -> int:
    """Ambiguous-DA mixtures (factors over more than 2 variables) in a
    batch stream."""
    return sum(1 for _, fs in batches for f in fs if len(f.vars) > 2)


def load_stream(args, tag: str):
    """The ``.fg`` for ``args`` (generated if missing) and its stream,
    deferred (``--defer-da``) and cut (``--limit-steps``) in the JAX
    script's order.  Returns (nodes, truth, factors, batches, mixtures the
    cut dropped after deferring)."""
    from ..io import (defer_ambiguous, graph_file_parser,
                      group_nodes_factors_incrementally)
    fg_path = os.path.join(REPO, "data", f"manhattan_{tag}.fg")
    if not os.path.exists(fg_path):
        print(f"# generating {fg_path}", flush=True)
        generate(fg_path, grid=args.grid, n_landmarks=args.landmarks,
                 ada_prob=args.ada, sensing_range=args.sensing,
                 range_prob=args.range_prob, traj=args.traj,
                 waypoints=args.waypoints)
    nodes, truth, factors = graph_file_parser(fg_path)
    batches = group_nodes_factors_incrementally(nodes, factors,
                                                incremental_step=args.step)
    dropped = 0
    if args.defer_da:
        cut = args.limit_steps or len(batches)
        arrived = n_mixtures(batches[:cut])
        batches = defer_ambiguous(batches)
        dropped = arrived - n_mixtures(batches[:cut])
        print(f"# --defer-da: {dropped} deferred mixture(s) past the "
              f"--limit-steps cut, not solved", flush=True)
    if args.limit_steps:
        batches = batches[:args.limit_steps]
    return nodes, truth, factors, batches, dropped


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------
def host_samples(samples) -> dict:
    """Posterior samples as host arrays by variable name (the fused pass's
    buffer in one copy)."""
    if hasattr(samples, "materialize"):
        samples = samples.materialize()
    return {str(v.name): x.cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x) for v, x in samples.items()}


def run_incremental(solver, batches, device, after_step=None,
                    keep_all: bool = True):
    """Drive an incremental solve through the solver's entry points.
    Returns (per-step timings {"s", "surgery_s", "fit_s", "posterior_s",
    "iters", "trained", "launches", "buckets"}, per-step host samples
    {name: (n, dim)}; with ``keep_all`` false only the last step's).  On a
    card every phase ends in a synchronize, so its time is the device's
    too; ``launches`` counts the AR-inverse kernel's, ``buckets`` lists
    the step's (padded dim, n, cliques) training buckets of a solver that
    logs them.  ``after_step(i, new nodes, new factors, timings)`` runs
    after each step's posterior and may add to the step's timings."""
    from ..flows import ar_inverse_kernel

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    steps, per_step = [], []
    for i, (ns, fs) in enumerate(batches):
        sync()
        launches = ar_inverse_kernel.launches
        n_buckets = len(getattr(solver, "bucket_log", []))
        t0 = time.perf_counter()
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        t1 = time.perf_counter()
        solver.fit_tree_density_models()
        sync()
        t2 = time.perf_counter()
        samples = solver._samples = solver.sample_posterior()
        sync()
        t3 = time.perf_counter()
        steps.append({"s": t3 - t0, "surgery_s": t1 - t0, "fit_s": t2 - t1,
                      "posterior_s": t3 - t2,
                      "iters": [int(t) for _, t in
                                solver._temp_training_loss.values()],
                      "trained": len(solver._temp_training_loss),
                      "launches": ar_inverse_kernel.launches - launches,
                      "buckets": list(getattr(solver, "bucket_log",
                                              [])[n_buckets:])})
        if after_step is not None:
            after_step(i, ns, fs, steps[-1])
        if keep_all or i == len(batches) - 1:
            per_step.append(host_samples(samples))
    return steps, per_step


def point_errors(est, truth) -> tuple:
    """(RMSE, max) of a point estimate's translation error (m) over the
    variables with a ground truth; both keyed alike."""
    errs = np.array([np.linalg.norm(np.asarray(est[v])[:2] -
                                    np.asarray(truth[v])[:2])
                     for v in est if v in truth])
    return float(np.sqrt(np.mean(errs ** 2))), float(errs.max())


def floor_from_truth(m, truth) -> dict:
    """The truth-initialised MAP floor (``scripts/plaza_family_run.py``
    ``map_floor``; ``manhattan_scale_run.py:366-376``): ``m``, an
    ``IncrementalGaussNewtonMAP`` of either package holding the graph,
    starts from the ground-truth column and counts as solved once, so the
    solve is warm (at most 15 LM iterations).  Returns {"rmse", "max",
    "iters", "nll", "s", "est"} with ``est`` keyed like ``truth``."""
    x = np.zeros(m.dim, np.float32)
    for v in m.vars:
        x[m.offset[v]:m.offset[v] + v.dim] = np.asarray(truth[v])[:v.dim]
    m._x = x
    m._solved_once = True
    seconds = []
    m.solve(timer=seconds)
    est = m.results()
    rmse, worst = point_errors(est, truth)
    return dict(rmse=rmse, max=worst, iters=m.last_iterations,
                nll=m.last_nll, s=seconds[0], est=est)


def run_manhattan(solver, floor, batches, device, truth, factors=None,
                  err_every: int = 0) -> tuple:
    """The runner's loop (the JAX script's :210-249) on solvers of either
    package: each step the flow solve, then (``floor`` not None) the
    incremental MAP updated and warm-solved; every ``err_every`` steps and
    at the last the running posterior-mean translation RMSE; a progress
    line every 25 steps and after any step over 20 s.  At the end the
    read-out of ``scale_metrics`` (``factors``: the whole stream's, for
    the range residuals) and the truth-initialised floor on the same MAP
    object.  ``truth`` is keyed by the package's variables.  Returns
    (per-step timings with "n_vars" and, with a floor, "floor_s" (update
    and solve: the update scores new landmarks' rings), "floor_solve_s",
    "floor_iters", "floor_nll", and "err" {"rmse", "max"} where recorded;
    the metrics; last step's host samples)."""
    by_name = {str(v.name): np.asarray(t) for v, t in truth.items()}
    t_all = time.perf_counter()

    def after_step(i, ns, fs, step):
        step["n_vars"] = len(solver.physical_vars)
        if floor is not None:
            t0 = time.perf_counter()
            floor.update(ns, fs)
            solve_s = []
            floor.solve(timer=solve_s)
            step.update(floor_s=time.perf_counter() - t0,
                        floor_solve_s=solve_s[0],
                        floor_iters=floor.last_iterations,
                        floor_nll=floor.last_nll)
        if err_every and (i % err_every == 0 or i == len(batches) - 1):
            cur = host_samples(solver._samples)
            e = np.array([np.linalg.norm(x.mean(0)[:2] - by_name[n][:2])
                          for n, x in cur.items() if n in by_name])
            step["err"] = {"rmse": round(float(np.sqrt((e ** 2).mean())), 2),
                           "max": round(float(e.max()), 2)}
            print(f"#   err@step{i}: rmse {step['err']['rmse']} max "
                  f"{step['err']['max']}", flush=True)
        if i % 25 == 0 or step["s"] > 20:
            fl = f", floor {step['floor_solve_s']:.3f}s" \
                if floor is not None else ""
            print(f"step {i}/{len(batches)}: {step['s']:.2f}s (surgery "
                  f"{step['surgery_s']:.2f} fit {step['fit_s']:.2f} post "
                  f"{step['posterior_s']:.2f}){fl}, total "
                  f"{time.perf_counter() - t_all:.0f}s", flush=True)

    steps, per_step = run_incremental(solver, batches, device, after_step,
                                      keep_all=False)
    if factors is None:
        factors = [f for _, fs in batches for f in fs]
    inc_est = floor_est = None
    if floor is not None:
        inc_est = {str(v.name): np.array(x)
                   for v, x in floor.results().items()}
        floor_est = {str(v.name): x for v, x in
                     floor_from_truth(floor, truth)["est"].items()}
    metrics = scale_metrics(per_step[-1], by_name, factors, inc_est,
                            floor_est)
    return steps, metrics, per_step[-1]


# --------------------------------------------------------------------------
# the read-out and the gates
# --------------------------------------------------------------------------
def _rms(e) -> float:
    return float(np.sqrt((np.asarray(e) ** 2).mean()))


def _aligned_rmse(A, B) -> tuple:
    """Similarity (Kabsch-Umeyama) alignment of ``B`` to ``A``: (RMSE
    after it, the rotation)."""
    from ..eval import kabsch_umeyama
    R, c, t = kabsch_umeyama(A, B)
    B_al = (c * (R @ B.T)).T + t
    return float(np.sqrt(((A - B_al) ** 2).sum(1).mean())), R


def scale_metrics(samples, truth, factors, inc_est=None,
                  floor_est=None) -> dict:
    """The JAX script's accuracy read-out (:251-376), unrounded, under its
    result keys; ``samples`` {name: (n, dim)}, ``truth``, ``inc_est`` (the
    incremental MAP) and ``floor_est`` (the truth-initialised floor)
    {name: point}; ``factors`` of either package (the range residuals
    use those whose variables were solved).  Raw translation RMSE of the
    posterior means, after a similarity alignment to the truth (and its
    rotation), 95% coverage and the median Mahalanobis distance of the
    truth under each variable's sample covariance, the samples' spread,
    the range residuals in sigmas, each landmark's error and spread; with
    the MAP estimates, their RMSE (raw and aligned) and the posterior
    anchored in the incremental MAP's gauge (a rigid transform fitted to
    the MAP, truth unseen)."""
    from ..eval import rigid_gauge_transform

    means = {n: np.asarray(x).mean(0) for n, x in samples.items()}
    keys = [n for n in samples if n in truth]
    lmks = [n for n in keys if n.startswith("L")]
    errs = np.array([np.linalg.norm(means[n][:2] - truth[n][:2])
                     for n in keys])
    lmk_errs = np.array([np.linalg.norm(means[n][:2] - truth[n][:2])
                         for n in lmks])
    A = np.stack([np.asarray(truth[n])[:2] for n in keys])
    B = np.stack([means[n][:2] for n in keys])
    aligned, R = _aligned_rmse(A, B)
    mah, spread = [], []
    for n in keys:
        s = np.asarray(samples[n])[:, :2]
        mu, cov = s.mean(0), np.cov(s.T) + 1e-9 * np.eye(2)
        d = np.asarray(truth[n])[:2] - mu
        mah.append(float(d @ np.linalg.solve(cov, d)))
        spread.append(float(np.sqrt(np.trace(cov))))
    mah, spread = np.asarray(mah), np.asarray(spread)
    resid = []
    for f in factors:
        comps = getattr(f, "components", [f])
        if not hasattr(comps[0], "sigma") or comps[0].measurement_dim != 1:
            continue
        comps = [c for c in comps if str(c.vars[0].name) in means and
                 str(c.vars[1].name) in means]
        if comps:
            resid.append(min(abs(float(np.linalg.norm(
                means[str(c.vars[0].name)][:2] -
                means[str(c.vars[1].name)][:2])) - float(c.obs[0])) /
                float(c.sigma) for c in comps))
    resid = np.asarray(resid) if resid else np.zeros(1)
    m = {
        "trans_rmse": _rms(errs),
        "aligned_trans_rmse": aligned,
        "gauge_angle_deg": float(np.degrees(np.arctan2(R[1, 0], R[0, 0]))),
        "coverage_95_frac": float((mah <= CHI2_2_95).mean()),
        "mahalanobis_median": float(np.median(mah)),
        "posterior_spread_m": {"median": float(np.median(spread)),
                               "p90": float(np.percentile(spread, 90))},
        "range_resid_sigmas": {
            "median": float(np.median(resid)),
            "p90": float(np.percentile(resid, 90)),
            "frac_gt_4sigma": float((resid > 4.0).mean())},
        "landmark_diag": sorted(
            [{"name": n,
              "err": float(np.linalg.norm(means[n][:2] - truth[n][:2])),
              "std": float(np.sqrt(np.asarray(samples[n])[:, :2].var(0)
                                   .sum()))} for n in lmks],
            key=lambda d: -d["err"]),
        "landmark_rmse": _rms(lmk_errs) if len(lmk_errs) else None,
        "map_floor_rmse": None, "incremental_map_rmse": None,
        "incremental_map_aligned_rmse": None, "anchored_trans_rmse": None,
        "anchored_landmark_rmse": None}
    if inc_est is not None:
        inc = [n for n in inc_est if n in truth]
        m["incremental_map_rmse"] = point_errors(inc_est, truth)[0]
        m["incremental_map_aligned_rmse"] = _aligned_rmse(
            np.stack([np.asarray(truth[n])[:2] for n in inc]),
            np.stack([np.asarray(inc_est[n])[:2] for n in inc]))[0]
        common = [n for n in means if n in inc_est]
        Rg, tg = rigid_gauge_transform(
            np.stack([np.asarray(inc_est[n])[:2] for n in common]),
            np.stack([means[n][:2] for n in common]))
        anch = {n: np.linalg.norm(Rg @ means[n][:2] + tg -
                                  np.asarray(truth[n])[:2])
                for n in keys}
        m["anchored_trans_rmse"] = _rms(list(anch.values()))
        m["anchored_landmark_rmse"] = _rms([anch[n] for n in lmks]) \
            if lmks else None
    if floor_est is not None:
        m["map_floor_rmse"] = point_errors(floor_est, truth)[0]
    return m


def manhattan_gate(m: dict, rmse_bound: float = RMSE_BOUND_M) -> bool:
    """The runner's accuracy gate (the JAX script's :433-436) on
    ``scale_metrics``' read-out: raw RMSE <= ``rmse_bound`` and, with the
    incremental MAP, anchored <= ANCHORED_FACTOR x its raw RMSE; always
    true without a MAP floor."""
    if m["map_floor_rmse"] is None:
        return True
    return bool(m["trans_rmse"] <= rmse_bound and (
        m["anchored_trans_rmse"] is None or m["anchored_trans_rmse"] <=
        ANCHORED_FACTOR * m["incremental_map_rmse"]))


def _r(x, nd):
    return None if x is None else round(x, nd)


def result_record(tag, nodes, factors, batches, steps, m, solver, total_s,
                  rmse_bound, backend) -> dict:
    """The JAX script's result (:378-457), key for key, from the loop's
    timings and the read-out ``m``: the flatness figures and spike steps,
    the rounded read-out, the gate, the floor's first- and last-quartile
    solve time, the bucket-population histogram, mode repair's events,
    ``backend`` ("cuda" or "cpu"); then ``err_curve``, ``step_rows`` and
    ``floor_times`` as the JAX script writes them to its file (each step
    row also with its floor update-and-solve seconds and LM iterations,
    AR-inverse launches and training buckets)."""
    n_poses = sum(1 for v in nodes if v.dim == 3)
    walls = np.array([st["s"] for st in steps])
    n = len(walls)
    q2 = float(np.median(walls[n // 4: n // 2])) if n >= 8 else None
    q4 = float(np.median(walls[3 * n // 4:])) if n >= 8 else None
    spikes = sorted(range(n), key=lambda i: -walls[i])[:10]
    floor_times = [st["floor_solve_s"] for st in steps
                   if "floor_solve_s" in st]
    quarter = max(1, len(floor_times) // 4)
    hist = {}
    if solver.bucket_log:
        hist = {str(b): int(c) for b, c in zip(*np.unique(
            [b for (_, _, b) in solver.bucket_log], return_counts=True))}
    return {
        "dataset": tag, "n_poses": n_poses, "n_factors": len(factors),
        "n_ambiguous": sum(1 for f in factors if len(f.vars) > 2),
        "n_steps": len(batches), "total_s": round(total_s, 1),
        "median_step_s": round(float(np.median(walls)), 3),
        "p90_step_s": round(float(np.percentile(walls, 90)), 3),
        "p99_step_s": round(float(np.percentile(walls, 99)), 3),
        "q2_median_s": q2 and round(q2, 3),
        "q4_median_s": q4 and round(q4, 3),
        "flat_ok_1.5x": bool(q2 is None or q4 <= FLAT_FACTOR * q2),
        "spike_steps": [{"step": int(i), "wall": round(float(walls[i]), 2),
                         "fit": round(steps[i]["fit_s"], 2),
                         "posterior": round(steps[i]["posterior_s"], 2),
                         "surgery": round(steps[i]["surgery_s"], 2)}
                        for i in spikes],
        "trans_rmse": round(m["trans_rmse"], 3),
        "aligned_trans_rmse": round(m["aligned_trans_rmse"], 3),
        "gauge_angle_deg": round(m["gauge_angle_deg"], 2),
        "coverage_95_frac": round(m["coverage_95_frac"], 3),
        "mahalanobis_median": round(m["mahalanobis_median"], 2),
        "posterior_spread_m": {k: round(v, 2) for k, v in
                               m["posterior_spread_m"].items()},
        "range_resid_sigmas": {
            k: round(v, 3 if k == "frac_gt_4sigma" else 2)
            for k, v in m["range_resid_sigmas"].items()},
        "landmark_diag": [{"name": d["name"], "err": round(d["err"], 2),
                           "std": round(d["std"], 2)}
                          for d in m["landmark_diag"]],
        "landmark_rmse": _r(m["landmark_rmse"], 3),
        "map_floor_rmse": _r(m["map_floor_rmse"], 3),
        "incremental_map_rmse": _r(m["incremental_map_rmse"], 3),
        "incremental_map_aligned_rmse": _r(
            m["incremental_map_aligned_rmse"], 3),
        "anchored_trans_rmse": _r(m["anchored_trans_rmse"], 3),
        "anchored_landmark_rmse": _r(m["anchored_landmark_rmse"], 3),
        "rmse_bound": rmse_bound,
        "accuracy_gate": manhattan_gate(m, rmse_bound),
        "floor_step_s": {
            "first_quartile_median": round(float(np.median(
                floor_times[:quarter])), 3),
            "last_quartile_median": round(float(np.median(
                floor_times[-quarter:])), 3),
        } if floor_times else None,
        "bucket_population_hist": hist,
        "mode_repair_events": len(solver.mode_repair_log),
        "mode_repair_vars": sorted(set(map(str, solver.mode_repair_log))),
        "backend": backend,
        "err_curve": [{"step": i, **st["err"]} for i, st in enumerate(steps)
                      if "err" in st],
        "step_rows": [{"step": i, "wall": round(st["s"], 4),
                       "surgery": round(st["surgery_s"], 4),
                       "fit": round(st["fit_s"], 4),
                       "posterior": round(st["posterior_s"], 4),
                       "n_vars": st["n_vars"],
                       "floor": round(st.get("floor_s", 0.0), 4),
                       "floor_iters": st.get("floor_iters"),
                       "launches": st["launches"],
                       "buckets": st["buckets"]}
                      for i, st in enumerate(steps)],
        "floor_times": [round(t, 4) for t in floor_times],
    }


def run_facts(shape_launches, peak_mem) -> dict:
    """What the JAX script's result leaves out: the AR-inverse kernel's
    launches by (kernel, d, h, K) and the peak device memory allocated
    (bytes; None off a card)."""
    return {"launches_by_shape": [
                {"kernel": v, "d": d, "h": h, "K": K, "launches": c}
                for (v, d, h, K), c in sorted(shape_launches.items())],
            "peak_device_mem_bytes": peak_mem}


def gate_failures(result: dict) -> list:
    """The JAX script's failed gates (:468-476), one line each."""
    fails = []
    if not result["flat_ok_1.5x"]:
        fails.append(f"FLATNESS GATE: q4 median {result['q4_median_s']:.3f}"
                     f"s > {FLAT_FACTOR}x q2 median "
                     f"{result['q2_median_s']:.3f}s")
    if not result["accuracy_gate"]:
        fails.append(
            f"ACCURACY GATE: raw RMSE {result['trans_rmse']:.2f} (bound "
            f"{result['rmse_bound']}) / anchored "
            f"{result['anchored_trans_rmse']} vs {ANCHORED_FACTOR}x "
            f"incremental MAP {result['incremental_map_rmse']}")
    return fails


def solve_manhattan(args, **overrides) -> tuple:
    """One run at ``args`` (``parse_args``; ``overrides`` replace fields
    of ``solver_args``): the stream, the loop, the read-out.  Returns (the
    result record, per-step timings, the metrics, last step's host
    samples, the solver)."""
    from ..parallel import ParallelNFiSAM
    from ..solver import IncrementalGaussNewtonMAP, NFiSAMArgs
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    tag = dataset_tag(args)
    nodes, truth, factors, batches, _ = load_stream(args, tag)
    n_poses = sum(1 for v in nodes if v.dim == 3)
    n_mix = sum(1 for f in factors if len(f.vars) > 2)
    print(f"# workload: {n_poses} poses, {len(nodes) - n_poses} landmarks,"
          f" {len(factors)} factors ({n_mix} ambiguous-DA); "
          f"{len(batches)} steps on {device}", flush=True)
    if args.defer_da:
        tag += "_deferda"
    solver = ParallelNFiSAM(NFiSAMArgs(**{**solver_args(args), **overrides}),
                            device=device)
    floor = None if args.no_floor else IncrementalGaussNewtonMAP(
        device=device)
    from ..flows import ar_inverse_kernel
    before = dict(ar_inverse_kernel.shape_launches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    steps, m, samples = run_manhattan(solver, floor, batches, device, truth,
                                      factors, args.err_every)
    total = time.perf_counter() - t0
    if m["map_floor_rmse"] is not None:
        print(f"# floor: truth-init batch {m['map_floor_rmse']:.3f}, "
              f"incremental warm-path {m['incremental_map_rmse']:.3f}",
              flush=True)
    result = result_record(tag, nodes, factors, batches, steps, m, solver,
                           total, args.rmse_bound, device.type)
    print("# run: " + json.dumps(run_facts(
        {k: n - before.get(k, 0) for k, n in
         ar_inverse_kernel.shape_launches.items() if n > before.get(k, 0)},
        torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else None)), flush=True)
    print(f"# ar_inverse launches by kernel "
          f"{ar_inverse_kernel.variant_launches}, at (kernel, n, d, h, K) "
          f"{sorted(ar_inverse_kernel.launched_shapes)}", flush=True)
    return result, steps, m, samples, solver


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, *_ = solve_manhattan(args)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"manhattan_scale_run: {e}", file=sys.stderr)
        return 1
    extra = ("err_curve", "step_rows", "floor_times")
    print(json.dumps({k: v for k, v in result.items() if k not in extra}),
          flush=True)
    out = args.out or os.path.join(
        tempfile.gettempdir(), f"manhattan_{result['dataset']}_results.json")
    with open(out, "w") as fh:
        json.dump(result, fh)
    print(f"# wrote {out}", file=sys.stderr)
    fails = gate_failures(result)
    if fails:
        print("\n".join("# " + f for f in fails), file=sys.stderr)
    return 1 if fails and not args.limit_steps else 0


if __name__ == "__main__":
    sys.exit(main())
