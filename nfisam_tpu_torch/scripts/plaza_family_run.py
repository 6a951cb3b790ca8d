"""The plaza-family runner: the JAX package's ``scripts/plaza_family_run.py``
in the port.

Plaza1, Plaza2 and the ambiguous-DA variants of Plaza1 (the reference's
``example/slam/plaza_dataset/run_nfisam.py:5-21``): 5 poses a step, K=9,
hidden 8, at most 2000 Adam iterations, 2000 training samples, lr 0.01,
pose_first, 1000 posterior draws, mode repair on (``NFiSAMArgs``'
default), by ``ParallelNFiSAM``.  On a DA dataset the mean posterior
weight on each ambiguous range's true association (by the ground truth's
geometry) and the fraction resolved onto it are read every
``HYPO_EVERY`` steps and at the last.  ``--defer-da`` withholds each
ambiguous-DA mixture until its candidate landmarks have >= 2 unambiguous
factors (at most ``DEFER_MAX_STEPS`` steps)::

    python -m nfisam_tpu_torch.scripts.plaza_family_run plaza2
    python -m nfisam_tpu_torch.scripts.plaza_family_run plaza1_ada0.6 0 \\
        --defer-da --limit-steps 5

The divergence gate (exit 2, as in the JAX script): the final step's max
posterior-mean translation error <= max(3x the truth-initialised MAP
floor's max error, 15 m), and the DA resolution of the last snapshot >=
0.7.  The floor is ``IncrementalGaussNewtonMAP`` started from the ground
truth over the graph that was solved (the prefix, with ``--limit-steps``).

The run takes the JAX script's arguments (``<dataset> [seed]
[--defer-da]``) plus ``--device`` (default ``cuda``: without a card it
exits 1 unless given ``--device cpu``), ``--out`` (the result JSON, by
default the JAX script's ``<dataset>[_seed<k>][_deferda]_results.json`` in
``tempfile.gettempdir()``) and ``--limit-steps N`` (the first N steps;
failed gates are then printed, not an exit).  ``--defer-da`` with
``--limit-steps`` defers over the whole stream, then cuts, and prints how
many deferred mixtures the cut dropped.  Every timer ends in a
synchronize on a card.  The result has the JAX script's keys, and two of
the port's: ``step_rows`` (each step's wall, surgery, fit and posterior
seconds, cliques trained and AR-inverse launches) and ``backend``
("cuda" or "cpu").
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .manhattan_scale_run import (REPO, floor_from_truth, n_mixtures,
                                  run_incremental)

# the JAX script's constants: the defer bound, the snapshot cadence, the
# poses of a step, the divergence gate (3x the floor's max error, 15 m)
# and the resolution gate (a factor resolved above 0.9, 0.7 of them)
DEFER_MAX_STEPS = 6
HYPO_EVERY = 10
STEP = 5
FLOOR_FACTOR = 3.0
GATE_M = 15.0
RESOLVED_WEIGHT = 0.9
RESOLUTION_GATE = 0.7


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX script's arguments, plus ``--device``, ``--out`` and
    ``--limit-steps``."""
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.plaza_family_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("dataset", nargs="?", default="plaza2")
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--defer-da", action="store_true")
    ap.add_argument("--limit-steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default <dataset>_results.json in "
                         "the temporary directory)")
    return ap.parse_args(argv)


def data_path(dataset: str) -> str:
    return os.path.join(REPO, "data", f"{dataset}_factor_graph.fg")


def out_name(args) -> str:
    """The JAX script's result file name."""
    suffix = ("" if args.seed == 0 else f"_seed{args.seed}") + \
        ("_deferda" if args.defer_da else "")
    return f"{args.dataset}{suffix}_results.json"


def solver_args(seed: int) -> dict:
    """The runner's ``NFiSAMArgs`` (the JAX script's :129-132); mode repair
    stays at its default, on."""
    return dict(posterior_sample_num=1000, local_sample_num=2000,
                flow_iterations=2000, num_knots=9, learning_rate=0.01,
                hidden_dim=8, elimination_method="pose_first", seed=seed)


def load_stream(path: str, defer_da: bool = False, limit_steps: int = 0,
                parse=None, group=None, defer=None) -> tuple:
    """(nodes, truth, factors, batches, mixtures the cut dropped) of a
    ``.fg`` file, 5 poses a step, deferred (``defer_da``) over the whole
    stream and then cut to ``limit_steps``.  ``parse``, ``group`` and
    ``defer`` default to the port's parser, grouping and
    ``defer_ambiguous``."""
    if parse is None:
        from ..io import (defer_ambiguous as defer,
                          graph_file_parser as parse,
                          group_nodes_factors_incrementally as group)
    nodes, truth, factors = parse(path, "fg")
    batches = group(nodes, factors, incremental_step=STEP)
    dropped = 0
    if defer_da:
        cut = limit_steps or len(batches)
        arrived = n_mixtures(batches[:cut])
        batches = defer(batches, max_steps=DEFER_MAX_STEPS)
        dropped = arrived - n_mixtures(batches[:cut])
        if limit_steps:
            print(f"# --defer-da: {dropped} deferred mixture(s) past the "
                  f"--limit-steps cut, not solved", flush=True)
    if limit_steps:
        batches = batches[:limit_steps]
    return nodes, truth, factors, batches, dropped


def solved_graph(nodes, factors, batches, cut: bool) -> tuple:
    """The nodes and factors that were solved: the whole graph in the
    parser's order, or a cut stream's in arrival order."""
    if not cut:
        return nodes, factors
    return ([n for ns, _ in batches for n in ns],
            [f for _, fs in batches for f in fs])


# --------------------------------------------------------------------------
# the DA read-out
# --------------------------------------------------------------------------
def geometric_true_component(factor, truth) -> int:
    """Index of the candidate whose ground-truth distance to the observer
    best matches the measured range: the true association, which the
    ``.fg`` grammar does not label (the JAX script's :60-69)."""
    obs = float(np.asarray(factor.observation).reshape(-1)[0])
    o = np.asarray(truth[factor.vars[0]])[:2]
    ds = [abs(float(np.linalg.norm(np.asarray(truth[v])[:2] - o)) - obs)
          for v in factor.vars[1:]]
    return int(np.argmin(ds))


def hypo_snapshot(factors_in, samples, truth):
    """Over the k-way (k >= 2 candidates) DA factors whose variables all
    have samples: {"n", "mean_true_weight", "resolved_frac"} (the weight
    on the true association, its mean and the fraction above
    ``RESOLVED_WEIGHT``, rounded as the JAX script rounds them), or None
    without one (:72-99).  ``samples`` by variable, on the device or the
    host; a fused pass's are copied to the host once.  A mixture is a
    factor with ``posterior_weights`` (only ``BinaryFactorMixture`` has
    them, in either package)."""
    if hasattr(samples, "materialize"):
        samples = samples.materialize()
    have = set(samples)
    ws = [float(np.asarray(f.posterior_weights(samples))[
        geometric_true_component(f, truth)])
        for f in factors_in
        if hasattr(f, "posterior_weights") and len(f.vars) >= 3 and
        set(f.vars).issubset(have)]
    if not ws:
        return None
    ws = np.asarray(ws)
    return {"n": len(ws), "mean_true_weight": round(float(ws.mean()), 3),
            "resolved_frac": round(float((ws > RESOLVED_WEIGHT).mean()), 3)}


# --------------------------------------------------------------------------
# the loop, the floor and the gate
# --------------------------------------------------------------------------
def run_plaza(solver, batches, device, truth, is_ada: bool,
              after_step=None) -> tuple:
    """The JAX script's loop (:141-161) on a solver of either package: each
    step the nodes, the factors, the surgery, the fit and the posterior
    (``run_incremental``'s split timers), then on a DA dataset the
    hypothesis snapshot every ``HYPO_EVERY`` steps and at the last, and a
    progress line every 10 steps and after any step over 30 s;
    ``after_step(i, step timings)`` after that.  Returns (per-step
    timings, the snapshots, last step's host samples by name, the seconds
    of the whole loop)."""
    hypo_curve = []
    t_all = time.perf_counter()

    def snapshot(i, ns, fs, step):
        if is_ada and (i % HYPO_EVERY == 0 or i == len(batches) - 1):
            snap = hypo_snapshot(solver.physical_factors, solver._samples,
                                 truth)
            if snap is not None:
                hypo_curve.append({"step": i, **snap})
                print(f"step {i}: DA true-assoc weight "
                      f"{snap['mean_true_weight']} over {snap['n']} "
                      f"factors, resolved {snap['resolved_frac']}",
                      flush=True)
        if i % 10 == 0 or step["s"] > 30:
            print(f"step {i}/{len(batches)}: {step['s']:.1f}s (surgery "
                  f"{step['surgery_s']:.2f} fit {step['fit_s']:.2f} post "
                  f"{step['posterior_s']:.2f}), total "
                  f"{time.perf_counter() - t_all:.0f}s", flush=True)
        if after_step is not None:
            after_step(i, step)

    steps, per_step = run_incremental(solver, batches, device, snapshot,
                                      keep_all=False)
    return steps, hypo_curve, per_step[-1], time.perf_counter() - t_all


def map_floor(m, truth) -> tuple:
    """The truth-initialised floor (the JAX script's :102-120) on ``m``,
    an ``IncrementalGaussNewtonMAP`` of either package holding the graph
    that was solved: (RMSE, max error, the full ``floor_from_truth``
    record)."""
    r = floor_from_truth(m, truth)
    return r["rmse"], r["max"], r


def posterior_errors(samples, truth) -> np.ndarray:
    """Posterior-mean translation errors (m) of the variables with a ground
    truth; ``samples`` (n, dim) and ``truth`` keyed alike."""
    return np.array([np.linalg.norm(np.asarray(samples[v]).mean(0)[:2] -
                                    np.asarray(truth[v])[:2])
                     for v in samples if v in truth])


def divergence_reasons(max_err: float, floor_max: float, resolved) -> list:
    """The JAX script's divergence gate (:168-176): its failure lines, an
    empty list when the stream passes."""
    reasons = []
    if max_err > max(FLOOR_FACTOR * floor_max, GATE_M):
        reasons.append(f"max posterior-mean error {max_err:.1f} m > "
                       f"max(3x floor max {floor_max:.1f}, 15)")
    if resolved is not None and resolved < RESOLUTION_GATE:
        reasons.append(f"DA resolution {resolved} < 0.7")
    return reasons


def result_record(args, steps, hypo_curve, samples, truth, total, floor,
                  backend: str) -> dict:
    """The JAX script's result (:178-200 and its file's ``hypo_curve`` and
    ``step_times``), key for key, plus ``step_rows`` and ``backend``.
    ``samples`` and ``truth`` keyed alike, ``floor`` (RMSE, max)."""
    step_times = [st["s"] for st in steps]
    errs = posterior_errors(samples, truth)
    max_err = float(errs.max())
    floor_rmse, floor_max = floor
    resolved = hypo_curve[-1]["resolved_frac"] if hypo_curve else None
    reasons = divergence_reasons(max_err, floor_max, resolved)
    result = {"dataset": args.dataset,
              "seed": args.seed,
              "defer_da": args.defer_da,
              "total_s": round(total, 1),
              "solve_s": round(sum(step_times), 1),
              "n_steps": len(steps),
              "mean_step_s": round(float(np.mean(step_times)), 2),
              "median_step_s": round(float(np.median(step_times)), 2),
              "max_step_s": round(float(np.max(step_times)), 2),
              "trans_rmse": round(float(np.sqrt((errs ** 2).mean())), 3),
              "max_err": round(max_err, 2),
              "map_floor_rmse": round(floor_rmse, 3),
              "map_floor_max_err": round(floor_max, 2),
              "diverged": bool(reasons),
              "diverged_reasons": reasons}
    if hypo_curve:
        result["hypo_final"] = hypo_curve[-1]
    return {**result,
            "hypo_curve": hypo_curve,
            "step_times": [round(t, 3) for t in step_times],
            "step_rows": [{"step": i, "wall": round(st["s"], 4),
                           "surgery": round(st["surgery_s"], 4),
                           "fit": round(st["fit_s"], 4),
                           "posterior": round(st["posterior_s"], 4),
                           "trained": st["trained"],
                           "launches": st["launches"]}
                          for i, st in enumerate(steps)],
            "backend": backend}


def solve_plaza(args, **overrides) -> tuple:
    """One run at ``args`` (``parse_args``; ``overrides`` replace fields of
    ``solver_args``): the stream, the loop, the floor, the read-out.
    Returns (the result record, per-step timings, last step's host samples
    by name, the truth by name, the floor's record, the solver)."""
    from ..parallel import ParallelNFiSAM
    from ..solver import IncrementalGaussNewtonMAP, NFiSAMArgs
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    nodes, truth, factors, batches, _ = load_stream(
        data_path(args.dataset), args.defer_da, args.limit_steps)
    print(f"# {args.dataset}: {len(nodes)} variables, {len(factors)} "
          f"factors ({n_mixtures([(nodes, factors)])} ambiguous-DA); "
          f"{len(batches)} steps on {device}", flush=True)
    solver = ParallelNFiSAM(NFiSAMArgs(**{**solver_args(args.seed),
                                          **overrides}), device=device)
    steps, hypo_curve, samples, total = run_plaza(
        solver, batches, device, truth, "ada" in args.dataset)
    by_name = {str(v.name): np.asarray(t) for v, t in truth.items()}
    m = IncrementalGaussNewtonMAP(device=device)
    m.update(*solved_graph(nodes, factors, batches,
                           bool(args.limit_steps)))
    floor_rmse, floor_max, floor = map_floor(m, truth)
    result = result_record(args, steps, hypo_curve, samples, by_name, total,
                           (floor_rmse, floor_max), device.type)
    return result, steps, samples, by_name, floor, solver


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, *_ = solve_plaza(args)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"plaza_family_run: {e}", file=sys.stderr)
        return 1
    extra = ("hypo_curve", "step_times", "step_rows", "backend")
    print(json.dumps({k: v for k, v in result.items() if k not in extra}),
          flush=True)
    out = args.out or os.path.join(tempfile.gettempdir(), out_name(args))
    with open(out, "w") as fh:
        json.dump(result, fh)
    print(f"# wrote {out}", file=sys.stderr)
    if result["diverged"]:
        print("# DIVERGED STREAM: " + "; ".join(result["diverged_reasons"]),
              file=sys.stderr)
    return 2 if result["diverged"] and not args.limit_steps else 0


if __name__ == "__main__":
    sys.exit(main())
