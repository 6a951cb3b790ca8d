"""The random_4x4 sweep: the JAX package's ``scripts/random_4x4_sweep.py``
in the port.

The ten committed datasets ``data/random_4x4_seed{k}.fg`` (16 SE(2) poses
on a 4x4 grid, landmarks, ranges; the reference's
``example/slam/manhattan_world_with_range/random_4x4/run_nfisam.py``),
each solved end to end at the reference's configuration: one pose a
step, K=9, hidden 8, at most 2000 Adam iterations, 2000 training samples,
lr 0.01, pose_first, 1000 posterior draws, solver seed 0, by
``ParallelNFiSAM``.  Each file's line gives its wall time and the
translation and landmark RMSE of the posterior means against the file's
ground truth; then the aggregate over files.  There is no gate, as in
the JAX script::

    python -m nfisam_tpu_torch.scripts.random_4x4_sweep
    python -m nfisam_tpu_torch.scripts.random_4x4_sweep --seeds 0 1 \\
        --device cpu --limit-steps 3

The run takes the JAX script's arguments (none) plus ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``), ``--out`` (the result JSON, by default the JAX script's
``random4x4_sweep.json`` in ``tempfile.gettempdir()``), ``--seeds`` (the
file indices, default 0-9) and ``--limit-steps N`` (each file's first N
steps).  Every timer ends in a synchronize on a card.  Each file's record
has the JAX script's keys and three of the port's: ``median_step_s``,
``step_rows`` (each step's wall, surgery, fit and posterior seconds,
cliques trained and AR-inverse launches) and ``backend`` ("cuda" or
"cpu").
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .manhattan_scale_run import REPO, run_incremental

SEEDS = tuple(range(10))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.random_4x4_sweep",
        description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS),
                    help="the dataset files' indices (default 0-9)")
    ap.add_argument("--limit-steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default random4x4_sweep.json in the "
                         "temporary directory)")
    return ap.parse_args(argv)


def data_path(seed_id: int) -> str:
    return os.path.join(REPO, "data", f"random_4x4_seed{seed_id}.fg")


def solver_args() -> dict:
    """The sweep's ``NFiSAMArgs`` (the JAX script's :37-40)."""
    return dict(posterior_sample_num=1000, local_sample_num=2000,
                flow_iterations=2000, num_knots=9, learning_rate=0.01,
                hidden_dim=8, elimination_method="pose_first", seed=0)


def load_stream(seed_id: int, limit_steps: int = 0, parse=None,
                group=None) -> tuple:
    """(truth, batches) of one dataset file, one pose a step, cut to
    ``limit_steps``; ``parse`` and ``group`` default to the port's."""
    if parse is None:
        from ..io import (graph_file_parser as parse,
                          group_nodes_factors_incrementally as group)
    nodes, truth, factors = parse(data_path(seed_id), "fg")
    batches = group(nodes, factors, incremental_step=1)
    return truth, batches[:limit_steps] if limit_steps else batches


def seed_record(seed_id: int, steps, samples, truth, total: float,
                backend: str) -> dict:
    """One file's record: the JAX script's ``run_seed`` result (:59-82)
    from the last step's samples, both keyed alike, plus the port's
    keys."""
    errs, lmk = [], []
    for v in samples:
        if v not in truth:
            continue
        e = float(np.linalg.norm(
            np.asarray(samples[v]).mean(0)[:2] - truth[v][:2]))
        errs.append(e)
        if str(v).startswith("L"):
            lmk.append(e)
    return {"seed": seed_id,
            "total_s": round(total, 2),
            "n_steps": len(steps),
            "trans_rmse": round(float(np.sqrt(np.mean(
                np.array(errs) ** 2))), 2),
            "landmark_rmse": round(float(np.sqrt(np.mean(
                np.array(lmk) ** 2))), 2) if lmk else None,
            "median_step_s": round(float(np.median(
                [st["s"] for st in steps])), 3),
            "step_rows": [{"step": i, "wall": round(st["s"], 4),
                           "surgery": round(st["surgery_s"], 4),
                           "fit": round(st["fit_s"], 4),
                           "posterior": round(st["posterior_s"], 4),
                           "trained": st["trained"],
                           "launches": st["launches"]}
                          for i, st in enumerate(steps)],
            "backend": backend}


def solve_stream(solver, batches, device, truth) -> tuple:
    """The JAX script's loop (:41-50) on a solver of either package
    (``run_incremental``'s split timers): (per-step timings, last step's
    host samples by name, the truth by name, the loop's seconds)."""
    t0 = time.perf_counter()
    steps, per_step = run_incremental(solver, batches, device,
                                      keep_all=False)
    total = time.perf_counter() - t0
    by_name = {str(v.name): np.asarray(t) for v, t in truth.items()}
    return steps, per_step[-1], by_name, total


def run_seed(seed_id: int, device=None, limit_steps: int = 0,
             **overrides) -> tuple:
    """One dataset file solved (``overrides`` replace fields of
    ``solver_args``).  Returns (its record, per-step timings, last step's
    host samples by name, the truth by name, the solver)."""
    from ..parallel import ParallelNFiSAM
    from ..solver import NFiSAMArgs
    from ..utils.device import resolve_device

    device = resolve_device(device)
    truth, batches = load_stream(seed_id, limit_steps)
    solver = ParallelNFiSAM(NFiSAMArgs(**{**solver_args(), **overrides}),
                            device=device)
    steps, samples, by_name, total = solve_stream(solver, batches, device,
                                                  truth)
    return (seed_record(seed_id, steps, samples, by_name, total,
                        device.type), steps, samples, by_name, solver)


def aggregate(results: list) -> dict:
    """The JAX script's aggregate (:71-78) over the files' records."""
    totals = [r["total_s"] for r in results]
    rmses = [r["trans_rmse"] for r in results]
    return {"seeds": len(results),
            "total_s_all": round(sum(totals), 1),
            "median_seed_s": round(float(np.median(totals)), 2),
            "median_rmse": round(float(np.median(rmses)), 2),
            "per_seed": results}


def main(argv=None) -> int:
    args = parse_args(argv)
    results = []
    try:
        for seed_id in args.seeds:
            record, *_ = run_seed(seed_id, args.device, args.limit_steps)
            results.append(record)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"random_4x4_sweep: {e}", file=sys.stderr)
        return 1
    for r in results:
        print(json.dumps({k: v for k, v in r.items() if k != "step_rows"}),
              flush=True)
    agg = aggregate(results)
    print(json.dumps({k: v for k, v in agg.items() if k != "per_seed"}),
          flush=True)
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   "random4x4_sweep.json")
    with open(out, "w") as fh:
        json.dump(agg, fh, indent=1)
    print(f"# wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
