"""Readings behind the limits of ``correct``: one cell run for several
seeds in one process (the kernels load once), each run judged as the
benchmark judges it, optionally as a control (``--override`` a solver
argument, ``--tf32``, ``--bf16``)::

    python3 portbench/readings.py --workload manhattan_g16.online1 \\
        --seeds 101 102 103 --seconds 51 --out chiprun_out/c1.jsonl
    python3 portbench/readings.py --workload manhattan_g16.online1 \\
        --seeds 1 2 3 --seconds 15 --override flow_iterations=50 --out ...

Each run's posteriors are also judged as the posteriors of a broken
program would be, derived from the same samples (``DERIVED``): rounded
to bfloat16 (the precision control: a float32 posterior served a step
lower), collapsed to each variable's mean, and the whole map turned 30
degrees about the first prior's position.

Each seed prints (and appends to ``--out``) one JSON line: the seed, the
judge's numbers and per-step readings, those of each derived posterior,
``step_s``, and each window step's host spans and the Adam iterations it
ran.  A workload BENCHMARK.json does not list is read as
``<configuration>.<traffic>``.  It needs a card, as the benchmark does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from portbench import reference, run, stream  # noqa: E402


def bf16(x):
    import torch
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def collapsed(x, _):
    return np.broadcast_to(x.mean(axis=0), x.shape)


def turned(theta):
    """The map turned by ``theta`` about ``center`` (x, y): positions
    rotated, headings turned."""
    c, s = np.cos(theta), np.sin(theta)

    def apply(x, center):
        p = x[:, :2] - center
        out = np.array(x, dtype=np.float64)
        out[:, 0] = center[0] + c * p[:, 0] - s * p[:, 1]
        out[:, 1] = center[1] + s * p[:, 0] + c * p[:, 1]
        if x.shape[1] == 3:
            out[:, 2] = reference._wrap(x[:, 2] + theta)
        return out
    return apply


DERIVED = {"bf16": lambda x, _: bf16(x), "collapsed": collapsed,
           "turned30": turned(np.pi / 6)}


def derived_checks(detail: dict, config: dict, traffic: dict,
                   n_samples: int) -> dict:
    """{name: {"correct": ..., "worst": {number: worst step's value}}} of
    each ``DERIVED`` posterior of the run's judged answers, every number
    of the judge read."""
    steps = detail["steps"]
    center = next(f.obs[:2] for vs, fs in steps for f in fs
                  if f.kind == stream.PRIOR)
    limits = {**config["limits"], **traffic.get("limits", {})}
    out = {}
    for name, change in DERIVED.items():
        answers = [(k, {v: change(np.asarray(x, np.float64), center)
                        for v, x in a.items()})
                   for k, a in detail["answers"]]
        reads = reference.judge(answers, steps, n_samples)
        worst = {n: max((r[n] for r in reads if r[n] is not None),
                        default=None) for n in reads[0] if n != "step"}
        out[name] = {"correct": run.verdict(reads, limits)[0],
                     "worst": worst}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--override", action="append", default=[],
                    help="NAME=VALUE of a solver argument (int or float)")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="each step under bfloat16 autocast")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    overrides = {}
    for item in args.override:
        name, value = item.split("=", 1)
        overrides[name] = float(value) if "." in value else int(value)
    for control in run.CONTROLS:
        if getattr(args, control):
            overrides[control] = True
    _, config, traffic, _, _ = run.cell_spec(args.workload,
                                             listed_only=False)
    n_samples = int(overrides.get("posterior_sample_num",
                                  config["solver"]["posterior_sample_num"]))
    for seed in args.seeds:
        detail = {}
        t0 = time.perf_counter()
        out = run.run_cell(args.workload, seed, args.seconds,
                           bool(args.trace), overrides=overrides,
                           detail=detail, listed_only=False)
        line = {"workload": args.workload, "seed": seed,
                "overrides": overrides, "correct": out["correct"],
                "check": out["check"], "readings": out["readings"],
                "steps": out["steps"], "metrics": out["metrics"],
                "device": out["device"], "breakdown": out.get("breakdown"),
                "run_s": time.perf_counter() - t0,
                "derived": derived_checks(detail, config, traffic,
                                          n_samples),
                "rows": detail["rows"],
                "iters": [[it for _, it in w["trained"]]
                          for w in detail["work"]],
                "dims": [[d for d, _ in w["trained"]]
                         for w in detail["work"]]}
        print(json.dumps({k: line[k] for k in
                          ("workload", "seed", "correct", "check", "steps",
                           "metrics", "run_s", "derived")}), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
