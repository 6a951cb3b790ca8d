"""The port's own spans in one ``--trace 1`` run of a cell, beside what the
result line shows::

    python3 portbench/port_breakdown.py --workload manhattan_g16.online1 \\
        --seed 7 --seconds 51 [--out chiprun_out/breakdown.json]

The run is ``run.run_cell``'s, traced as the benchmark traces it.  One
JSON line goes to standard output (``--out`` keeps it too, with the
traced records and their attributes):

- ``metrics``, ``correct``, ``steps``: the result line's;
- ``window``: each port span's mean calls and seconds a window step, and
  each counter's mean;
- ``coverage``: the mean seconds of the fit's phase spans (``PHASES``)
  over ``fit_s``;
- ``adam_iters``: the tracer's window mean beside the metric's;
- ``ranges``: the traced records against their ``nfisam.`` profiler
  ranges (the largest start and end offsets in ns, and the records
  without a range);
- ``idle``: the traced step's device idle time named two ways on the
  same trace.  ``harness`` is ``trace.idle_gaps``: the benchmark's span
  and the innermost host operation open at each gap's middle, where the
  port's ``nfisam.`` ranges count as host operations.  ``port`` names a
  gap by the port's innermost span and the innermost host operation that
  is not an ``nfisam.`` range; ``by_span`` by the port's span alone;
- ``device_by_span``: the traced step's device seconds by the port's
  innermost span open where each operation starts;
- ``span_us``: host microseconds an empty span costs with no profiler
  and under a CPU profiler (``SPAN_CALLS`` calls each way), and the
  spans a window step opens.

Exit codes: 0 with a line; 2 without a card or without the port's tracer.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import port_tracer, trace  # noqa: E402

# the fit's phases: between them they should hold ``fit_s``
PHASES = ("fit.simulate", "train.init", "train.capture", "train.loop",
          "fit.finish")
OUTSIDE = "outside the port's spans"
LOOKBACK = 64           # host operations searched back, as ``idle_gaps``
SPAN_CALLS = 20000


def window_summary(rows) -> dict:
    """{"spans": {name: [mean calls, mean s]}, "counts": {name: mean}}
    over the rows (a step without a span or counter reads 0)."""
    n = len(rows)
    names = sorted({k for r in rows for k in r.spans})
    counters = sorted({k for r in rows for k in r.counts})
    return {"spans": {k: [sum(r.calls(k) for r in rows) / n,
                          sum(r.seconds(k) for r in rows) / n]
                      for k in names},
            "counts": {k: sum(r.count(k) for r in rows) / n
                       for k in counters}}


def coverage(rows, fit_s: float) -> dict:
    """The phase spans' mean seconds a step, and their share of
    ``fit_s``."""
    phases = sum(r.seconds(k) for r in rows for k in PHASES) / len(rows)
    return {"phases_s": phases, "fit_s": fit_s,
            "ratio": phases / fit_s if fit_s else None}


def traced_records(t, records) -> list:
    """The records inside the traced window."""
    lo, hi = trace.window(t)
    return [r for r in records if lo <= r.start and r.end <= hi]


def range_offsets(records, host) -> dict:
    """Each record against the nearest-starting ``nfisam.`` range of its
    name among the trace's host events: the largest start and end
    offsets (ns), and how many records have no such range."""
    ranges = defaultdict(list)
    prefix = len("nfisam.")
    for s, e, name in host:
        if name.startswith("nfisam."):
            ranges[name[prefix:]].append((s, e))
    start = end = missing = 0
    for r in records:
        cands = ranges.get(r.name)
        if not cands:
            missing += 1
            continue
        s, e = min(cands, key=lambda c: abs(c[0] - r.start))
        start = max(start, abs(s - r.start))
        end = max(end, abs(e - r.end))
    return {"start_ns": start, "end_ns": end, "missing": missing}


def idle_gaps(t) -> list:
    """The device's idle intervals (start, end) inside the traced
    window."""
    lo, hi = trace.window(t)
    busy = [(s, e) for s, e in t["busy"] if e > lo and s < hi]
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def innermost_span(records, at: int) -> str:
    """The latest-starting record open at ``at``: the innermost, spans
    being nested."""
    name, start = OUTSIDE, None
    for r in records:
        if r.start <= at < r.end and (start is None or r.start >= start):
            name, start = r.name, r.start
    return name


def host_op(host, starts, at: int) -> str:
    """The innermost host operation open at ``at`` that is not one of the
    port's ranges ("idle" where none is)."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(i - LOOKBACK, -1), -1):
        s, e, name = host[j]
        if s <= at < e and not name.startswith("nfisam."):
            return name
    return "idle"


def idle_by_port_span(t, records, k: int = 30) -> dict:
    """The traced step's idle seconds by (the port's innermost span, host
    operation), the ``k`` largest, and by span alone."""
    host = t["host"]
    starts = [s for s, _, _ in host]
    pairs, spans = defaultdict(int), defaultdict(int)
    for a, b in idle_gaps(t):
        mid = (a + b) // 2
        span = innermost_span(records, mid)
        pairs[(span, host_op(host, starts, mid))] += b - a
        spans[span] += b - a
    return {"port": [[s, op, ns / 1e9] for (s, op), ns in
                     sorted(pairs.items(), key=lambda kv: -kv[1])[:k]],
            "by_span": [[s, ns / 1e9] for s, ns in
                        sorted(spans.items(), key=lambda kv: -kv[1])]}


def device_by_span(t, records) -> list:
    """Device seconds of the traced step by the port's innermost span open
    where each operation starts."""
    by = defaultdict(int)
    for s, e, _ in t["device"]:
        by[innermost_span(records, s)] += e - s
    return [[k, ns / 1e9] for k, ns in sorted(by.items(),
                                              key=lambda kv: -kv[1])]


def span_us(tracer_cls, calls: int = SPAN_CALLS) -> dict:
    """Microseconds an empty span costs on a fresh tracer, with no
    profiler and under a CPU profiler."""
    import torch

    def per_call(tr):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with tr.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / calls / 1e3

    off = tracer_cls()
    off.begin_step()
    per_call(off)                                   # warm
    out = {"off": per_call(off)}
    on = tracer_cls()
    on.begin_step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        per_call(on)
        on.records.clear()
        out["profiled"] = per_call(on)
    return out


def traced_run(workload: str, seed: int, seconds: float, device: str):
    """``run.run_cell`` traced, and the trace ``read_trace`` made of it."""
    from portbench import run

    kept = {}
    read = trace.read_trace

    def keep(prof):
        kept["trace"] = read(prof)
        return kept["trace"]

    trace.read_trace = keep
    try:
        out = run.run_cell(workload, seed, seconds, True, device=device)
    finally:
        trace.read_trace = read
    return out, kept.get("trace")


def breakdown(out: dict, t, tracer) -> dict:
    """What this script prints, from a traced run's result, its trace and
    the tracer."""
    rows = tracer.last_rows(out["steps"])
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    summary = window_summary(rows)
    res = {"metrics": metrics, "correct": out["correct"],
           "steps": out["steps"], "window": summary,
           "coverage": coverage(rows, metrics.get("fit_s")),
           "adam_iters": {"tracer": summary["counts"].get("adam_iters"),
                          "metric": metrics.get("adam_iters")},
           "span_us": {"per_step": sum(c for c, _ in
                                       summary["spans"].values())}}
    if t is not None:
        recs = traced_records(t, tracer.records)
        lo, hi = trace.window(t)
        res["ranges"] = range_offsets(recs, t["host"])
        res["idle"] = {"window_s": (hi - lo) / 1e9,
                       "busy_s": trace.busy_ns(t) / 1e9,
                       "harness": trace.idle_gaps(t, 30),
                       **idle_by_port_span(t, recs)}
        res["device_by_span"] = device_by_span(t, recs)
        res["records"] = [[r.name, r.start - lo, r.end - lo, r.parent,
                           r.step, r.attrs] for r in recs]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/port_breakdown.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the line, with the traced "
                    "records, to this file")
    args = ap.parse_args(argv)
    import torch
    tracer = port_tracer.port_tracer()
    if tracer is None or not torch.cuda.is_available():
        print("port_breakdown: needs a CUDA card and the port's tracer",
              file=sys.stderr)
        return 2
    out, t = traced_run(args.workload, args.seed, args.seconds, "cuda")
    res = breakdown(out, t, tracer)
    res["span_us"].update(span_us(type(tracer)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1, default=str)
    res.pop("records", None)
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
