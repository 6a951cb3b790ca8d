"""The port's own tracer (``nfisam_tpu_torch.utils.tracing.tracer``) as
the per-layer readers of its spans and counters see it: the window's
steps are its last ``len(run["rows"])`` rows (one row a benchmark step:
the port opens a row as ``update_physical_and_working_graphs`` begins),
and the traced steps are its records inside ``trace.window`` of the
run's trace (the records are kept while the profiler records, on its
clock).  A program without the tracer gives None to every reader."""
from __future__ import annotations

import bisect

from portbench import trace


def port_tracer():
    """The process's tracer, or None where the program has none."""
    try:
        from nfisam_tpu_torch.utils.tracing import tracer
    except ImportError:
        return None
    return tracer


def window_rows(run):
    """The tracer's rows of the window's steps, or None where there is no
    tracer or it holds fewer rows than the window has steps."""
    tracer, k = port_tracer(), len(run["rows"])
    if tracer is None or k == 0 or len(tracer.rows) < k:
        return None
    return tracer.last_rows(k)


def mean_seconds(run, name: str):
    """Mean host seconds a window step spends in span ``name`` (0 in a
    step that never opened it)."""
    rows = window_rows(run)
    if rows is None:
        return None
    return sum(r.seconds(name) for r in rows) / len(rows)


def mean_count(run, name: str):
    """Mean total of counter ``name`` a window step."""
    rows = window_rows(run)
    if rows is None:
        return None
    return sum(r.count(name) for r in rows) / len(rows)


def traced_records(run, name: str):
    """The tracer's records of span ``name`` that lie inside the traced
    steps, or None without a trace or a tracer."""
    t, tracer = run["trace"], port_tracer()
    if t is None or tracer is None:
        return None
    lo, hi = trace.window(t)
    if hi <= lo:
        return None
    return [r for r in tracer.records
            if r.name == name and lo <= r.start and r.end <= hi]


def busy_within(busy, start: int, end: int) -> int:
    """Nanoseconds of the merged, sorted device intervals ``busy`` inside
    [start, end)."""
    i = max(bisect.bisect_right(busy, (start,)) - 1, 0)
    total = 0
    while i < len(busy) and busy[i][0] < end:
        total += max(0, min(busy[i][1], end) - max(busy[i][0], start))
        i += 1
    return total
