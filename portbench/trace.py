"""Spans and the device trace of a traced run.

The harness wraps its calls into each layer in ``span(name)``: a host-clock
interval (seconds, ``time.perf_counter``) kept in memory, and the same
name as a ``torch.profiler.record_function`` range while a profiler is on,
so that the trace's idle gaps can be named by what the host was doing.
``read_trace`` reduces a ``torch.profiler`` run to what the per-layer
readers need: the device's operations (kernels, copies, sets) as
intervals, the benchmark's spans on the same clock, the host's operations
for naming gaps, and the union of device intervals (busy time).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "portbench."


class Spans:
    """Host-clock spans of one run: ``rows[k][name]`` is the seconds of
    span ``name`` in window step ``k``."""

    def __init__(self) -> None:
        self.rows: List[Dict[str, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str, sync):
        """Time ``name`` up to a synchronize; with a profiler on, also a
        ``record_function`` range of the same name."""
        rf = contextlib.nullcontext()
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(PREFIX + name)
        t0 = time.perf_counter()
        with rf:
            yield
            sync()
        self.rows[-1][name] = time.perf_counter() - t0


def _is_device(ev) -> bool:
    import torch
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    return not annotation and not ev.name().startswith(PREFIX)


def read_trace(prof) -> dict:
    """{"device": [(start_ns, end_ns, name)], "spans": {name: [(start_ns,
    end_ns)]}, "host": [(start_ns, end_ns, name)], "busy": merged device
    intervals} of a finished ``torch.profiler.profile``."""
    device, host = [], []
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if _is_device(ev):
            device.append((start, end, name))
        elif name.startswith(PREFIX):
            if ev.device_type().name == "CPU":
                spans[name[len(PREFIX):]].append((start, end))
        else:
            host.append((start, end, name))
    device.sort()
    host.sort()
    return {"device": device, "spans": dict(spans), "host": host,
            "busy": merge(device)}


def merge(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end, ...) intervals as sorted (start, end)."""
    out: List[List[int]] = []
    for start, end, *_ in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def window(trace) -> Tuple[int, int]:
    """The traced window: the first traced step's start to the last
    one's end."""
    steps = trace["spans"].get("step", [])
    if not steps:
        return 0, 0
    return min(s for s, _ in steps), max(e for _, e in steps)


def busy_ns(trace) -> int:
    lo, hi = window(trace)
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in trace["busy"])


def device_in(trace, span: str) -> float:
    """Seconds of device operations that start inside any ``span``."""
    total = 0
    for lo, hi in trace["spans"].get(span, []):
        i = bisect.bisect_left(trace["device"], (lo,))
        while i < len(trace["device"]) and trace["device"][i][0] < hi:
            total += trace["device"][i][1] - trace["device"][i][0]
            i += 1
    return total / 1e9


def top_device_ops(trace, k: int = 10) -> List[list]:
    """The ``k`` device operations by total seconds."""
    by = defaultdict(int)
    for s, e, name in trace["device"]:
        by[name] += e - s
    return [[n, t / 1e9] for n, t in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:k]]


def idle_gaps(trace, k: int = 10) -> List[list]:
    """The device's idle time inside the traced window, by what the host
    was doing at each gap's middle: the benchmark's innermost span and the
    innermost host operation open there; the ``k`` largest totals."""
    lo, hi = window(trace)
    busy = [(s, e) for s, e in trace["busy"] if e > lo and s < hi]
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    host = trace["host"]
    starts = [s for s, _, _ in host]
    spans = sorted((s, e, name) for name, ivs in trace["spans"].items()
                   if name != "step" for s, e in ivs)
    by = defaultdict(int)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        where = next((n for s, e, n in spans if s <= mid < e), "between")
        op = "idle"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][0] <= mid < host[j][1]:
                op = host[j][2]
                break
        by[f"{where}/{op}"] += b - a
    return [[n, t / 1e9] for n, t in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:k]]
