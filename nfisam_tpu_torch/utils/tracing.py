"""Spans and counters of the solver's phases, in one process-wide
``tracer``.

Always on, and cheap: each solver step (a row, opened when
``update_physical_and_working_graphs`` begins) keeps, for every span name,
how many times the span ran and its host nanoseconds
(``time.perf_counter_ns``, never a synchronize), and the total of every
counter.  The last ``MAX_ROWS`` rows are kept.

While a ``torch.profiler`` is recording, every span is also kept as a
``Record`` (its name, start and end, the index of the span it opened
inside, the step, its attributes) and opens a
``torch.profiler.record_function`` range named ``nfisam.`` + its name,
so that a profiler trace of the port carries its phases.  A
record's start and end are Unix nanoseconds (``time.time_ns``), the
clock ``torch.profiler`` gives its events, so a record compares directly
with the trace's device intervals.

    from nfisam_tpu_torch.utils.tracing import tracer

    with tracer.span("fit.simulate", dim=clique.dim):
        ...
    tracer.count("adam_iters", n_iters)

``span``'s ``with`` gives the record's attributes (a dict, to add what is
known only at the end) while a profiler records, else None.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

PREFIX = "nfisam."
MAX_ROWS = 4096     # solver steps kept: the 1101-step headline stream whole


class Row:
    """One solver step: ``spans[name] = [calls, host ns]``,
    ``counts[name] = total``."""

    __slots__ = ("step", "spans", "counts")

    def __init__(self, step: int) -> None:
        self.step = step
        self.spans: Dict[str, List[int]] = {}
        self.counts: Dict[str, int] = {}

    def seconds(self, name: str) -> float:
        return self.spans.get(name, (0, 0))[1] / 1e9

    def calls(self, name: str) -> int:
        return self.spans.get(name, (0, 0))[0]

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)


@dataclass
class Record:
    """One span kept on demand: Unix ns ``start`` and ``end``, ``parent``
    the index in ``tracer.records`` of the span it opened inside (-1 for
    none), ``step`` the solver step."""
    name: str
    start: int
    end: int
    parent: int
    step: int
    attrs: dict = field(default_factory=dict)


class _Span:
    __slots__ = ("tracer", "name", "attrs", "row", "t0", "record", "range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict) -> None:
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> Optional[dict]:
        tr = self.tracer
        self.row = tr._row
        self.record = self.range = None
        if _profiler_enabled():
            self.range = record_function(PREFIX + self.name)
            self.range.__enter__()
            stack = tr._open
            rec = Record(self.name, 0, 0, stack[-1] if stack else -1,
                         self.row.step, self.attrs)
            stack.append(len(tr.records))
            tr.records.append(rec)
            self.record = rec
            self.t0 = time.perf_counter_ns()
            rec.start = time.time_ns()
            return rec.attrs
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        spans = self.row.spans
        s = spans.get(self.name)
        if s is None:
            spans[self.name] = [1, dt]
        else:
            s[0] += 1
            s[1] += dt
        rec = self.record
        if rec is not None:
            rec.end = rec.start + dt
            self.tracer._open.pop()
            self.range.__exit__(None, None, None)
        return False


class Tracer:
    """The port's spans and counters (module docstring).  ``rows`` are the
    steps, newest last; ``records`` the spans kept while a profiler
    recorded."""

    def __init__(self) -> None:
        self.rows: Deque[Row] = deque(maxlen=MAX_ROWS)
        self.records: List[Record] = []
        self._open: List[int] = []
        self._steps = 0
        # spans and counts before the first step land here, in no row
        self._row = Row(-1)

    def begin_step(self) -> Row:
        """Open the next step's row."""
        self._row = Row(self._steps)
        self._steps += 1
        self.rows.append(self._row)
        return self._row

    def span(self, name: str, **attrs) -> _Span:
        """``with tracer.span(name, **attrs)``: one call of ``name`` in the
        step's row; a record and a profiler range while a profiler
        records."""
        return _Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` in the step's row."""
        counts = self._row.counts
        counts[name] = counts.get(name, 0) + n

    def last_rows(self, k: int) -> List[Row]:
        """The newest ``k`` rows (fewer if fewer are kept)."""
        if k <= 0:
            return []
        return list(self.rows)[-k:]


tracer = Tracer()
