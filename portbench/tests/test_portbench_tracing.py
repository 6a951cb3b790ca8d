"""The readers of the port's own spans and counters (``port_tracer.py``
and ``metrics/{simulate_s, capture_s, graph_captures, cliques_trained,
train_idle_pct}.py``) on synthetic tracer rows and records, and on a
program without the tracer."""
import sys

import pytest

from portbench import port_tracer, run
from nfisam_tpu_torch.utils.tracing import Record, Row, Tracer

READERS = ("simulate_s", "capture_s", "graph_captures", "cliques_trained",
           "train_idle_pct")


def _row(step, spans=None, counts=None):
    row = Row(step)
    row.spans = {k: list(v) for k, v in (spans or {}).items()}
    row.counts = dict(counts or {})
    return row


def _tracer(rows, records=()):
    tr = Tracer()
    tr.rows.extend(rows)
    tr.records = list(records)
    return tr


def _run(n_window, trace=None):
    return {"rows": [{"step": 1.0}] * n_window, "trace": trace}


def _trace(lo, hi, busy):
    return {"spans": {"step": [(lo, hi)]}, "busy": busy,
            "device": [(s, e, "k") for s, e in busy], "host": []}


@pytest.fixture
def use(monkeypatch):
    def install(tr):
        monkeypatch.setattr(port_tracer, "port_tracer", lambda: tr)
    return install


def test_window_rows_are_the_newest(use):
    # warm-up and traced rows first; the window's are the last three
    rows = [_row(0, {"fit.simulate": (1, 9e9)}, {"graph_captures": 9})] + [
        _row(k, {"fit.simulate": (2, k * 1e8), "train.capture": (1, 5e7)},
             {"graph_captures": 1, "cliques_trained": k})
        for k in (1, 2, 3)]
    use(_tracer(rows))
    r = _run(3)
    assert run.read_metric("simulate_s", r) == pytest.approx(0.2)
    assert run.read_metric("capture_s", r) == pytest.approx(0.05)
    assert run.read_metric("graph_captures", r) == 1.0
    assert run.read_metric("cliques_trained", r) == 2.0


def test_a_step_without_the_span_reads_zero(use):
    use(_tracer([_row(0, {"fit.simulate": (1, 3e8)}), _row(1)]))
    r = _run(2)
    assert run.read_metric("simulate_s", r) == pytest.approx(0.15)
    assert run.read_metric("capture_s", r) == 0.0
    assert run.read_metric("graph_captures", r) == 0.0


def test_too_few_rows_or_no_window_read_none(use):
    use(_tracer([_row(0)]))
    for name in READERS:
        assert run.read_metric(name, _run(2)) is None
        assert run.read_metric(name, _run(0)) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    # the parent commit's port has no ``utils.tracing``
    monkeypatch.setitem(sys.modules, "nfisam_tpu_torch.utils.tracing", None)
    assert port_tracer.port_tracer() is None
    t = _trace(0, 100, [(0, 50)])
    for name in READERS:
        assert run.read_metric(name, _run(3, t)) is None


def test_train_idle_pct_reads_the_loops_inside_the_traced_step(use):
    records = [Record("train.loop", 10, 30, 0, 5),   # busy 15-25: 10 idle
               Record("train.loop", 40, 60, 0, 5),   # busy 40-45, 50-60: 5
               Record("fit.simulate", 0, 10, 0, 5),  # another span
               Record("train.loop", 200, 300, 0, 6)]  # after the window
    use(_tracer([_row(5)], records))
    t = _trace(0, 100, [(15, 25), (35, 45), (50, 70)])
    assert run.read_metric("train_idle_pct", _run(1, t)) == \
        pytest.approx(100.0 * 15 / 40)


def test_train_idle_pct_without_loops_or_device_reads_none(use):
    use(_tracer([_row(0)], [Record("fit.simulate", 0, 10, -1, 0)]))
    assert run.read_metric("train_idle_pct",
                           _run(1, _trace(0, 100, [(0, 5)]))) is None
    assert run.read_metric("train_idle_pct", _run(1, None)) is None
    use(_tracer([_row(0)], [Record("train.loop", 0, 10, -1, 0)]))
    assert run.read_metric("train_idle_pct",
                           _run(1, _trace(0, 100, []))) is None


def test_busy_within_clips_each_interval():
    busy = [(0, 10), (20, 30), (40, 50)]
    assert port_tracer.busy_within(busy, 5, 45) == 5 + 10 + 5
    assert port_tracer.busy_within(busy, 10, 20) == 0
    assert port_tracer.busy_within(busy, 60, 70) == 0
    assert port_tracer.busy_within([], 0, 10) == 0


# ---- port_breakdown.py: the port's spans beside the result line --------

def test_window_summary_and_coverage():
    from portbench import port_breakdown as pb
    rows = [_row(0, {"train.loop": (1, 8e8), "fit.simulate": (2, 1e8)},
                 {"adam_iters": 400}),
            _row(1, {"train.loop": (1, 6e8), "train.capture": (1, 1e8)},
                 {"adam_iters": 300, "graph_captures": 1})]
    s = pb.window_summary(rows)
    assert s["spans"]["train.loop"] == [1.0, pytest.approx(0.7)]
    assert s["spans"]["fit.simulate"] == [1.0, pytest.approx(0.05)]
    assert s["counts"] == {"adam_iters": 350.0, "graph_captures": 0.5}
    cov = pb.coverage(rows, 0.85)
    assert cov["phases_s"] == pytest.approx(0.8)
    assert cov["ratio"] == pytest.approx(0.8 / 0.85)
    assert pb.coverage(rows, None)["ratio"] is None


def test_range_offsets_match_records_to_their_ranges():
    from portbench import port_breakdown as pb
    records = [Record("fit", 100, 900, -1, 0),
               Record("train.loop", 200, 800, 0, 0),
               Record("surgery", 10, 20, -1, 0)]
    host = [(95, 905, "nfisam.fit"), (150, 160, "aten::mul"),
            (230, 790, "nfisam.train.loop"), (5000, 6000, "nfisam.fit")]
    assert pb.range_offsets(records, host) == {"start_ns": 30,
                                               "end_ns": 10, "missing": 1}


def test_idle_is_named_by_the_innermost_port_span_and_host_op():
    from portbench import port_breakdown as pb
    # window 0-100; busy 0-10, 40-60, 90-100: gaps 10-40 and 60-90
    t = _trace(0, 100, [(0, 10), (40, 60), (90, 100)])
    t["host"] = sorted([(0, 100, "nfisam.fit"),
                        (20, 30, "cudaStreamSynchronize"),
                        (22, 28, "nfisam.train.loop"),
                        (61, 89, "cudaGraphLaunch")])
    records = [Record("fit", 0, 100, -1, 0),
               Record("train.loop", 5, 50, 0, 0),
               Record("fit.finish", 55, 95, 0, 0)]
    out = pb.idle_by_port_span(t, records)
    assert out["by_span"] == [["train.loop", pytest.approx(30e-9)],
                              ["fit.finish", pytest.approx(30e-9)]]
    assert sorted(out["port"]) == sorted([
        ["train.loop", "cudaStreamSynchronize", pytest.approx(30e-9)],
        ["fit.finish", "cudaGraphLaunch", pytest.approx(30e-9)]])
    # outside every record, with no host op open
    assert pb.innermost_span(records, 200) == pb.OUTSIDE
    assert pb.host_op(t["host"], [s for s, _, _ in t["host"]], 99) == \
        "idle"


def test_breakdown_reads_a_traced_run():
    from portbench import port_breakdown as pb
    rows = [_row(0, {"train.loop": (1, 9e8)}, {"adam_iters": 420}),
            _row(1, {"train.loop": (1, 8e8)}, {"adam_iters": 380})]
    t = _trace(0, 100, [(0, 50)])
    t["host"] = [(60, 90, "nfisam.train.loop")]
    records = [Record("train.loop", 55, 95, -1, 1),
               Record("train.loop", 500, 600, -1, 2)]    # after the window
    tr = _tracer(rows, records)
    out = {"metrics": {"fit_s": {"value": 0.9},
                       "adam_iters": {"value": 400.0}},
           "correct": True, "steps": 2}
    res = pb.breakdown(out, t, tr)
    assert res["adam_iters"] == {"tracer": 400.0, "metric": 400.0}
    assert res["coverage"]["ratio"] == pytest.approx(0.85 / 0.9)
    assert res["ranges"] == {"start_ns": 5, "end_ns": 5, "missing": 0}
    assert len(res["records"]) == 1
    # one gap, 50-100: the harness names it by the port's range open at
    # its middle, this script by the port's span and no host operation
    assert res["idle"]["harness"] == [["between/nfisam.train.loop",
                                       pytest.approx(50e-9)]]
    assert res["idle"]["port"] == [["train.loop", "idle",
                                    pytest.approx(50e-9)]]
    assert res["idle"]["window_s"] == pytest.approx(100e-9)
    # the one device op (0-50) starts outside every record
    assert res["device_by_span"] == [[pb.OUTSIDE, pytest.approx(50e-9)]]
    assert pb.breakdown(out, None, tr)["window"]["counts"] == \
        {"adam_iters": 400.0}


def test_span_cost_and_no_card():
    from portbench import port_breakdown as pb
    cost = pb.span_us(Tracer, calls=200)
    assert cost["off"] > 0 and cost["profiled"] > 0
    if not __import__("torch").cuda.is_available():
        assert pb.main(["--workload", "manhattan_g16.online1", "--seed",
                        "1", "--seconds", "1"]) == 2
