"""The port's tracer (``nfisam_tpu_torch.utils.tracing``): step rows always
filled, records and profiler ranges only while a profiler records, records
on the profiler's clock, the rows' bound, and the counters of a small CPU
solve against the solver's own training record."""
from __future__ import annotations

import time

import pytest
import torch

import nfisam_tpu_torch.core as core
import nfisam_tpu_torch.factors as factors
from nfisam_tpu_torch.examples.toy_examples.five_node_range_incremental \
    import five_node_graph
from nfisam_tpu_torch.parallel import ParallelNFiSAM
from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs
from nfisam_tpu_torch.utils import tracing
from nfisam_tpu_torch.utils.tracing import PREFIX, Tracer, tracer

SMALL = dict(posterior_sample_num=100, local_sample_num=200,
             flow_iterations=120, average_window=20, num_knots=8,
             learning_rate=0.03, elimination_method="pose_first")


def _work():
    torch.ones(64).sum()
    time.sleep(0.001)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_off_keeps_no_record_and_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: entered.append(name))
    tr = Tracer()
    tr.begin_step()
    with tr.span("a", x=1) as rec:
        assert rec is None
        with tr.span("a.b"):
            _work()
        tr.count("c", 3)
    with tr.span("a"):
        pass
    tr.count("c")
    assert tr.records == [] and entered == []
    row = tr.rows[-1]
    assert row.calls("a") == 2 and row.calls("a.b") == 1
    assert row.seconds("a") >= row.seconds("a.b") > 0.0
    assert row.count("c") == 4 and row.count("missing") == 0
    assert row.seconds("missing") == 0.0


def test_on_keeps_parents_steps_and_attrs():
    tr = Tracer()
    with _profile():
        with tr.span("before"):
            pass
        tr.begin_step()
        with tr.span("outer", dim=3) as rec:
            rec["late"] = 7
            with tr.span("inner"):
                with tr.span("leaf"):
                    pass
            with tr.span("inner"):
                pass
        tr.begin_step()
        with tr.span("outer"):
            pass
    with tr.span("after"):
        pass
    names = [(r.name, r.parent, r.step) for r in tr.records]
    assert names == [("before", -1, -1), ("outer", -1, 0), ("inner", 1, 0),
                     ("leaf", 2, 0), ("inner", 1, 0), ("outer", -1, 1)]
    assert tr.records[1].attrs == {"dim": 3, "late": 7}
    for r in tr.records:
        assert r.end >= r.start > 0
    outer, inner, leaf = tr.records[1:4]
    assert outer.start <= inner.start <= leaf.start <= leaf.end <= \
        inner.end <= outer.end
    assert [r.step for r in tr.rows] == [0, 1]
    assert tr.rows[0].calls("inner") == 2


def test_records_sit_on_the_profilers_clock():
    tr = Tracer()
    tr.begin_step()
    # the profiler's first range in a process starts late (its set-up)
    with _profile():
        with torch.profiler.record_function("warm-up"):
            _work()
    with _profile() as prof:
        for i in range(4):
            with tr.span(f"phase{i}"):
                with tr.span("inner"):
                    _work()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(PREFIX) and ev.device_type().name == "CPU":
            ranges.setdefault(ev.name()[len(PREFIX):], []).append(
                (ev.start_ns(), ev.end_ns()))
    assert len(tr.records) == 8
    for rec in tr.records:
        start, end = min(ranges[rec.name],
                         key=lambda r: abs(r[0] - rec.start))
        assert abs(start - rec.start) < 500_000, rec
        assert abs(end - rec.end) < 500_000, rec
    # the profiler is off again: no more records
    with tr.span("later"):
        pass
    assert len(tr.records) == 8


def test_rows_are_bounded():
    tr = Tracer()
    n = tracing.MAX_ROWS
    assert n >= 1101      # the headline stream whole
    for k in range(n + 7):
        tr.begin_step()
        tr.count("n", k)
    assert len(tr.rows) == n
    assert [r.step for r in tr.rows] == list(range(7, n + 7))
    assert [r.count("n") for r in tr.last_rows(2)] == [n + 5, n + 6]
    assert tr.last_rows(0) == [] and len(tr.last_rows(n + 50)) == n


@pytest.mark.parametrize("solver_cls", [ParallelNFiSAM, NFiSAM])
def test_solve_counters_match_the_training_record(solver_cls):
    solver = solver_cls(NFiSAMArgs(**SMALL, seed=3), device="cpu")
    first = len(tracer.records)
    with _profile():
        for nodes, fs in five_node_graph(core, factors):
            for v in nodes:
                solver.add_node(v)
            for f in fs:
                solver.add_factor(f)
            solver.update_physical_and_working_graphs()
            row = tracer.rows[-1]
            solver.fit_tree_density_models()
            solver.sample_posterior()
            trained = solver._temp_training_loss
            assert row.count("cliques_trained") == len(trained) > 0
            assert row.count("adam_iters") == sum(
                int(n) for _, n in trained.values())
            assert row.calls("fit.simulate") == len(trained)
            assert row.calls("train.loop") == len(trained)
            assert row.calls("train.init") == len(trained)
            # no card: nothing is captured
            assert row.count("graph_captures") == 0
            assert row.calls("train.capture") == 0
            assert row.calls("surgery") == 1 and row.calls("fit") == 1
            assert row.calls("posterior.draw") == 1
            assert row.seconds("fit") >= row.seconds("train.loop") > 0
    records = tracer.records[first:]
    del tracer.records[first:]
    by_index = dict(enumerate(records, start=first))
    loops = [r for r in records if r.name == "train.loop"]
    assert sum(r.attrs["iterations"] for r in loops) == sum(
        row.count("adam_iters") for row in tracer.last_rows(4))
    for r in loops:
        # train.loop inside fit.bucket inside fit (a wave between them in
        # the scheduler)
        chain = []
        p = r.parent
        while p >= 0:
            chain.append(by_index[p].name)
            p = by_index[p].parent
        assert chain[0] == "fit.bucket" and chain[-1] == "fit"
    surgery = [r for r in records if r.name == "surgery"]
    assert [r.step for r in surgery] == [row.step for row in
                                         tracer.last_rows(4)]
    assert all(r.attrs["cliques"] > 0 for r in surgery)
    draws = [r for r in records if r.name == "posterior.draw"]
    assert len(draws) == 4
