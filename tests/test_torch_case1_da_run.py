"""The port's case1_da runner (``nfisam_tpu_torch.scripts.case1_da_run``)
against the JAX package's ``scripts/case1_da_run.py`` on the CPU.

The JAX script is read as source (``torch_script_ast``), never imported.
Its oracle read-out (each mixture's ``posterior_weights`` on the
sampler's joint samples, :75-85) run on the same numpy samples equals the
port's ``mixture_weights`` within 1e-6, samples that every hypothesis
misses included (ROADMAP C6); its hypothesis-weight read-back (:57-67)
parses a run directory that the JAX package's harness wrote, as the
port's does; the port's graph and stream are the JAX package's.  A CPU
run at tiny sizes writes the JAX script's keys; the oracle's key is the
sampler's default at seed 0; without a card and without ``--device cpu``
the runner exits 1.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_case1_da_run.py
[seed ...]`` runs the JAX script's own oracle statements (dynamic nested
sampling over the whole graph, 1000 live points, 3 batches) on the CPU
with the key ``[seed, 7]`` for seeds 0-2 (or those given) and prints each
run's logz, logzerr and weights on the true associations, their mean
logz and each association's worst weight: the figures behind
``chip_smoke.JAX_DA_ORACLE_LOGZ`` and ``JAX_DA_ORACLE_WORST``.  The
port's oracle for the same keys on the card, beside them (on the CPU a
``torch.Generator`` keeps only the low word of its seed, so these keys
all draw what ``[0, 7]`` draws there)::

    python3 -c 'import torch
    from nfisam_tpu_torch.scripts import case1_da_run as c
    n, _, f, _ = c.load_graph()
    for s in range(6):
        w, d, t = c.oracle_weights(n, f, torch.device("cuda"), s)
        print(c.oracle_key(s).tolist(), d["logz"], d["logzerr"], t, w)'
"""
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from nfisam_tpu.factors.mixtures import \
    BinaryFactorMixture as JMixture  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu_torch.scripts import case1_da_run as cdr  # noqa: E402
from torch_script_ast import (dict_keys, function_statements,  # noqa: E402
                              script_path)

torch.set_num_threads(1)
JAX_SCRIPT = script_path("case1_da_run.py")


class _FixedSampler:
    """A stand-in for the sampler the JAX script builds: ``sample`` hands
    back ``samples`` and fills the summary."""

    samples = None

    def __init__(self, nodes, factors):
        pass

    def sample(self, **kwargs):
        kwargs["res_summary"]["logz"] = -1.0
        return self.samples


def jax_oracle_readout(nodes, factors, samples) -> dict:
    """The JAX script's oracle statements (:71-85) on fixed joint samples:
    its ``ns_weights`` (rounded to 3 places, as the script rounds them)
    and, unrounded, the JAX package's weights on the same ``ns_map``."""
    _FixedSampler.samples = samples
    ns = {"np": np, "nodes": nodes, "factors": factors,
          "GlobalNestedSampler": _FixedSampler,
          "BinaryFactorMixture": JMixture}
    exec(function_statements(JAX_SCRIPT, "main", "summ = {}", "final = "),
         ns)
    unrounded = {str(f.observer_var.name):
                 [float(w) for w in f.posterior_weights(ns["ns_map"])]
                 for f in factors if isinstance(f, JMixture)}
    return ns["ns_weights"], unrounded


def test_graph_and_stream_are_the_jax_packages():
    nodes, truth, factors, batches = cdr.load_graph()
    j_nodes, j_truth, j_factors, j_batches = cdr.load_graph(j_parse, j_group)
    assert [str(v.name) for v in nodes] == [str(v.name) for v in j_nodes]
    assert sorted(map(str, factors)) == sorted(map(str, j_factors))
    assert len(batches) == len(j_batches) == 6
    assert [([str(v.name) for v in ns], sorted(map(str, fs)))
            for ns, fs in batches] == \
        [([str(v.name) for v in ns], sorted(map(str, fs)))
         for ns, fs in j_batches]
    for v, t in truth.items():
        np.testing.assert_array_equal(
            np.asarray(t), np.asarray(j_truth[next(
                u for u in j_truth if str(u.name) == str(v.name))]))
    assert cdr.TRUE_ASSOC == {"X1": "L1", "X2": "L1", "X3": "L2",
                              "X4": "L2"}


@pytest.mark.parametrize("case", ["truth", "scattered", "missed"])
def test_oracle_weights_equal_the_jax_scripts_on_the_same_samples(case):
    """Joint samples about the truth, scattered widely, or with a block of
    rows that every hypothesis misses (their densities underflow: C6):
    the port's weights equal the JAX package's within 1e-6 and round to
    the JAX script's."""
    nodes, truth, factors, _ = cdr.load_graph()
    j_nodes, _, j_factors, _ = cdr.load_graph(j_parse, j_group)
    rng = np.random.default_rng({"truth": 0, "scattered": 1, "missed": 2}
                                [case])
    center = np.concatenate([np.asarray(truth[v], np.float64)[:v.dim]
                             for v in nodes])
    scale = {"truth": 0.3, "scattered": 4.0, "missed": 0.3}[case]
    x = center + rng.normal(0.0, scale, (400, len(center)))
    if case == "missed":
        x[:120, :2] += 500.0
    x = x.astype(np.float32)
    theirs, theirs_unrounded = jax_oracle_readout(j_nodes, j_factors, x)
    mine = cdr.mixture_weights(nodes, factors, x)
    assert set(mine) == set(theirs) == {"X1", "X2", "X3", "X4"}
    for obs, ws in mine.items():
        np.testing.assert_allclose(ws, theirs_unrounded[obs], atol=1e-6,
                                   rtol=0)
        assert [round(w, 3) for w in ws] == theirs[obs]


def test_hypoweights_read_back_parses_a_jax_run_directory(tmp_path,
                                                          monkeypatch):
    """The JAX package's ``run_incrementally`` on case1_da's first 3 steps
    at tiny sizes writes the run directory; the JAX script's read-back and
    the port's read the same weights from it."""
    monkeypatch.setenv("NFISAM_PREWARM", "0")
    from nfisam_tpu.parallel.scheduler import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JArgs
    from nfisam_tpu.solver.run import run_incrementally as j_run

    _, truth, _, batches = cdr.load_graph(j_parse, j_group)
    solver = JParallel(JArgs(**{**cdr.solver_args(0), "flow_iterations": 20,
                                "local_sample_num": 100,
                                "posterior_sample_num": 50}))
    run_dir = j_run(str(tmp_path), solver, batches[:3], truth,
                    verbose=False)
    ns = {"os": os, "run_dir": run_dir, "batches": batches[:3]}
    exec(function_statements(JAX_SCRIPT, "main", "per_step = {}",
                             "summ = {}"), ns)
    mine = cdr.read_hypoweights(run_dir, 3)
    assert mine == ns["per_step"]
    assert set(mine) == {1, 2} and set(mine[2]) == {"X1", "X2"}
    for ws in mine[2].values():
        assert len(ws) == 2 and abs(sum(ws) - 1.0) < 1e-6


def test_oracle_key_is_the_samplers_default_at_seed_0():
    from nfisam_tpu_torch.samplers import GlobalNestedSampler
    import inspect
    src = inspect.getsource(GlobalNestedSampler.sample)
    assert "np.array([0, 7], dtype=np.uint32)" in src
    assert cdr.oracle_key(0).tolist() == [0, 7]
    assert cdr.oracle_key(2).tolist() == [2, 7]


def test_tiny_cpu_run_writes_the_jax_scripts_keys(tmp_path, monkeypatch):
    """The runner's ``main`` on the CPU at tiny flow and oracle sizes:
    the JAX script's keys and the port's, a run directory under
    ``TMPDIR``, per-step weights from step 1 on."""
    solver_args = cdr.solver_args
    monkeypatch.setattr(cdr, "solver_args", lambda seed=0: {
        **solver_args(seed), "flow_iterations": 20, "local_sample_num": 150,
        "posterior_sample_num": 80})
    monkeypatch.setattr(cdr, "ORACLE_LIVE", 60)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert cdr.main(["--device", "cpu"]) == 0
    r = json.loads((tmp_path / "case1_da_results.json").read_text())
    j_keys = dict_keys(JAX_SCRIPT, "main", "result")
    assert j_keys <= set(r)
    assert set(r) - j_keys == {
        "final_weights_unrounded", "ns_oracle_weights_unrounded",
        "ns_logzerr", "ns_niter", "ns_ncall", "oracle_s", "oracle_key",
        "launches", "step_rows", "backend"}
    assert r["run_dir"].startswith(str(tmp_path / "case1_da" / "run"))
    assert sorted(r["per_step"]) == ["1", "2", "3", "4", "5"]
    assert set(r["final_weights"]) == set(r["ns_oracle_weights"]) == \
        {"X1", "X2", "X3", "X4"}
    assert np.isfinite(r["ns_logz"]) and r["ns_niter"] > 0
    assert r["oracle_key"] == [0, 7] and r["backend"] == "cpu"
    assert r["launches"] == 0


def test_runner_solve_draws_what_the_old_phase_loop_drew(tmp_path):
    """The runner's solve (``run_incrementally``) and the loop that
    ``chip_smoke``'s phase 10 ran before it (``run_incremental``) on the
    same solver settings draw the same final samples bit for bit, so the
    phase's gate lines keep their digits; the weights read back from the
    run directory are the mixtures' weights on those samples; the
    per-step rows read back are the run's."""
    from nfisam_tpu_torch.factors import BinaryFactorMixture
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.scripts.manhattan_scale_run import run_incremental
    from nfisam_tpu_torch.solver import NFiSAMArgs

    tiny = dict(flow_iterations=20, local_sample_num=150,
                posterior_sample_num=80)
    nodes, truth, factors, batches = cdr.load_graph()
    old = ParallelNFiSAM(NFiSAMArgs(**{**cdr.solver_args(1), **tiny}),
                         device="cpu")
    _, per_step = run_incremental(old, batches, "cpu")
    run_dir, solver, _, _, launches = cdr.solve(str(tmp_path), "cpu", 1,
                                                verbose=False, **tiny)
    assert launches == 0
    mine = {str(v.name): np.asarray(x) for v, x in
            solver._samples.materialize().items()}
    assert set(mine) == set(per_step[-1])
    for name, x in per_step[-1].items():
        np.testing.assert_array_equal(mine[name], x)
    final = cdr.read_hypoweights(run_dir, len(batches))[5]
    for f in factors:
        if isinstance(f, BinaryFactorMixture):
            w = f.posterior_weights({v: mine[str(v.name)] for v in f.vars})
            assert final[str(f.observer_var.name)] == [float(x) for x in w]
    rows = cdr.step_rows(run_dir, len(batches))
    assert len(rows) == 6 and rows[0]["trained"] >= 1
    assert all(r["s"] >= r["fit_s"] >= 0.0 for r in rows)
    assert [len(r["iters"]) for r in rows] == [r["trained"] for r in rows]


def test_runner_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert cdr.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the JAX package's CPU figures behind chip_smoke's oracle gates
# --------------------------------------------------------------------------
def jax_oracle(seed: int) -> tuple:
    """The JAX script's oracle statements (:71-85) on the CPU with the key
    ``cdr.oracle_key(seed)``: (summary, unrounded weights by observer)."""
    from nfisam_tpu.samplers import GlobalNestedSampler as JSampler

    class Keyed(JSampler):
        def sample(self, **kwargs):
            return super().sample(key=cdr.oracle_key(seed), **kwargs)

    nodes, _, factors, _ = cdr.load_graph(j_parse, j_group)
    ns = {"np": np, "nodes": nodes, "factors": factors,
          "GlobalNestedSampler": Keyed, "BinaryFactorMixture": JMixture}
    exec(function_statements(JAX_SCRIPT, "main", "summ = {}", "final = "),
         ns)
    unrounded = {str(f.observer_var.name):
                 [float(w) for w in f.posterior_weights(ns["ns_map"])]
                 for f in factors if isinstance(f, JMixture)}
    return ns["summ"], unrounded


def true_weight(weights: dict, factors, observer: str) -> float:
    """The weight on ``observer``'s true association."""
    f = next(f for f in factors if isinstance(f, JMixture)
             and str(f.observer_var.name) == observer)
    names = [str(v.name) for v in f.observed_vars]
    return weights[observer][names.index(cdr.TRUE_ASSOC[observer])]


if __name__ == "__main__":
    import time

    import jax
    jax.config.update("jax_platforms", "cpu")
    seeds = [int(a) for a in sys.argv[1:]] or [0, 1, 2]
    _, _, j_factors, _ = cdr.load_graph(j_parse, j_group)
    logz, worst = [], {}
    for seed in seeds:
        t0 = time.perf_counter()
        summ, w = jax_oracle(seed)
        true_w = {o: true_weight(w, j_factors, o) for o in cdr.TRUE_ASSOC}
        print(f"JAX oracle, key {cdr.oracle_key(seed).tolist()}: logz "
              f"{summ['logz']!r} logzerr {summ['logzerr']!r} niter "
              f"{summ['niter']} ncall {summ['ncall']}; weights on the true "
              f"associations {true_w}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        logz.append(summ["logz"])
        for o, x in true_w.items():
            worst[o] = min(worst.get(o, 1.0), x)
    print(f"seeds {seeds}: mean logz {float(np.mean(logz))!r}; worst weight "
          f"on each true association {worst}", flush=True)
