"""The port's random_4x4 sweep (``nfisam_tpu_torch.scripts.random_4x4_sweep``)
against the JAX package's ``scripts/random_4x4_sweep.py`` on the CPU.

The JAX script is read as source (``torch_script_ast``), never imported.
Its ``run_seed`` read-out and ``main`` aggregate, run on synthetic
samples, equal the port's within 1e-9, key for key; the port's stream of
each file is the JAX package's, step for step.  The sweep: a 2-step run
of two files at tiny sizes writes the JAX script's keys (without
``--out``, under ``TMPDIR``); without a card and without ``--device cpu``
it exits 1.  ``chip_smoke``'s random_4x4 child runs on the CPU at a tiny
size, and its gates fail where they should.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_random_4x4.py
[file ...] [--seeds S ...]`` solves each of ``chip_smoke.RANDOM_4X4_FILES``
(or the files named) with the JAX package's ``ParallelNFiSAM`` through
the port sweep's loop (``solve_stream``) at the sweep's configuration, for
solver seeds 0-2 (or those given), and prints each run's translation RMSE
and each file's worst: the figures behind ``chip_smoke.JAX_RANDOM_4X4_WORST``.
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
import chip_smoke  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu_torch.scripts import random_4x4_sweep as r44  # noqa: E402
from torch_script_ast import (dict_keys, function_statements,  # noqa: E402
                              script_path)

torch.set_num_threads(1)
JAX_SCRIPT = script_path("random_4x4_sweep.py")


@pytest.mark.parametrize("seed_id", range(10))
def test_each_files_stream_is_the_jax_packages(seed_id):
    """Every committed file, one pose a step: the same nodes and factors
    step for step in both packages (``load_stream``)."""
    _, ours = r44.load_stream(seed_id)
    _, theirs = r44.load_stream(seed_id, parse=j_parse, group=j_group)
    assert len(ours) == len(theirs) == 16
    assert [([str(v.name) for v in ns], sorted(map(str, fs)))
            for ns, fs in ours] == \
        [([str(v.name) for v in ns], sorted(map(str, fs)))
         for ns, fs in theirs]


def jax_run_seed_readout(samples, truth, batches, total) -> dict:
    """The JAX script's ``run_seed`` from the final samples to its record
    (:51-63): its own statements, on samples and truth keyed by the JAX
    package's variables."""
    ns = {"np": np, "samples": samples, "truth": truth, "batches": batches,
          "total": total, "seed_id": 3}
    exec(function_statements(JAX_SCRIPT, "run_seed", "errs, lmk = "), ns)
    return ns["_return"]


@pytest.mark.parametrize("rng_seed, poses_only", [(0, False), (1, True)])
def test_readout_matches_the_jax_scripts_arithmetic(rng_seed, poses_only):
    """File 3's variables (all, or its poses alone, so that no landmark is
    solved) with samples scattered about the truth: the
    port's ``seed_record`` equals the JAX script's on every JAX key, and
    the port's ``aggregate`` over three records its ``main``'s."""
    truth, batches = r44.load_stream(3)
    j_truth, j_batches = r44.load_stream(3, parse=j_parse, group=j_group)
    rng = np.random.default_rng(rng_seed)
    names = [str(v.name) for ns, _ in batches for v in ns
             if not (poses_only and str(v.name).startswith("L"))]
    s = {}
    for v, t in truth.items():
        if str(v.name) in names:
            t = np.asarray(t, np.float64)
            s[str(v.name)] = (t + rng.normal(0.0, 2.0, t.shape) +
                              rng.normal(0.0, 1.0, (300, len(t))))
    j_samples = {v: s[str(v.name)] for v in j_truth if str(v.name) in s}
    theirs = jax_run_seed_readout(j_samples, j_truth, j_batches, 12.345)
    steps = [{"s": 0.5, "surgery_s": 0.0, "fit_s": 0.5, "posterior_s": 0.0,
              "trained": 1, "launches": 0}] * len(j_batches)
    by_name = {str(v.name): np.asarray(t) for v, t in truth.items()}
    mine = r44.seed_record(3, steps, s, by_name, 12.345, "cpu")
    assert set(theirs) <= set(mine)
    for k, v in theirs.items():
        assert (mine[k] is None and v is None) or abs(mine[k] - v) <= 1e-9, k
    assert (theirs["landmark_rmse"] is None) == poses_only
    results = [dict(mine, seed=k, total_s=t, trans_rmse=e) for k, t, e in
               ((0, 3.0, 1.5), (1, 9.5, 4.25), (2, 4.0, 2.0))]
    ns = {"np": np, "results": results}
    exec(function_statements(JAX_SCRIPT, "main", "totals = ",
                             "print(json.dumps("), ns)
    agg = r44.aggregate(results)
    assert {k: agg[k] for k in ns["agg"]} == \
        {**ns["agg"], "seeds": len(results)}


def test_two_files_two_cpu_steps_write_the_jax_scripts_keys(tmp_path,
                                                            monkeypatch):
    solver_args = r44.solver_args
    monkeypatch.setattr(r44, "solver_args", lambda: {
        **solver_args(), "flow_iterations": 30, "local_sample_num": 200,
        "posterior_sample_num": 100})
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert r44.main(["--seeds", "4", "7", "--limit-steps", "2",
                     "--device", "cpu"]) == 0
    agg = json.loads((tmp_path / "random4x4_sweep.json").read_text())
    assert set(agg) == {"seeds", "total_s_all", "median_seed_s",
                        "median_rmse", "per_seed"}
    j_keys = {"seed", "total_s", "n_steps", "trans_rmse", "landmark_rmse"}
    assert [r["seed"] for r in agg["per_seed"]] == [4, 7]
    for r in agg["per_seed"]:
        assert set(r) == j_keys | {"median_step_s", "step_rows", "backend"}
        assert r["n_steps"] == 2 and np.isfinite(r["trans_rmse"])
    assert dict_keys(JAX_SCRIPT, "main", "agg") == set(agg)


def test_sweep_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert r44.main(["--seeds", "0", "--limit-steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_random_4x4_child_readings_and_gates_on_cpu(monkeypatch):
    """``chip_smoke``'s random_4x4 child on the CPU at a tiny size (two
    files, 3 steps each): its readings survive JSON; ``random_4x4_report``
    fails on no launch of the specialised kernel, on a file's RMSE past
    1.25x the JAX package's worst, and passes otherwise."""
    r = json.loads(json.dumps(chip_smoke.random_4x4_readings(
        "cpu", (2, 0), 3, flow_iterations=10, local_sample_num=100,
        posterior_sample_num=50)))
    assert list(r["files"]) == ["2", "0"]
    for st in r["files"].values():
        assert st["record"]["n_steps"] == 3 and st["finite"]
        assert st["fused_vs_walk"] == 0.0 and np.isfinite(st["trans_rmse"])
    monkeypatch.setattr(chip_smoke, "JAX_RANDOM_4X4_WORST", {0: 3.3, 2: 3.2})
    with pytest.raises(SystemExit, match="never launched"):
        chip_smoke.random_4x4_report(r)
    for st in r["files"].values():
        st["launches"]["specialized"] = 7
        st["trans_rmse"] = 4.0
    chip_smoke.random_4x4_report(r)
    monkeypatch.setattr(chip_smoke, "JAX_RANDOM_4X4_WORST", {0: 3.3, 2: 3.1})
    with pytest.raises(SystemExit, match="random_4x4_seed2 gate"):
        chip_smoke.random_4x4_report(r)


# --------------------------------------------------------------------------
# the JAX package's CPU figures behind chip_smoke's constants
# --------------------------------------------------------------------------
def jax_file(seed_id: int, seed: int) -> tuple:
    """The JAX package's ``ParallelNFiSAM`` on one file at the sweep's
    configuration, solver seed ``seed``: (translation RMSE unrounded, the
    port's record of it)."""
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs

    truth, batches = r44.load_stream(seed_id, parse=j_parse, group=j_group)
    solver = JParallel(JNFiSAMArgs(**{**r44.solver_args(), "seed": seed}))
    steps, samples, by_name, total = r44.solve_stream(solver, batches,
                                                      "cpu", truth)
    rmse = chip_smoke.translation_errors(samples, by_name)[1]
    return rmse, r44.seed_record(seed_id, steps, samples, by_name, total,
                                 "cpu")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    argv = sys.argv[1:]
    seeds = [0, 1, 2]
    if "--seeds" in argv:
        k = argv.index("--seeds")
        seeds, argv = [int(a) for a in argv[k + 1:]], argv[:k]
    for seed_id in [int(a) for a in argv] or list(chip_smoke.RANDOM_4X4_FILES):
        worst = 0.0
        for seed in seeds:
            rmse, r = jax_file(seed_id, seed)
            print(f"JAX, random_4x4_seed{seed_id}, solver seed {seed}: "
                  f"translation RMSE {rmse!r} m, landmark RMSE "
                  f"{r['landmark_rmse']} m, {r['total_s']} s", flush=True)
            worst = max(worst, rmse)
        print(f"random_4x4_seed{seed_id}: worst translation RMSE over these "
              f"seeds {worst!r} m", flush=True)
