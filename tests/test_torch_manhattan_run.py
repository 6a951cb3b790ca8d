"""The port's lawnmower_4x4 runner (``nfisam_tpu_torch.scripts.manhattan_run``)
against the JAX package's ``scripts/manhattan_run.py`` on the CPU.

The JAX script is read as source (``torch_script_ast``), never imported.
Its ``run_once`` read-out (:92-112), run on synthetic samples and times,
equals the port's ``readout`` key for key; its solver arguments and mesh
shape are the port's; the port's stream is the JAX package's.  A 2-step
CPU run at tiny sizes writes the JAX script's keys (cold and steady, or
one steady run for a seed); the mesh mode at ``NFISAM_MESH=2 --device
cpu`` starts 2 ranks whose posterior means agree, and rank 0 writes the
result; without a card and without ``--device cpu`` the runner exits 1.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_manhattan_run.py
[seed ...]`` runs the JAX script's own ``build_solver`` and ``run_once``
on the CPU for seeds 1-5 (or those given; one steady run each, as the
script runs for a seed) and prints each run's record and the worst
translation RMSE: the figure behind ``chip_smoke.JAX_MANHATTAN_RUN_WORST``.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu_torch.scripts import manhattan_run as mr  # noqa: E402
from torch_script_ast import (dict_keys, function_statements,  # noqa: E402
                              script_functions, script_path)

torch.set_num_threads(1)
JAX_SCRIPT = script_path("manhattan_run.py")
TINY = ["--rehearse"]


def test_stream_is_the_jax_packages():
    truth, batches = mr.load_stream()
    j_truth, j_batches = mr.load_stream(parse=j_parse, group=j_group)
    assert len(batches) == len(j_batches) == 16
    assert [([str(v.name) for v in ns], sorted(map(str, fs)))
            for ns, fs in batches] == \
        [([str(v.name) for v in ns], sorted(map(str, fs)))
         for ns, fs in j_batches]
    assert mr.DATA == os.path.join(REPO, "data",
                                   "lawnmower_4x4_factor_graph.fg")


class _Recorder:
    """Stands in for the JAX package's classes in the JAX script's
    ``build_solver``: records what it was given."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


@pytest.mark.parametrize("mesh_n", [0, 2, 3, 8])
def test_solver_args_and_mesh_shape_are_the_jax_scripts(mesh_n,
                                                        monkeypatch):
    made = {}

    def make_mesh(n_data, n_clique, devices):
        made.update(n_data=n_data, n_clique=n_clique)
        return "mesh"
    mesh_mod = type(sys)("nfisam_tpu.parallel.mesh")
    mesh_mod.make_mesh = make_mesh
    ns = {"SEED": 4, "MESH_N": mesh_n, "NFiSAMArgs": _Recorder,
          "ParallelNFiSAM": lambda args: args,
          "jax": type("J", (), {"devices": staticmethod(lambda: range(8))})}
    script_functions(JAX_SCRIPT, ["build_solver"], ns)
    import nfisam_tpu.parallel.mesh  # noqa: F401  (its package first)
    monkeypatch.setitem(sys.modules, "nfisam_tpu.parallel.mesh", mesh_mod)
    args = ns["build_solver"]()
    kw = dict(args.kwargs)
    if mesh_n:
        assert kw.pop("data_parallel_mesh") == kw.pop("sample_mesh") == \
            "mesh"
        assert mr.mesh_shape(mesh_n) == (made["n_clique"], made["n_data"])
    assert kw == mr.solver_args(4)


@pytest.mark.parametrize("rng_seed, mesh_n, poses_only",
                         [(0, 0, False), (1, 8, False), (2, 0, True)])
def test_readout_matches_the_jax_scripts_arithmetic(rng_seed, mesh_n,
                                                    poses_only):
    """Samples scattered about the truth (all variables, or the poses
    alone) and random step times: the port's ``readout`` equals the JAX
    script's record on every key; the JAX script's ``n_chips`` is its
    mesh's devices, the port's the cards (here as many)."""
    truth, batches = mr.load_stream()
    j_truth, j_batches = mr.load_stream(parse=j_parse, group=j_group)
    rng = np.random.default_rng(rng_seed)
    s = {}
    for v, t in truth.items():
        if poses_only and str(v.name).startswith("L"):
            continue
        t = np.asarray(t, np.float64)
        s[str(v.name)] = (t + rng.normal(0.0, 1.5, t.shape) +
                          rng.normal(0.0, 1.0, (300, len(t))))
    j_samples = {v: s[str(v.name)] for v in j_truth if str(v.name) in s}
    step_times = list(rng.uniform(0.5, 4.0, len(batches)))
    post_times = list(rng.uniform(0.2, 3.0, len(batches)))
    ns = {"np": np, "samples": j_samples, "truth": j_truth,
          "step_times": step_times, "post_times": post_times,
          "batches": j_batches, "MESH_N": mesh_n, "total": 37.123}
    exec(function_statements(JAX_SCRIPT, "run_once", "if hasattr(samples"),
         ns)
    theirs = ns["_return"]
    by_name = {str(v.name): np.asarray(t) for v, t in truth.items()}
    mine = mr.readout(s, by_name, step_times, post_times, len(batches),
                      mesh_n, max(1, mesh_n), 37.123)
    assert mine == theirs
    assert (theirs["landmark_rmse"] is None) == poses_only
    assert dict_keys(JAX_SCRIPT, "main", "res") == {"cold", "steady"}


def _read(tmp_path, name):
    return json.loads((tmp_path / name).read_text())


def test_two_cpu_steps_cold_and_steady_write_the_jax_scripts_keys(
        tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.delenv("NFISAM_MESH", raising=False)
    assert mr.main(["--device", "cpu"] + TINY) == 0
    res = _read(tmp_path, "manhattan_results.json")
    assert set(res) == {"cold", "steady"}
    port_keys = {"step_rows", "surgery_s", "fit_s", "posterior_s",
                 "launches", "cards", "backend"}
    for r in res.values():
        assert set(r) == {"total_s", "n_steps", "step_times",
                          "median_step_s", "trans_rmse", "landmark_rmse",
                          "posterior_samples_per_sec_per_chip",
                          "mesh_devices"} | port_keys
        assert r["n_steps"] == 2 and len(r["step_rows"]) == 2
        assert r["mesh_devices"] == 1 and r["cards"] == 1
        assert r["backend"] == "cpu" and np.isfinite(r["trans_rmse"])
        assert np.isfinite(r["landmark_rmse"])    # L1 arrives at step 0
        post = sum(st["fit"] + st["posterior"] for st in r["step_rows"])
        assert r["posterior_samples_per_sec_per_chip"] == \
            pytest.approx(2000.0 / post, rel=1e-2, abs=1)
    # the card's solves are deterministic; so are the CPU's
    assert res["cold"]["trans_rmse"] == res["steady"]["trans_rmse"]


def test_mesh_mode_two_ranks_on_cpu_agree_and_rank0_writes(tmp_path,
                                                           monkeypatch):
    """``NFISAM_MESH=2 --device cpu``: two ranks on a (2, 1) mesh solve
    the 2-step prefix for seed 3; rank 0 writes the steady record with
    both ranks' figures, and their posterior means agree."""
    monkeypatch.setenv("NFISAM_MESH", "2")
    out = tmp_path / "mesh.json"
    t0 = time.perf_counter()
    assert mr.main(["3", "--device", "cpu", "--out", str(out)] + TINY) == 0
    res = json.loads(out.read_text())
    assert set(res) == {"steady", "ranks", "ranks_max_abs_diff"}
    r = res["steady"]
    assert r["mesh_devices"] == 2 and r["cards"] == 1 and r["n_steps"] == 2
    assert [k["rank"] for k in res["ranks"]] == [0, 1]
    for k in res["ranks"]:
        assert set(k["steady"]) == {"total_s", "surgery_s", "fit_s",
                                    "posterior_s", "launches"}
    assert res["ranks_max_abs_diff"] <= mr.RANK_TOL
    assert time.perf_counter() - t0 < 120


def test_mesh_mode_fails_when_a_rank_fails(tmp_path, monkeypatch, capsys):
    """Ranks stopped at the mesh mode's time limit fail the run: exit 1,
    no result written."""
    monkeypatch.setenv("NFISAM_MESH", "2")
    monkeypatch.setattr(mr, "MESH_TIMEOUT_S", 0.5)
    out = tmp_path / "mesh.json"
    assert mr.main(["3", "--device", "cpu", "--out", str(out)] + TINY) == 1
    assert not out.exists()
    assert "process(es) failed" in capsys.readouterr().err


def test_phase31_child_readings_and_gates_on_cpu(monkeypatch):
    """``chip_smoke``'s phase-31 child on the CPU at a tiny size (the
    oracle at 60 live points, 2 lawnmower steps): its readings survive
    JSON; ``oracle_lawnmower_report`` fails on no launch of the
    specialised kernel, on a logz or a weight past its bound, on the RMSE
    past 1.25x the JAX script's worst, and passes otherwise."""
    r = json.loads(json.dumps(chip_smoke.oracle_lawnmower_readings(
        "cpu", 60, rehearse=True)))
    assert set(r["oracle"]["true_weights"]) == set(chip_smoke.DA_TRUE)
    assert r["steady"]["n_steps"] == 2 and r["finite"]
    assert r["fused_vs_walk"] == 0.0 and np.isfinite(r["trans_rmse"])
    assert np.isfinite(r["oracle"]["summary"]["logz"])
    r["oracle"]["summary"].update(logz=chip_smoke.JAX_DA_ORACLE_LOGZ + 9.0,
                                  logzerr=0.05)
    with pytest.raises(SystemExit, match="oracle's gate"):
        chip_smoke.oracle_lawnmower_report(r)
    r["oracle"]["summary"]["logz"] = chip_smoke.JAX_DA_ORACLE_LOGZ + 0.3
    r["oracle"]["true_weights"] = dict(chip_smoke.JAX_DA_ORACLE_WORST)
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_RUN_WORST",
                        r["trans_rmse"] / 1.25 + 1e-6)
    with pytest.raises(SystemExit, match="never launched"):
        chip_smoke.oracle_lawnmower_report(r)
    r["launches"]["specialized"] = 7
    chip_smoke.oracle_lawnmower_report(r)
    r["oracle"]["true_weights"]["X3"] -= 0.06
    with pytest.raises(SystemExit, match="oracle's gate"):
        chip_smoke.oracle_lawnmower_report(r)
    r["oracle"]["true_weights"]["X3"] += 0.06
    r["oracle"]["summary"]["logz"] += 0.1
    with pytest.raises(SystemExit, match="oracle's gate"):
        chip_smoke.oracle_lawnmower_report(r)
    r["oracle"]["summary"]["logz"] -= 0.1
    monkeypatch.setattr(chip_smoke, "JAX_MANHATTAN_RUN_WORST",
                        r["trans_rmse"] / 1.25 - 1e-6)
    with pytest.raises(SystemExit, match="manhattan_run gate"):
        chip_smoke.oracle_lawnmower_report(r)


def test_runner_without_a_card_exits_1(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for mesh in ("0", "2"):
        monkeypatch.setenv("NFISAM_MESH", mesh)
        assert mr.main(["--rehearse"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the JAX package's CPU figures behind chip_smoke's gate
# --------------------------------------------------------------------------
def jax_steady(seed: int) -> dict:
    """The JAX script's ``build_solver`` and ``run_once`` at ``seed`` on
    the CPU (its steady run for a seed)."""
    from nfisam_tpu.io import (graph_file_parser,
                               group_nodes_factors_incrementally)
    from nfisam_tpu.parallel.scheduler import ParallelNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs
    import jax

    ns = {"np": np, "time": time, "jax": jax, "SEED": seed, "MESH_N": 0,
          "DATA": mr.DATA, "graph_file_parser": graph_file_parser,
          "group_nodes_factors_incrementally":
          group_nodes_factors_incrementally,
          "ParallelNFiSAM": ParallelNFiSAM, "NFiSAMArgs": NFiSAMArgs}
    script_functions(JAX_SCRIPT, ["build_solver", "run_once"], ns)
    return ns["run_once"](f"seed{seed}")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    seeds = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5]
    worst = 0.0
    for seed in seeds:
        r = jax_steady(seed)
        print(f"JAX manhattan_run seed {seed}: "
              f"{ {k: v for k, v in r.items() if k != 'step_times'} }",
              flush=True)
        worst = max(worst, r["trans_rmse"])
    print(f"seeds {seeds}: worst translation RMSE {worst!r} m", flush=True)
