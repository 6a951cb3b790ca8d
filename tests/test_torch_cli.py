"""The port's run harness and command line against the JAX package's.

``run_incrementally`` on case1_da (ambiguous data association) at a tiny
configuration writes the JAX package's artifact set: the same file names
(``hypoweights.png`` included), the same elimination orderings, hypothesis-weight lines naming the same
factors, and a ``parameters`` JSON with the same keys.  ``python -m
nfisam_tpu_torch`` runs ``solve``, ``mmd`` prints the JAX CLI's JSON to
1e-6 on the same files, ``baseline`` prints the JAX CLI's MAP NLL to
1e-4, ``--plot`` without matplotlib exits 2 (``reference`` has its own tests in
``test_torch_reference_cli.py``), and ``solve`` without
``--device`` exits non-zero on a host without a card.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_cli.py``,
it runs the JAX CLI's ``solve`` of lawnmower_4x4 at
``chip_smoke.LAWNMOWER_ARGV`` (``scripts/manhattan_run.py``'s
configuration) on the CPU for seeds 0-4 and prints each run's
translation and landmark RMSE, read back from its artifacts: the
reference of ``chip_smoke.py``'s lawnmower gate."""
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from nfisam_tpu import cli as j_cli  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JArgs  # noqa: E402
from nfisam_tpu.solver import run_incrementally as j_run  # noqa: E402
from nfisam_tpu_torch import cli  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.parallel import ParallelNFiSAM  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAMArgs, run_incrementally  # noqa: E402

torch.set_num_threads(1)
DA_FG = os.path.join(REPO, "data", "case1_da_factor_graph.fg")
TINY = dict(posterior_sample_num=100, local_sample_num=200,
            flow_iterations=30, num_knots=9, learning_rate=0.025,
            hidden_dim=8, elimination_method="pose_first", seed=0)
JAX_COMMON = ["--platform", "cpu", "--compile-cache", ""]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case1_da through both packages' run harness (ParallelNFiSAM)."""
    jdir = str(tmp_path_factory.mktemp("jax_runs"))
    tdir = str(tmp_path_factory.mktemp("port_runs"))
    nodes, truth, fs = j_parse(DA_FG, "fg")
    j_dir = j_run(jdir, JParallel(JArgs(**TINY)),
                  j_group(nodes, fs, incremental_step=1), truth,
                  verbose=False)
    nodes, truth, fs = graph_file_parser(DA_FG)
    t_dir = run_incrementally(
        tdir, ParallelNFiSAM(NFiSAMArgs(**TINY), device="cpu"),
        group_nodes_factors_incrementally(nodes, fs, 1), truth,
        verbose=False)
    return j_dir, t_dir


def test_run_writes_the_jax_artifact_set(runs):
    j_dir, t_dir = runs
    assert os.path.basename(t_dir) == "run1"
    assert set(os.listdir(t_dir)) == set(os.listdir(j_dir))
    assert "hypoweights.png" in os.listdir(t_dir)
    with open(os.path.join(j_dir, "parameters")) as f:
        j_params = json.load(f)
    with open(os.path.join(t_dir, "parameters")) as f:
        t_params = json.load(f)
    assert set(t_params) == set(j_params)
    assert {k: t_params[k] for k in TINY} == {k: j_params[k] for k in TINY}


@pytest.mark.parametrize("step", range(6))
def test_step_artifacts_match_jax(runs, step):
    j_dir, t_dir = runs

    def read(d, name):
        with open(os.path.join(d, f"step{step}{name}")) as f:
            return f.read()

    assert read(t_dir, "_ordering") == read(j_dir, "_ordering")
    order = read(t_dir, "_ordering").split()
    X = np.loadtxt(os.path.join(t_dir, f"step{step}"))
    assert X.shape == (TINY["posterior_sample_num"],
                       sum(3 if n.startswith("X") else 2 for n in order))
    assert np.isfinite(X).all()
    losses = json.loads(read(t_dir, "_step_training_loss"))
    assert sorted(losses) == sorted(json.loads(
        read(j_dir, "_step_training_loss")))
    split = [float(t) for t in read(t_dir, "_split_timing").split()]
    assert len(split) >= 3 and all(t >= 0 for t in split)
    has_weights = os.path.exists(os.path.join(j_dir,
                                              f"step{step}.hypoweights"))
    assert os.path.exists(os.path.join(t_dir, f"step{step}.hypoweights")) \
        == has_weights == (step > 0)
    if not has_weights:
        return
    names = [line.split(" : ")[0]
             for line in read(t_dir, ".hypoweights").splitlines()]
    assert names == [line.split(" : ")[0]
                     for line in read(j_dir, ".hypoweights").splitlines()]
    for line in read(t_dir, ".hypoweights").splitlines():
        w = np.array([float(v) for v in line.split(" : ")[1].split(",")])
        assert np.all(w >= 0) and abs(w.sum() - 1.0) < 1e-6


def test_run_level_timers(runs):
    _, t_dir = runs
    for name in ("step_timing", "fitting_timer",
                 "posterior_sampling_timer"):
        with open(os.path.join(t_dir, name)) as f:
            assert len(f.read().split()) == 6
    with open(os.path.join(t_dir, "step_list")) as f:
        assert f.read().split() == [str(i) for i in range(6)]


def _port_cli(*argv, timeout=300):
    return subprocess.run([sys.executable, "-m", "nfisam_tpu_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_module_entry_solves_on_the_cpu(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"iters": 20, "train-samples": 150}))
    out = _port_cli("solve", "--device", "cpu", "--fg", chip_smoke.CASE1_FG,
                    "--out", str(tmp_path), "--posterior-samples", "50",
                    "--parallel", "--config", str(cfg))
    assert out.returncode == 0, out.stderr
    run1 = tmp_path / "run1"
    assert (run1 / "step5").exists() and (run1 / "step5_ordering").exists()
    params = json.loads((run1 / "parameters").read_text())
    # --config fills the flags left at their defaults
    assert params["flow_iterations"] == 20
    assert params["local_sample_num"] == 150


def test_mmd_prints_the_jax_cli_json(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    np.savetxt(a, rng.normal(size=(700, 4)))
    np.savetxt(b, rng.normal(size=(600, 4)) + 0.3)
    assert cli.main(["mmd", str(a), str(b), "--subset", "400"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j_cli.main(["mmd", str(a), str(b), "--subset", "400"] +
                      JAX_COMMON) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["n"] == theirs["n"] == 400
    assert abs(ours["mmd"] - theirs["mmd"]) <= 1e-6


def _nll(text):
    return float(re.search(r"NLL (-?[0-9.]+)", text).group(1))


def test_baseline_prints_the_jax_map_nll(tmp_path, capsys):
    out = tmp_path / "laplace.txt"
    assert cli.main(["baseline", "--device", "cpu", "--fg",
                     chip_smoke.CASE1_FG, "--out", str(out),
                     "--samples", "50"]) == 0
    ours = capsys.readouterr().out
    assert j_cli.main(["baseline", "--fg", chip_smoke.CASE1_FG] +
                      JAX_COMMON) == 0
    theirs = capsys.readouterr().out
    assert abs(_nll(ours) - _nll(theirs)) <= 1e-4 * abs(_nll(theirs))
    assert np.loadtxt(out).shape == (50, 22)


@pytest.mark.parametrize("argv", [["solve", "--fg", "x.fg", "--plot",
                                   "--device", "cpu"],
                                  ["solve", "--fg", "x.fg", "--plot"]])
def test_unported_commands_exit_2(argv, monkeypatch, capsys):
    """``solve --plot`` where matplotlib is missing (as on the card's
    machine) exits 2 before solving, naming matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert cli.main(argv) == 2
    assert "matplotlib" in capsys.readouterr().err


def test_solve_without_a_device_fails_on_a_cpu_only_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _port_cli("solve", "--fg", chip_smoke.CASE1_FG, "--out",
                    str(tmp_path), timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "run1").exists()


if __name__ == "__main__":
    # the JAX CLI's own lawnmower_4x4 runs, seeds 0-4 (CPU)
    rmses = []
    for seed in range(5):
        with tempfile.TemporaryDirectory() as d:
            argv = chip_smoke.lawnmower_argv(seed, d) + JAX_COMMON
            assert j_cli.main(argv) == 0
            r = chip_smoke.run_rmse(os.path.join(d, "run1"),
                                    chip_smoke.LAWNMOWER_FG)
        rmses.append(r)
        print(f"JAX CLI lawnmower_4x4 seed {seed}: trans RMSE "
              f"{r['trans']!r} m, landmark RMSE {r['landmark']!r} m",
              flush=True)
    print(f"worst trans RMSE over seeds 0-4: "
          f"{max(r['trans'] for r in rmses)!r} m")


def test_run_traces_profiled_steps_and_writes_loss_curves(tmp_path):
    """``profile_steps`` writes a ``torch.profiler`` trace of each named
    step, and ``training_loss_dir`` one loss curve a trained clique."""
    loss_dir = tmp_path / "losses"
    loss_dir.mkdir()
    nodes, truth, fs = graph_file_parser(chip_smoke.CASE1_FG)
    batches = group_nodes_factors_incrementally(nodes, fs, 1)[:2]
    run_dir = run_incrementally(
        str(tmp_path), ParallelNFiSAM(NFiSAMArgs(
            **TINY, training_loss_dir=str(loss_dir)), device="cpu"),
        batches, truth, verbose=False, profile_steps=[1])
    assert os.path.exists(os.path.join(run_dir, "trace_step1.json"))
    assert not os.path.exists(os.path.join(run_dir, "trace_step0.json"))
    curves = sorted(os.listdir(loss_dir))
    assert curves and all(c.endswith(".txt") for c in curves)
    assert np.isfinite(np.loadtxt(loss_dir / curves[0])).all()


def test_empirical_study_runs_each_configuration(tmp_path):
    from nfisam_tpu_torch.solver import NFiSAM_empirial_study
    with open(chip_smoke.CASE1_FG) as f:
        (tmp_path / "case1.fg").write_text(f.read())
    runs = NFiSAM_empirial_study(
        knots=[5, 9], iters=[10], training_samples=[100],
        learning_rates=[0.03], hidden_dims=[8], case_dir=str(tmp_path),
        data_file="case1.fg", data_format="fg", device="cpu",
        posterior_sample_num=50, seed=2)
    assert [os.path.basename(r) for r in runs] == ["run1", "run2"]
    knots = [json.loads((tmp_path / os.path.basename(r) /
                         "parameters").read_text())["num_knots"]
             for r in runs]
    assert knots == [5, 9]
    assert all(os.path.exists(os.path.join(r, "step5")) for r in runs)
