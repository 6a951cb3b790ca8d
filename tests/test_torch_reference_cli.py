"""The port's ``reference`` command and batch runs against the JAX
package's on the CPU.

``python -m nfisam_tpu_torch reference --device cpu`` with each sampler
exits 0 and writes what the JAX CLI writes on the same graph: the samples
(``np.savetxt`` text, one row a sample, the joint's columns) and the
``_ordering`` file naming the variables in the same order.  Nested and SMC
run on case1 (22 dims; nested at 80 live points to stay quick on a CPU);
NUTS runs on the two-pose Gaussian graph of ``tests/test_samplers.py``
written as a ``.fg`` (the command has no warmup flag, and case1's 500
warmup transitions take minutes eagerly on a CPU).  Without ``--device``
and without a card, ``reference`` exits 1.

``nested_run_batch``, ``nuts_run_batch`` and ``smc_run_batch`` write the
JAX package's run directories (``dyn1``, ``nuts1``, ``smc1``) and file
names, the per-step ``.png`` plots included; their summaries hold the JAX
package's keys, and ``plot_args`` reach the plots.

Run as a script, this file prints the JAX CLI's figures behind the card's
gates for ``reference --sampler nested`` on case1, seeds 1-3: the MMD of
the translation columns against ``data/case1_ref/ns_step5.sample``
(``chip_smoke.ns_step5_mmd``)."""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import nfisam_tpu.core as jcore  # noqa: E402
import nfisam_tpu.factors as jfactors  # noqa: E402
from nfisam_tpu import cli as j_cli  # noqa: E402
from nfisam_tpu.io.fg_io import write_factor_graph_to_file  # noqa: E402
from nfisam_tpu.samplers import run_batch as j_run_batch  # noqa: E402
from nfisam_tpu_torch import cli  # noqa: E402
from nfisam_tpu_torch.samplers import run_batch  # noqa: E402
from chip_smoke import gaussian_graph  # noqa: E402

torch.set_num_threads(1)
JAX_COMMON = ["--platform", "cpu", "--compile-cache", ""]
CASE1 = chip_smoke.CASE1_FG


@pytest.fixture(scope="module")
def gaussian_fg(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graphs") / "gaussian.fg")
    vars_, fs, _ = gaussian_graph(jcore, jfactors)
    write_factor_graph_to_file(vars_, fs, {v: np.zeros(2) for v in vars_},
                               path)
    return path


def _reference(main, fg, sampler, samples, out, extra):
    argv = ["reference", "--fg", fg, "--sampler", sampler, "--samples",
            str(samples), "--seed", "1", "--out", out] + extra
    assert main(argv) == 0
    with open(out + "_ordering") as f:
        return np.loadtxt(out, ndmin=2), f.read()


@pytest.mark.parametrize("sampler,samples", [("nested", 80), ("smc", 500),
                                             ("nuts", 200)])
def test_reference_writes_what_the_jax_cli_writes(sampler, samples, tmp_path,
                                                  gaussian_fg):
    fg = gaussian_fg if sampler == "nuts" else CASE1
    ours, order = _reference(cli.main, fg, sampler, samples,
                             str(tmp_path / "ours.txt"), ["--device", "cpu"])
    theirs, j_order = _reference(j_cli.main, fg, sampler, samples,
                                 str(tmp_path / "theirs.txt"), JAX_COMMON)
    assert order == j_order
    assert ours.shape[1] == theirs.shape[1]
    assert np.isfinite(ours).all()
    if sampler == "nested":
        # equal-weight draws: as many as the run retired points
        assert ours.shape[0] > samples
    else:
        assert ours.shape[0] == theirs.shape[0] == samples
    # the same text format: one row a sample, the same number format
    with open(tmp_path / "ours.txt") as f, open(tmp_path / "theirs.txt") as g:
        a, b = f.readline().split(), g.readline().split()
    assert len(a) == len(b)
    assert all(len(x.split("e")) == len(y.split("e")) == 2
               for x, y in zip(a, b))


def test_reference_without_a_device_fails_on_a_cpu_only_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = tmp_path / "s.txt"
    assert cli.main(["reference", "--fg", CASE1, "--out", str(out)]) == 1
    assert not out.exists()


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("sampler", ["nested", "nuts", "smc"])
def test_batch_runs_write_the_jax_artifact_set(sampler, tmp_path,
                                               gaussian_fg):
    kw = {"nested": dict(live_points=100, selected_steps=[0, 1]),
          # the graph's step 0 holds X0's odometry to X1, which arrives
          # at step 1 (both packages' grouping)
          "nuts": dict(draws=100, nuts_config=dict(num_warmup=100),
                       selected_steps=[1]),
          "smc": dict(draws=300, selected_steps=[0, 3])}[sampler]
    fg = gaussian_fg if sampler == "nuts" else CASE1
    # each package writes its run directory beside its own copy of the
    # graph
    dirs = [tmp_path / "ours", tmp_path / "theirs"]
    for d in dirs:
        d.mkdir()
        shutil.copy(fg, d / "graph.fg")
    fn = getattr(run_batch, f"{sampler}_run_batch")
    j_fn = getattr(j_run_batch, f"{sampler}_run_batch")
    ours = fn(case_dir=str(dirs[0]), data_file="graph.fg", data_format="fg",
              verbose=False, device="cpu", **kw)
    theirs = j_fn(case_dir=str(dirs[1]), data_file="graph.fg",
                  data_format="fg", verbose=False, **kw)
    prefix = {"nested": "dyn", "nuts": "nuts", "smc": "smc"}[sampler]
    assert os.path.basename(ours) == os.path.basename(theirs) == \
        f"{prefix}1"
    names = _tree(ours)
    assert names == _tree(theirs)
    assert any(n.endswith(".png") for n in names)
    for n in names:
        a, b = os.path.join(ours, n), os.path.join(theirs, n)
        if n.endswith((".summary", ".json")):
            with open(a) as f, open(b) as g:
                assert sorted(json.load(f)) == sorted(json.load(g))
        elif n.endswith(".sample"):
            assert np.loadtxt(a).shape[1] == np.loadtxt(b).shape[1]
        elif n.endswith("_ordering") or n == "step_list":
            with open(a) as f, open(b) as g:
                assert f.read() == g.read()
    # ``plot_args`` reach the step plots
    again = fn(case_dir=str(dirs[0]), data_file="graph.fg",
               data_format="fg", verbose=False, device="cpu",
               plot_args={"equal_axis": True}, **kw)
    assert [n for n in _tree(again) if n.endswith(".png")] == \
        [n for n in names if n.endswith(".png")]


def test_chip_smoke_sampler_helpers_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s reference-phase helpers on the CPU at a small
    size: ``run_reference`` reads back the command's summary and files,
    ``reference_gate`` passes them at a loose bound, ``ns_step5_mmd`` of
    the committed posterior against itself is near 0, and
    ``ring_errors`` flags a collapsed arc."""
    r = chip_smoke.run_reference("smc", 0, "cpu", str(tmp_path / "s.txt"),
                                 samples=300)
    assert r["samples"].shape == (300, 22)
    assert r["summary"]["final_beta"] == 1.0 and r["host_reads"]["smc_stage"]
    _, _, dims = chip_smoke.case1_dims()
    assert chip_smoke.reference_gate("smc", r, dims, 10.0, logz=False) > 0
    ref = np.loadtxt(chip_smoke.NS_STEP5)
    with open(chip_smoke.NS_STEP5.replace(".sample", "_ordering")) as f:
        names = f.read().split()
    name2dim = dict(dims)
    assert chip_smoke.ns_step5_mmd(ref, [(n, name2dim[n])
                                         for n in names]) < 0.02
    arc = np.zeros((100, 4))
    arc[:, 2] = 5.0
    errs = chip_smoke.ring_errors(arc)
    assert errs["th std"][0] > errs["th std"][1]


if __name__ == "__main__":
    # the JAX CLI's own reference --sampler nested on case1, seeds 1-3
    import tempfile

    from nfisam_tpu.io import graph_file_parser as j_parse

    nodes, _, _ = j_parse(CASE1, "fg")
    dims = [(str(v.name), v.dim) for v in nodes]
    worst = 0.0
    for seed in chip_smoke.SEEDS:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "s.txt")
            assert j_cli.main(["reference", "--fg", CASE1, "--sampler",
                               "nested", "--samples", "1000", "--seed",
                               str(seed), "--out", out] + JAX_COMMON) == 0
            m = chip_smoke.ns_step5_mmd(np.loadtxt(out), dims)
        worst = max(worst, m)
        print(f"JAX CLI nested seed {seed}: MMD to ns_step5 {m!r}",
              flush=True)
    print(f"worst over seeds 1-3: {worst!r}")
