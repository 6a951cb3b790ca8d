"""The harness without a card: what it imports, what it refuses, and the
keys of its result line (a run of the timed path at a tiny size on the
CPU, through ``run_cell``; the command itself needs a card)."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_NAMES = {"jax", "jaxlib", "flax", "nfisam_tpu"}
# the judge and the yardstick take nothing of the program
PLAIN = ("reference.py", "stream.py", "work.py", "trace.py")
TINY = dict(flow_iterations=20, local_sample_num=200,
            posterior_sample_num=100)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imports(path)) & JAX_NAMES
        assert not found, (path, found)


@pytest.mark.parametrize("name", PLAIN)
def test_reference_imports_nothing_of_the_port(name):
    found = set(_imports(os.path.join(BENCH, name)))
    assert "nfisam_tpu_torch" not in found
    assert found <= {"__future__", "bisect", "collections", "contextlib",
                     "dataclasses", "numpy", "os", "time", "torch",
                     "typing", "portbench"}, found


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("nfisam_tpu_torch.flows", "jax.numpy", "nfisam_tpu.core",
                 "jaxtyping", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = run.forbidden_modules()
    assert {"jax.numpy", "nfisam_tpu.core", "flax"} <= set(found)
    assert not {"nfisam_tpu_torch.flows", "jaxtyping"} & set(found)


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "manhattan_g16.online1", "--seed",
                   "2147483903", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA" in err


def test_refuses_an_unknown_workload(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


def test_refuses_without_the_port(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files has no port to run."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run\n"
            "try:\n    run.import_port()\n"
            "except run.Refused as e:\n    print('refused', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.stdout.startswith("refused"), done.stdout + done.stderr
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "manhattan_g16.online1", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    out = run.run_cell("manhattan_g16.online1", 2147483905, 0.5, trace,
                       device="cpu", overrides=TINY)
    line = json.loads(json.dumps(out))
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "check"
    limits = run.cell_spec("manhattan_g16.online1")[1]["limits"]
    assert set(line["check"]) == {"faults", "chi2_dof"} | set(limits)
    assert set(line["check"]) <= set(line["readings"])
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    assert line["attempted"] >= line["steps"] >= 1
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"surgery_s", "fit_s", "posterior_s",
                "adam_iters"} <= set(line["metrics"]) or line["steps"] == 1
    else:
        assert set(line["metrics"]) == {"step_s", "setup_s"}


def test_the_run_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; "
            "run.run_cell('manhattan_g16.online1', 3, 0.1, False, "
            "device='cpu', overrides=json.loads(sys.argv[2]), "
            "traffic_overrides={'warmup_steps': 2}); "
            "print(run.forbidden_modules())")
    done = subprocess.run([sys.executable, "-c", code, ROOT,
                           json.dumps(TINY)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.stdout.strip().splitlines()[-1] == "[]", done.stderr[-2000:]
