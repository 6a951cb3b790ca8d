"""The port's bucket chunking across ranks (``parallel/multihost.py``) on
the CPU, in gloo groups of spawned rank processes
(``torch_rank_cases.py``; they import no JAX).

``host_parallel_enabled`` takes the JAX package's modes and error text:
off outside a group, on inside one of two ranks (but with a mesh set).
``train_chunked`` at 2 ranks over B = 3, 4 and 5 cliques: each rank
trains a disjoint chunk, and the gathered stacks equal the unsharded
``fit_flows_batched`` within 1e-6.  Then the dry run
``python -m nfisam_tpu_torch.parallel.dryrun multihost --device cpu
--fast``: its four gates pass and it writes nothing into the repository.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nfisam_tpu.parallel.multihost import \
    host_parallel_enabled as j_enabled  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.parallel import host_parallel_enabled  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.train import fit_flows_batched  # noqa: E402
from torch_rank_cases import HOST_MODES, inputs, keys, run_ranks  # noqa: E402

TOL = 1e-6


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    return run_ranks("chunked", 2, tmp_path_factory.mktemp("chunked"))


@pytest.mark.parametrize("mode", HOST_MODES)
def test_host_parallel_enabled_outside_a_group(mode):
    """One process: chunking stays off in every mode, as in the JAX
    package's single process."""
    assert host_parallel_enabled(NFiSAMArgs(host_parallel=mode)) is False
    assert j_enabled(JNFiSAMArgs(host_parallel=mode)) is False


def test_host_parallel_enabled_rejects_an_unknown_mode():
    with pytest.raises(ValueError) as ours:
        host_parallel_enabled(NFiSAMArgs(host_parallel="sometimes"))
    with pytest.raises(ValueError) as theirs:
        j_enabled(JNFiSAMArgs(host_parallel="sometimes"))
    assert str(ours.value) == str(theirs.value)


def test_host_parallel_enabled_in_a_group_of_two(chunked):
    """In a group of 2 ranks: on for True/"auto", off for False (every
    spelling the JAX package takes); off with a mesh set, which makes the
    ranks one host's devices; the JAX package's error text."""
    want = [True, True, True, True, False, False, False, False]
    for rank in chunked:
        assert rank["modes"] == want
        assert rank["with_mesh"] is False
        assert rank["bad"] == "host_parallel='sometimes': use " \
            "True/False/'auto'"


@pytest.mark.parametrize("B", [3, 4, 5])
def test_train_chunked_matches_the_unsharded_fit(chunked, B):
    """Each rank's gathered stacks equal ``fit_flows_batched`` on the
    whole bucket within 1e-6; the ranks trained disjoint chunks of
    ceil(B / 2) that cover the bucket."""
    cfg, tc, stack = inputs("chunked")
    params, iter_loss, n_iters, mean, std = fit_flows_batched(
        keys(B), stack[:B], cfg, tc, np.zeros((B, 4), bool))
    idx = [rank[B][5] for rank in chunked]
    assert idx[0] == list(range(-(-B // 2)))
    assert sorted(idx[0] + idx[1]) == list(range(B))
    for rank in chunked:
        p, il, t, m, s = rank[B][:5]
        assert t == n_iters
        for mine, ref in zip(p, params):
            for k in ref:
                np.testing.assert_allclose(mine[k].numpy(), ref[k].numpy(),
                                           atol=TOL, rtol=0)
        for a, b in ((il, iter_loss), (m, mean), (s, std)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       rtol=0)


def test_multihost_dryrun_passes_its_gates_on_the_cpu(tmp_path):
    """The 2-rank dry run at ``--fast``: both ranks trained non-empty,
    disjoint chunks, their moments agree within 1e-5, and the replication
    (< 0.05) and independence gates pass; the repository gains no file
    (the JAX launcher's ``.mh_*.json`` and ``MULTIHOST.json`` are its
    own)."""
    before = set(os.listdir(REPO))
    result = tmp_path / "multihost.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "nfisam_tpu_torch.parallel.dryrun",
         "multihost", "--device", "cpu", "--fast", "--result", str(result)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dryrun multihost OK" in out.stdout
    r = json.loads(result.read_text())
    trained = [set(t) for t in r["trained_per_rank"]]
    assert all(trained) and trained[0].isdisjoint(trained[1])
    assert r["moment_diff"] <= 1e-5
    assert r["replication_worst_translation_mmd"] < r["replication_mmd_gate"]
    assert r["independent_worst_range_mmd"] < r["independent_range_mmd_gate"]
    assert r["fused_vs_walk"] <= 1e-6
    # the JAX package's own dry run (``tests/test_multihost.py``, maybe in
    # another worker) writes ``.mh_*.json`` there for a while
    assert not {n for n in set(os.listdir(REPO)) - before
                if not n.startswith(".mh_")}
    assert sorted(os.listdir(tmp_path)) == ["multihost.json"]


def test_chip_smoke_runs_a_dryrun_as_a_child(tmp_path, capsys):
    """``chip_smoke.py``'s side-by-side machinery on the CPU: phase 25's
    dry run (at ``--fast`` on the CPU) started as a child process, joined,
    its output printed under its label and its readings returned; the
    phases it would start beside the main process's; a child that fails
    fails the run."""
    import chip_smoke
    child = chip_smoke.start_child(
        "phase 25 multihost",
        chip_smoke.DRYRUN + ["multihost", "--device", "cpu", "--fast"],
        str(tmp_path))
    chip_smoke.report_children([child])
    out = capsys.readouterr().out
    assert "# [phase 25 multihost] replication gate" in out
    assert "phase 25 multihost: child exited 0; joined" in out
    assert [label for label, _ in chip_smoke.child_phases(True)] == \
        ["phase 25 multihost", "phase 26 multichip 4", "plaza1_ada0.2",
         "manhattan g16 pose_first"]
    assert [label for label, _ in chip_smoke.child_phases(False)] == \
        ["phase 25 multihost", "phase 26 multichip 4",
         "manhattan g16 pose_first"]
    bad = chip_smoke.start_child("phase 26 multichip 4",
                                 chip_smoke.DRYRUN + ["nosuch"],
                                 str(tmp_path))
    with pytest.raises(SystemExit, match="phase 26 multichip 4 failed"):
        chip_smoke.report_children([bad])
