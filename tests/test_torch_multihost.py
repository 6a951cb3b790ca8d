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


def test_chip_smoke_keeps_at_most_its_limit_of_children(tmp_path):
    """``chip_smoke.start_children``: five short children with a limit of
    two run at most two at once, at ``CHILD_NICENESS`` below this process,
    all start in order, and a stopped queue starts no more."""
    import chip_smoke
    stamp = str(tmp_path / "{}")
    prog = ("import json, os, sys, time; open({!r}.format(sys.argv[1]), "
            "'w').write(repr(time.time())); time.sleep(0.5); "
            "open({!r}.format(sys.argv[1]), 'a').write(' ' + "
            "repr(time.time()) + ' ' + str(os.nice(0))); "
            "json.dump({{}}, open(sys.argv[-1], 'w'))")
    phases = [(f"c{i}", [sys.executable, "-c", prog.format(stamp, stamp),
                         f"c{i}"]) for i in range(5)]
    children, starter = chip_smoke.start_children(phases, str(tmp_path), 2)
    starter.join()
    assert [c["label"] for c in children] == [f"c{i}" for i in range(5)]
    assert all(c["proc"].wait() == 0 for c in children)
    spans = [tuple(map(float, (tmp_path / f"c{i}").read_text().split()))
             for i in range(5)]
    for t0, _, _ in spans:
        assert sum(a <= t0 < b for a, b, _ in spans) <= 2
    # each child below this process's CPU priority
    assert all(n >= os.nice(0) + chip_smoke.CHILD_NICENESS
               or n == 19 for _, _, n in spans)
    children, starter = chip_smoke.start_children(phases, str(tmp_path), 1)
    starter.stop.set()
    starter.join()
    chip_smoke.stop_children(children)
    assert len(children) <= 1


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
    runners = ["manhattan g16 pose_first", "phase 28 plaza family",
               "phase 29 random_4x4", "phase 30 manhattan_plaza",
               "phase 31 oracle and lawnmower", "phase 32 examples"]
    assert [label for label, _ in chip_smoke.child_phases(True)] == \
        ["phase 25 multihost", "phase 26 multichip 4", "plaza1_ada0.2"] + \
        runners
    assert [label for label, _ in chip_smoke.child_phases(False)] == \
        ["phase 25 multihost", "phase 26 multichip 4"] + runners
    bad = chip_smoke.start_child("phase 26 multichip 4",
                                 chip_smoke.DRYRUN + ["nosuch"],
                                 str(tmp_path))
    with pytest.raises(SystemExit, match="phase 26 multichip 4 failed"):
        chip_smoke.report_children([bad])


# --------------------------------------------------------------------------
# the independence gate's yardstick: the range posterior across seeds
# --------------------------------------------------------------------------
def independent_solve(arm: str, seed: int) -> dict:
    """The dry run's single-rank solve at ``--fast`` for ``seed``, by the
    JAX script's own ``solve`` (``scripts/dryrun_multihost.py``, read as
    source) or by the port's: final samples by name."""
    from nfisam_tpu_torch.parallel import dryrun
    if arm == "port":
        import torch
        return dryrun._by_name(dryrun.solve(
            dryrun.multihost_batches(), dryrun.multihost_args(seed, True),
            torch.device("cpu")))
    from torch_script_ast import script_functions, script_path
    ns = script_functions(script_path("dryrun_multihost.py"),
                          ["build_graph", "solve"],
                          {"os": os, "N_ROBOTS": dryrun.N_ROBOTS,
                           "T": dryrun.T, **{k: dryrun.FAST[v] for k, v in (
                               ("ITERS", "flow_iterations"),
                               ("N_LOCAL", "local_sample_num"),
                               ("N_POST", "posterior_sample_num"))}})
    return ns["solve"]("single", seed)[0]


def independence_report(out_dir: str) -> None:
    """The worst range-posterior MMD (the independence gate's statistic)
    between every two seeds each package solved into ``out_dir``: each
    pair, then the median, the 90th percentile and the largest."""
    from itertools import combinations

    from nfisam_tpu_torch.parallel import dryrun
    runs = {}
    for name in sorted(os.listdir(out_dir)):
        arm, seed = name[:-4].split("_")
        with np.load(os.path.join(out_dir, name)) as z:
            runs.setdefault(arm, {})[int(seed)] = dict(z)
    for arm, by_seed in sorted(runs.items()):
        gaps = []
        for s, t in combinations(sorted(by_seed), 2):
            end, m = dryrun.worst_range_mmd(by_seed[s], by_seed[t],
                                            dryrun.N_ROBOTS, dryrun.T - 1,
                                            "L1")
            gaps.append(m)
            print(f"{arm} seeds {s} vs {t}: {m!r} ({end})", flush=True)
        print(f"{arm}, {len(by_seed)} seeds, {len(gaps)} pairs: median "
              f"{float(np.median(gaps))!r}, 90th percentile "
              f"{float(np.percentile(gaps, 90))!r}, largest "
              f"{max(gaps)!r}", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["independence-scatter"]:
    # python tests/test_torch_multihost.py independence-scatter DIR ARM
    # SEED: one solve into DIR/ARM_SEED.npz (ARM JAX or port; run seeds
    # side by side), then ... independence-report DIR
    os.environ.update(JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4"))
    out_dir, arm, seed = sys.argv[2], sys.argv[3], int(sys.argv[4])
    np.savez(os.path.join(out_dir, f"{arm}_{seed}.npz"),
             **independent_solve(arm, seed))
elif __name__ == "__main__" and sys.argv[1:2] == ["independence-report"]:
    independence_report(sys.argv[2])
