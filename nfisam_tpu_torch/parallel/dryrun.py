"""Dry runs of the multi-rank paths: bucket chunking across ranks and the
(clique, data) mesh, each held against single-rank solves.

Counterparts of the JAX package's ``scripts/dryrun_multihost.py`` and
``__graft_entry__.dryrun_multichip``, with ranks of a ``torch.distributed``
group (``parallel/multihost.py``) in the place of JAX processes and
devices::

    python -m nfisam_tpu_torch.parallel.dryrun multihost [--device cpu] [--fast]
    python -m nfisam_tpu_torch.parallel.dryrun multichip N [--device cpu]

``multihost``: 2 ranks solve a 4-robot range graph (the robots' chains
meet at one landmark) with ``ParallelNFiSAM``, each rank training its
chunk of every bucket; three single-rank solves (seeds 3, 4, 5) run beside
them.  Gates: both ranks trained non-empty, disjoint chunks; the ranks'
moments agree within 1e-5; replication: the worst per-variable
translation MMD against the same-seed single rank is < 0.05;
independence: the worst range-posterior MMD against seed 4 is < max(2x
the seed-5-vs-4 figure, ``RANGE_MMD_TOL``).

``multichip N``: N ranks solve (a) case1 at the journal configuration on
a (2, N/2) mesh and (b) 8 disjoint robot subproblems on a (4, N/4) mesh,
with ``data_parallel_mesh`` and ``sample_mesh`` set; one process solves
both without a mesh beside them.  Gates: (a) the joint translation MMD
against the world-1 solve is < 0.05 on a 500-row subsample, and the fused
pass's rows were split N/2 ways over the data axis; (b) a bucket of at
least max(clique axis, 4) cliques, and each robot's range posterior mean
and width within 0.5 m of the world-1 solve's; both: every rank's samples
equal rank 0's within 1e-5.

On a card every rank and solve launches the AR-inverse kernel, and the
launches are counted and gated per process; ranks sharing one card talk
over ``gloo`` through the host.  Each process's fused pass is held against
the per-clique walk on its final state.  Everything a process hands back
goes to a temporary directory; ``--result PATH`` writes the gate readings
as JSON.  The launcher exits non-zero if a process or a gate fails.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASE1_FG = os.path.join(ROOT, "data", "case1_factor_graph.fg")

# multihost (scripts/dryrun_multihost.py:36-52)
N_PROC = 2
N_ROBOTS = 4
T = 4
SEED = 3
SINGLE_SEED = 4      # the independent single-rank reference
VAR_SEED = 5         # its yardstick: seed 5 against seed 4
MMD_TOL = 0.05
# the independence gate's floor: the largest worst range-posterior MMD
# between two of the JAX package's own single-rank seeds at ``--fast`` on
# the CPU (seeds 3-12, 45 pairs: median 0.2836, largest 0.5518; ``python
# tests/test_torch_multihost.py independence-scatter``).  The JAX script's
# 0.12 sat below the median of that spread.
RANGE_MMD_TOL = 0.552
MOMENT_TOL = 1e-5
FULL = dict(flow_iterations=300, local_sample_num=600,
            posterior_sample_num=500)
FAST = dict(flow_iterations=120, local_sample_num=300,
            posterior_sample_num=300)

# multichip (__graft_entry__.py:34-258)
CASE1_ARGS = dict(posterior_sample_num=1000, local_sample_num=2000,
                  flow_iterations=2000, num_knots=9, hidden_dim=8,
                  learning_rate=0.025, elimination_method="pose_first",
                  seed=0)
CASE1_STEP = 3
CASE1_SUBSET = 500
CASE1_MMD_TOL = 0.05
BUCKET_ROBOTS, BUCKET_T = 8, 4
BUCKET_ARGS = dict(posterior_sample_num=512, local_sample_num=768,
                   flow_iterations=700, num_knots=6, hidden_dim=8,
                   learning_rate=0.03, elimination_method="pose_first",
                   seed=0)
RANGE_TOL_M = 0.5
FUSED_TOL = 1e-6
# seconds a dry run's processes may take together
TIMEOUT_S = 1500.0


# --------------------------------------------------------------------------
# graphs
# --------------------------------------------------------------------------
def shared_landmark_graph():
    """4 robot chains of T poses, each ranging the one landmark L1 from its
    last pose (``scripts/dryrun_multihost.py:55-77``)."""
    from ..core import R2Variable, SE2Variable, VariableType
    from ..factors import (SE2R2RangeGaussianLikelihoodFactor,
                           SE2RelativeGaussianLikelihoodFactor,
                           UnarySE2ApproximateGaussianPriorFactor)
    cov3 = np.diag([0.01, 0.01, 0.001])
    lm = R2Variable("L1", VariableType.Landmark)
    vars_, fs = [], []
    for r in range(N_ROBOTS):
        rid = chr(ord("A") + r)
        xs = [SE2Variable(f"{rid}{t}") for t in range(T)]
        vars_ += xs
        fs.append(UnarySE2ApproximateGaussianPriorFactor(
            xs[0], np.array([0.0, 10.0 * r, 0.0]), cov3))
        for a, b in zip(xs, xs[1:]):
            fs.append(SE2RelativeGaussianLikelihoodFactor(
                a, b, np.array([5.0, 0.0, 0.0]), cov3))
        fs.append(SE2R2RangeGaussianLikelihoodFactor(
            xs[-1], lm, 12.0 + 2.0 * r, 0.4))
    vars_.append(lm)
    return vars_, fs


def disjoint_robots_graph():
    """8 disjoint robot+landmark subproblems: each landmark ranged from the
    first and last pose on the chain's axis, with a tight prior
    (``__graft_entry__.py:166-193``)."""
    from ..core import R2Variable, SE2Variable, VariableType
    from ..factors import (SE2R2RangeGaussianLikelihoodFactor,
                           SE2RelativeGaussianLikelihoodFactor,
                           UnaryR2GaussianPriorFactor,
                           UnarySE2ApproximateGaussianPriorFactor)
    R, T_ = BUCKET_ROBOTS, BUCKET_T
    cov3 = np.diag([0.01, 0.01, 0.001])
    vars_, fs = [], []
    for r in range(R):
        rid = chr(ord("A") + r)
        xs = [SE2Variable(f"{rid}{t}") for t in range(T_)]
        lm = R2Variable(f"L{r + 1}", VariableType.Landmark)
        vars_ += xs
        start = np.array([0.0, 10.0 * r, 0.0])
        lm_true = np.array([25.0, 10.0 * r])
        fs.append(UnarySE2ApproximateGaussianPriorFactor(xs[0], start, cov3))
        for a, b in zip(xs, xs[1:]):
            fs.append(SE2RelativeGaussianLikelihoodFactor(
                a, b, np.array([5.0, 0.0, 0.0]), cov3))
        for t in (0, T_ - 1):
            pos = start[:2] + np.array([5.0 * t, 0.0])
            fs.append(SE2R2RangeGaussianLikelihoodFactor(
                xs[t], lm, float(np.linalg.norm(lm_true - pos)), 0.4))
        fs.append(UnaryR2GaussianPriorFactor(lm, lm_true,
                                             covariance=np.eye(2) * 0.25))
        vars_.append(lm)
    return vars_, fs


# --------------------------------------------------------------------------
# one process's solve
# --------------------------------------------------------------------------
def fused_vs_walk(solver) -> float:
    """Max |fused pass - per-clique walk| / max(1, max |sample|) on the
    solver's final state, both from the same keys."""
    keys = copy.deepcopy(solver._keys)
    fused = solver.sample_posterior()
    solver._keys = copy.deepcopy(keys)
    walk = solver.sample_posterior_per_clique()
    if set(fused) != set(walk):
        raise RuntimeError("the fused pass did not run on every variable")
    diff = max(float((fused[v] - walk[v]).abs().max()) for v in walk)
    return diff / max(1.0, max(float(walk[v].abs().max()) for v in walk))


def solve(batches, args, device) -> dict:
    """Solve ``batches`` incrementally by ``ParallelNFiSAM``; returns the
    final samples by name (host arrays), per-step fit and posterior
    seconds, kernel launches, the bucket log, the cliques this rank
    trained, the fused pass's rows in this rank, and the fused pass
    against the per-clique walk."""
    from ..flows import ar_inverse_kernel
    from .scheduler import ParallelNFiSAM

    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    solver = ParallelNFiSAM(args, device=device)
    ar_inverse_kernel.reset_launches()
    fit_s, post_s = [], []
    for ns, fs in batches:
        for nd in ns:
            solver.add_node(nd)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        sync()
        t0 = time.perf_counter()
        solver.fit_tree_density_models()
        sync()
        t1 = time.perf_counter()
        samples = solver._samples = solver.sample_posterior()
        sync()
        fit_s.append(t1 - t0)
        post_s.append(time.perf_counter() - t1)
    launches = ar_inverse_kernel.launches
    host = samples.materialize() if hasattr(samples, "materialize") else \
        {v: x.cpu().numpy() for v, x in samples.items()}
    return {"samples": {str(v.name): np.asarray(x).tolist()
                        for v, x in host.items()},
            "fit_s": fit_s, "posterior_s": post_s, "launches": launches,
            "buckets": [list(b) for b in solver.bucket_log],
            "trained": list(solver.host_trained_cliques),
            "shard_rows": int(getattr(samples, "shard_rows", 0)),
            "fused_vs_walk": fused_vs_walk(solver)}


def multihost_args(seed: int, fast: bool):
    from ..solver import NFiSAMArgs
    return NFiSAMArgs(num_knots=6, learning_rate=0.03, hidden_dim=8,
                      elimination_method="pose_first", seed=seed,
                      **(FAST if fast else FULL))


def multihost_batches():
    from ..io import group_nodes_factors_incrementally
    vars_, fs = shared_landmark_graph()
    return group_nodes_factors_incrementally(vars_, fs, incremental_step=T)


def case1_batches():
    from ..io import graph_file_parser, group_nodes_factors_incrementally
    nodes, _, factors = graph_file_parser(CASE1_FG)
    return group_nodes_factors_incrementally(nodes, factors,
                                             incremental_step=CASE1_STEP)


def bucket_batches():
    from ..io import group_nodes_factors_incrementally
    vars_, fs = disjoint_robots_graph()
    return group_nodes_factors_incrementally(
        vars_, fs, incremental_step=BUCKET_ROBOTS * BUCKET_T + 1)


def mesh_sizes(n: int) -> tuple:
    """(case1's clique axis, the robots' clique axis) on ``n`` ranks, as
    the JAX package picks them."""
    return (2 if n % 2 == 0 and n >= 2 else 1,
            4 if n % 4 == 0 else (2 if n % 2 == 0 else 1))


def multichip_solves(device, n_ranks: int, with_mesh: bool) -> dict:
    from ..solver import NFiSAMArgs
    from .mesh import make_mesh
    c_case1, c_robots = mesh_sizes(n_ranks)
    out = {}
    for name, batches, kw, n_clique in (
            ("case1", case1_batches(), CASE1_ARGS, c_case1),
            ("robots", bucket_batches(), BUCKET_ARGS, c_robots)):
        mesh = make_mesh(n_clique=n_clique, n_data=n_ranks // n_clique) \
            if with_mesh else None
        args = NFiSAMArgs(**kw, data_parallel_mesh=mesh, sample_mesh=mesh)
        out[name] = solve(batches, args, device)
        out[name]["mesh"] = None if mesh is None else dict(mesh.shape)
    return out


def worker(opts) -> None:
    """One rank (``--rank``) or one single-rank solve (``--single``)."""
    from .multihost import destroy_process_group, init_process_group
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    # one thread a process: several share the host's cores
    torch.set_num_threads(1)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    backend = None
    if opts.rank is not None:
        backend = init_process_group(opts.rank, opts.world,
                                     f"file://{opts.rendezvous}", device)
    try:
        if opts.job == "multihost":
            payload = solve(multihost_batches(),
                            multihost_args(opts.seed, opts.fast), device)
        else:
            payload = multichip_solves(device, opts.world,
                                       opts.rank is not None)
    finally:
        if opts.rank is not None:
            destroy_process_group()
    payload["backend"] = backend
    payload["wall_s"] = time.perf_counter() - t0
    with open(opts.payload, "w") as fh:
        json.dump(payload, fh)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def run_processes(argvs, tmp: str,
                  module: str = "nfisam_tpu_torch.parallel.dryrun",
                  timeout_s: float = TIMEOUT_S) -> None:
    """Start one process for each entry of ``argvs`` (``module`` with it),
    all at once, each's output to ``proc{i}.log`` in ``tmp``; stop them all
    once one fails or ``timeout_s`` has passed, and then raise SystemExit
    with the tail of a failed one's output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    for i, argv in enumerate(argvs):
        log = open(os.path.join(tmp, f"proc{i}.log"), "w")
        procs.append((argv, log, subprocess.Popen(
            [sys.executable, "-m", module] + argv, env=env, stdout=log, stderr=subprocess.STDOUT)))
    # a rank that fails leaves the others waiting in a collective: stop
    # every process once one fails or the time is up
    deadline = time.monotonic() + timeout_s
    while any(p.poll() is None for _, _, p in procs):
        if time.monotonic() > deadline or \
                any(p.poll() not in (None, 0) for _, _, p in procs):
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    failed = []
    for argv, log, p in procs:
        p.wait()
        log.close()
        if p.returncode != 0:
            failed.append((argv, p.returncode, log.name))
    if failed:
        for argv, rc, name in failed:
            with open(name) as fh:
                tail = fh.read()[-3000:]
            print(f"process {' '.join(argv)} exited {rc}:\n{tail}",
                  flush=True)
        raise SystemExit(f"dryrun: {len(failed)} process(es) failed")


def _by_name(payload) -> dict:
    return {k: np.asarray(v) for k, v in payload["samples"].items()}


def worst_range_mmd(a: dict, b: dict, robots: int, t_end: int,
                    landmark=None) -> tuple:
    """(worst robot, worst MMD) of the range posterior |chain end - its
    landmark| between two solves' samples by name."""
    from ..eval import mmd
    worst = ("", 0.0)
    for r in range(robots):
        end = f"{chr(ord('A') + r)}{t_end}"
        lm = landmark or f"L{r + 1}"
        ra = np.linalg.norm(a[end][:, :2] - a[lm][:, :2], axis=1)
        rb = np.linalg.norm(b[end][:, :2] - b[lm][:, :2], axis=1)
        m = float(mmd(ra[:, None], rb[:, None]))
        if m > worst[1]:
            worst = (end, m)
    return worst


def ranks_agree(payloads, key=None) -> float:
    """Max |rank r's samples - rank 0's| over every rank and variable."""
    pick = (lambda p: p[key]) if key else (lambda p: p)
    ref = _by_name(pick(payloads[0]))
    return max(float(np.abs(_by_name(pick(p))[k] - ref[k]).max())
               for p in payloads[1:] for k in ref)


def check_launches(payloads, device: str, label: str) -> list:
    launches = [p["launches"] for p in payloads]
    if device == "cuda" and not all(n > 0 for n in launches):
        raise SystemExit(f"{label}: a process never launched the "
                         f"ar_inverse kernel: {launches}")
    return launches


def check_fused(payloads, label: str) -> float:
    worst = max(p["fused_vs_walk"] for p in payloads)
    if not worst <= FUSED_TOL:
        raise SystemExit(f"{label}: the fused pass disagrees with the "
                         f"per-clique walk ({worst:.3e})")
    return worst


def multihost(opts, tmp: str) -> dict:
    """2 ranks and the single-rank seeds; the four gates."""
    from ..eval import mmd, mmd_sq_signed
    common = ["--job", "multihost", "--device", opts.device] + \
        (["--fast"] if opts.fast else [])
    argvs = [common + ["--rank", str(r), "--world", str(N_PROC),
                       "--rendezvous", os.path.join(tmp, "rendezvous"),
                       "--seed", str(SEED), "--payload",
                       os.path.join(tmp, f"rank{r}.json")]
             for r in range(N_PROC)]
    argvs += [common + ["--single", "--seed", str(s), "--payload",
                        os.path.join(tmp, f"single{s}.json")]
              for s in (SEED, SINGLE_SEED, VAR_SEED)]
    run_processes(argvs, tmp)
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(N_PROC)]
    single = {s: json.load(open(os.path.join(tmp, f"single{s}.json")))
              for s in (SEED, SINGLE_SEED, VAR_SEED)}
    for label, p in [(f"rank {r}", ranks[r]) for r in range(N_PROC)] + \
            [(f"single seed {s}", single[s]) for s in single]:
        print(f"{label}: {p['wall_s']:.1f} s; fit_s {_fmt(p['fit_s'])} "
              f"posterior_s {_fmt(p['posterior_s'])}; ar_inverse launches "
              f"{p['launches']}", flush=True)

    # 1. both ranks trained non-empty, disjoint chunks
    trained = [set(p["trained"]) for p in ranks]
    for r, t in enumerate(trained):
        print(f"rank {r} trained {sorted(t)}", flush=True)
    if not all(trained) or not trained[0].isdisjoint(trained[1]):
        raise SystemExit(f"multihost: chunks empty or overlapping: "
                         f"{[sorted(t) for t in trained]}")
    if any(single[s]["trained"] for s in single):
        raise SystemExit("multihost: a single-rank solve chunked")
    # 2. the ranks agree (replicated state)
    moment_diff = 0.0
    a0, a1 = _by_name(ranks[0]), _by_name(ranks[1])
    for k in a0:
        moment_diff = max(moment_diff,
                          float(np.abs(a0[k].mean(0) - a1[k].mean(0)).max()),
                          float(np.abs(a0[k].std(0) - a1[k].std(0)).max()))
    print(f"ranks' moments differ by at most {moment_diff:.3e} (gate "
          f"{MOMENT_TOL})", flush=True)
    if not moment_diff <= MOMENT_TOL:
        raise SystemExit("multihost: the ranks' moments differ")
    # 3. replication: the same seed on one rank
    same = _by_name(single[SEED])
    worst, worst_sq = ("", 0.0), ("", -np.inf)
    for k in a0:
        m = float(mmd(a0[k][:, :2], same[k][:, :2]))
        msq = mmd_sq_signed(a0[k][:, :2], same[k][:, :2])
        if m > worst[1]:
            worst = (k, m)
        if msq > worst_sq[1]:
            worst_sq = (k, msq)
    print(f"replication gate: worst translation MMD vs the seed-{SEED} "
          f"single rank {worst[1]:.4f} ({worst[0]}), gate {MMD_TOL}; worst "
          f"signed MMD^2 {worst_sq[1]:.2e} ({worst_sq[0]})", flush=True)
    if not worst[1] < MMD_TOL:
        raise SystemExit("multihost: the 2-rank posterior diverges")
    # 4. independence: the mode-invariant range posterior across seeds
    ind = _by_name(single[SINGLE_SEED])
    worst_rng = worst_range_mmd(a0, ind, N_ROBOTS, T - 1, "L1")
    seed_var = worst_range_mmd(_by_name(single[VAR_SEED]), ind, N_ROBOTS,
                               T - 1, "L1")
    gate = max(2.0 * seed_var[1], RANGE_MMD_TOL)
    worst_raw = max(float(mmd(a0[f"{chr(ord('A') + r)}{T - 1}"][:, :2],
                              ind[f"{chr(ord('A') + r)}{T - 1}"][:, :2]))
                    for r in range(N_ROBOTS))
    print(f"independence gate: worst range-posterior MMD vs the "
          f"seed-{SINGLE_SEED} single rank {worst_rng[1]:.4f} "
          f"({worst_rng[0]}), gate {gate:.4f} (= max(2x seed {VAR_SEED} vs "
          f"{SINGLE_SEED} {seed_var[1]:.4f}, {RANGE_MMD_TOL})); raw "
          f"translation MMD {worst_raw:.4f}", flush=True)
    if not worst_rng[1] < gate:
        raise SystemExit("multihost: the range posterior diverges beyond "
                         "the seeds' spread")
    procs = ranks + [single[s] for s in single]
    launches = check_launches(procs, opts.device, "multihost")
    fused = check_fused(procs, "multihost")
    print(f"ar_inverse launches by rank {launches[:N_PROC]}, single seeds "
          f"{SEED}/{SINGLE_SEED}/{VAR_SEED} {launches[N_PROC:]}; fused vs "
          f"walk worst {fused:.3e}; backend {ranks[0]['backend']}",
          flush=True)
    return {"trained_per_rank": [sorted(t) for t in trained],
            "moment_diff": moment_diff,
            "replication_worst_translation_mmd": worst[1],
            "replication_worst_mmd_sq_signed": worst_sq[1],
            "replication_mmd_gate": MMD_TOL,
            "independent_worst_range_mmd": worst_rng[1],
            "independent_range_mmd_gate": gate,
            "single_seed_variance_range_mmd": seed_var[1],
            "independent_raw_translation_mmd_diag": worst_raw,
            "launches": launches, "fused_vs_walk": fused,
            "backend": ranks[0]["backend"]}


def _fmt(seconds) -> str:
    return "[" + ", ".join(f"{s:.3f}" for s in seconds) + "]"


def multichip(opts, tmp: str) -> dict:
    """N mesh ranks and one world-1 process; the gates of (a) and (b)."""
    from ..eval import mmd
    n = opts.n
    common = ["--job", "multichip", "--device", opts.device,
              "--world", str(n)]
    argvs = [common + ["--rank", str(r), "--rendezvous",
                       os.path.join(tmp, "rendezvous"), "--payload",
                       os.path.join(tmp, f"rank{r}.json")]
             for r in range(n)]
    argvs.append(common + ["--single", "--payload",
                           os.path.join(tmp, "single.json")])
    run_processes(argvs, tmp)
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(n)]
    single = json.load(open(os.path.join(tmp, "single.json")))
    result = {"ranks": n}
    for label, p in [(f"rank {r}", ranks[r]) for r in range(n)] + \
            [("world 1", single)]:
        print(f"{label}: {p['wall_s']:.1f} s", flush=True)
        for part in ("case1", "robots"):
            print(f"  {part}: fit_s {_fmt(p[part]['fit_s'])} posterior_s "
                  f"{_fmt(p[part]['posterior_s'])}; ar_inverse launches "
                  f"{p[part]['launches']}", flush=True)

    # (a) case1 on a (2, N/2) mesh
    a_mesh = ranks[0]["case1"]["mesh"]
    mesh_s, single_s = _by_name(ranks[0]["case1"]), _by_name(single["case1"])
    names = sorted(mesh_s)
    for k in names:
        if not np.all(np.isfinite(mesh_s[k])):
            raise SystemExit(f"multichip (a): {k} is not finite")
    sub = np.random.default_rng(0).choice(
        CASE1_ARGS["posterior_sample_num"], CASE1_SUBSET, replace=False)
    joint_m = np.hstack([mesh_s[k][:, :2] for k in names])[sub]
    joint_s = np.hstack([single_s[k][:, :2] for k in names])[sub]
    m = float(mmd(joint_m, joint_s))
    shard_rows = sorted({p["case1"]["shard_rows"] for p in ranks})
    want_rows = CASE1_ARGS["posterior_sample_num"] // a_mesh["data"]
    agree_a = ranks_agree(ranks, "case1")
    print(f"(a) case1 on a {a_mesh} mesh: joint translation MMD mesh vs "
          f"world 1 {m:.4f} (gate {CASE1_MMD_TOL}); fused pass rows a rank "
          f"{shard_rows} of {CASE1_ARGS['posterior_sample_num']} (want "
          f"{want_rows}, {a_mesh['data']} ways); ranks differ by "
          f"{agree_a:.3e}", flush=True)
    if not m < CASE1_MMD_TOL:
        raise SystemExit(f"multichip (a): mesh vs world-1 MMD {m:.4f}")
    if shard_rows != [want_rows] or a_mesh["data"] != n // mesh_sizes(n)[0]:
        raise SystemExit(f"multichip (a): the fused buffer was not split "
                         f"over the data axis: {shard_rows}")
    if not agree_a <= MOMENT_TOL:
        raise SystemExit("multichip (a): the ranks' samples differ")

    # (b) 8 robot subproblems on a (4, N/4) mesh
    b_mesh = ranks[0]["robots"]["mesh"]
    pops = sorted((b[2] for b in ranks[0]["robots"]["buckets"]),
                  reverse=True)
    need = max(b_mesh["clique"], 4)
    rm, rs = _by_name(ranks[0]["robots"]), _by_name(single["robots"])
    worst_mmd = worst_dmu = worst_dsd = 0.0
    for r in range(BUCKET_ROBOTS):
        end, lm = f"{chr(ord('A') + r)}{BUCKET_T - 1}", f"L{r + 1}"
        a = np.linalg.norm(rm[end][:, :2] - rm[lm][:, :2], axis=1)
        b = np.linalg.norm(rs[end][:, :2] - rs[lm][:, :2], axis=1)
        worst_mmd = max(worst_mmd, float(mmd(a[:, None], b[:, None])))
        worst_dmu = max(worst_dmu, abs(float(a.mean() - b.mean())))
        worst_dsd = max(worst_dsd, abs(float(a.std() - b.std())))
    agree_b = ranks_agree(ranks, "robots")
    print(f"(b) 8 robots on a {b_mesh} mesh: bucket populations {pops} "
          f"(need {need}); range posterior mesh vs world 1: worst dmu "
          f"{worst_dmu:.3f} m, dstd {worst_dsd:.3f} m (gate {RANGE_TOL_M}), "
          f"MMD {worst_mmd:.4f}; ranks differ by {agree_b:.3e}", flush=True)
    if not pops or pops[0] < need:
        raise SystemExit(f"multichip (b): bucket populations {pops} never "
                         f"reached {need}")
    if not (worst_dmu < RANGE_TOL_M and worst_dsd < RANGE_TOL_M):
        raise SystemExit("multichip (b): mesh vs world-1 range posterior "
                         "differs")
    if not agree_b <= MOMENT_TOL:
        raise SystemExit("multichip (b): the ranks' samples differ")

    launches = {}
    for part in ("case1", "robots"):
        procs = [p[part] for p in ranks] + [single[part]]
        launches[part] = check_launches(procs, opts.device,
                                        f"multichip {part}")
        result[f"{part}_fused_vs_walk"] = check_fused(procs,
                                                      f"multichip {part}")
        print(f"{part}: ar_inverse launches by rank {launches[part][:n]}, "
              f"world 1 {launches[part][n]}; fused vs walk worst "
              f"{result[f'{part}_fused_vs_walk']:.3e}", flush=True)
    result.update({"case1_mesh": a_mesh, "case1_mmd": m,
                   "case1_mmd_gate": CASE1_MMD_TOL,
                   "case1_shard_rows": shard_rows,
                   "robots_mesh": b_mesh, "robots_buckets": pops,
                   "robots_worst_dmu": worst_dmu,
                   "robots_worst_dstd": worst_dsd,
                   "robots_worst_mmd": worst_mmd,
                   "ranks_differ": max(agree_a, agree_b),
                   "launches": launches, "backend": ranks[0]["backend"]})
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.parallel.dryrun",
        description=__doc__.split("\n")[0])
    parser.add_argument("which", nargs="?", choices=["multihost",
                                                      "multichip"])
    parser.add_argument("n", nargs="?", type=int, default=4,
                        help="ranks of multichip")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--fast", action="store_true",
                        help="multihost at 120 iterations and 300 samples, "
                        "to rehearse on the CPU")
    parser.add_argument("--result", default=None,
                        help="write the gate readings here as JSON")
    # a process the launcher starts
    parser.add_argument("--job", choices=["multihost", "multichip"])
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--rendezvous", default=None)
    parser.add_argument("--single", action="store_true")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--payload", default=None)
    opts = parser.parse_args(argv)
    if opts.job:
        worker(opts)
        return 0
    if opts.which is None:
        parser.error("name multihost or multichip")
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if opts.device == "cuda":
        # once here, not in every process at its first launch
        from ..utils.cuda_build import build_all_kernels
        build_all_kernels()
    tmp = tempfile.mkdtemp(prefix="nfisam_dryrun_")
    try:
        result = multihost(opts, tmp) if opts.which == "multihost" else \
            multichip(opts, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["wall_s"] = time.perf_counter() - t0
    print(f"dryrun {opts.which} OK in {result['wall_s']:.1f} s", flush=True)
    if opts.result:
        with open(opts.result, "w") as fh:
            json.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
