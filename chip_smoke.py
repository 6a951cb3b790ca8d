#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port (``nfisam_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(``--profile`` adds one solve under ``torch.profiler``).
It needs one CUDA card and the CUDA toolkit (``nvcc``), imports nothing
of JAX or of the JAX package, and exits non-zero if any phase fails:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel source (``nfisam_tpu_torch/csrc``); print
   each instantiation's registers, local memory, shared memory and block
   shape, and fail if one uses local memory (a stack frame or spills);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the solver's shapes and edge cases, then both timed with CUDA
   events at the main path's shapes, at d=32 and d=64, and with every
   column pinned: a call as the host sees it (the kernel line's ``ms``),
   and the kernel's device time alone;
4. case1 by the sequential ``NFiSAM`` (6 poses, 2 landmarks, 6 steps)
   at the journal configuration (2000 training samples per clique, K=9,
   hidden 8, lr 0.025, <= 2000 Adam iterations with the w=25/tol=0.04
   plateau stop, 1000 posterior draws, pose_first) for seeds 1-3, then
   the gates: median over seeds of the mean joint translation MMD against
   the committed posteriors in ``data/case1_ref`` <= 2x the reference
   run1's, and the kernel's z-space roundtrip residual on trained cliques
   <= max(4x the plain version's, 1e-3);
5. case1 by ``ParallelNFiSAM`` (the JAX package's bench.py solver:
   wavefront training, the fused posterior pass) for seeds 1-3, the same
   MMD gate; its seed-1 solve gives the kernel line's launch count;
6. plaza1's first 10 incremental steps (5 poses a step) by
   ``ParallelNFiSAM`` at the plaza configuration (2000 training samples,
   K=9, hidden 8, lr 0.01, w=50/tol=0.01, 1000 posterior draws, seed 0),
   per-step times, cliques trained and launches; gate: max posterior-mean
   translation error against the ``.fg``'s ground truth <= 15 m;
7. 8 disjoint robots of 4 poses, each ranging a landmark that has a
   tight prior, by ``ParallelNFiSAM`` and by ``NFiSAM`` (512 posterior
   draws, 768 training samples, <= 700 iterations, K=7, lr 0.03); gates:
   a bucket of 8 cliques trained in one batched loop, and the per-robot
   range posteriors' mean and std of the two solvers within 0.5 m;
8. on each of those solvers' final state, the fused pass against the
   per-clique walk from the same key stream: max |diff| <= 1e-6 of the
   samples' scale, and both passes' times;

Each solve's kernel launches are counted from 0 just before it and read
just after.  The output ends with one ``{"kernels": [...]}`` JSON line,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CASE1_FG = os.path.join(HERE, "data", "case1_factor_graph.fg")
REF_DIR = os.path.join(HERE, "data", "case1_ref")
SEEDS = (1, 2, 3)
MMD_STEPS = (0, 1, 2, 3, 4, 5)
MMD_SUBSET = 500
MMD_GATE_FACTOR = 2.0
KERNEL_TOL = 1e-5               # atol and rtol of the kernel check
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the journal-paper case1 configuration (the JAX package's bench.py)
BENCH_ARGS = dict(posterior_sample_num=1000, local_sample_num=2000,
                  flow_iterations=2000, num_knots=9, learning_rate=0.025,
                  hidden_dim=8, average_window=25, loss_delta_tol=0.04,
                  elimination_method="pose_first", mode_repair=False)
# plaza1 (778 poses, 4 landmarks, the three case1 factor types) at the
# configuration of the JAX package's plaza runs
# (scripts/plaza_family_run.py: 5 poses a step, default w=50/tol=0.01
# plateau stop, seed 0), cut to its first PLAZA_STEPS incremental steps
PLAZA1_FG = os.path.join(HERE, "data", "plaza1_factor_graph.fg")
PLAZA_ARGS = dict(posterior_sample_num=1000, local_sample_num=2000,
                  flow_iterations=2000, num_knots=9, learning_rate=0.01,
                  hidden_dim=8, elimination_method="pose_first", seed=0,
                  mode_repair=False)
PLAZA_STEPS = 10
# the absolute floor of the plaza runs' gate on the max posterior-mean
# translation error (scripts/plaza_family_run.py)
PLAZA_GATE_M = 15.0
# the robots graph: R disjoint robots of T poses (__graft_entry__.py), at
# that entry's solver settings with K=7 (the kernel has K in 7/9/12)
ROBOTS, ROBOT_STEPS = 8, 4
ROBOT_ARGS = dict(posterior_sample_num=512, local_sample_num=768,
                  flow_iterations=700, num_knots=7, hidden_dim=8,
                  learning_rate=0.03, elimination_method="pose_first",
                  seed=0, mode_repair=False)
# gates: the two solvers' per-robot range posteriors (mean and std, m),
# and the fused pass against the per-clique walk (relative to the scale)
ROBOT_GATE_M = 0.5
FUSED_TOL = 1e-6


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


# --------------------------------------------------------------------------
# the solves and their gates (device-agnostic, so the tests can drive them)
# --------------------------------------------------------------------------
def host_samples(samples) -> dict:
    """Posterior samples as host arrays by variable name (the fused pass's
    buffer in one copy)."""
    if hasattr(samples, "materialize"):
        samples = samples.materialize()
    return {str(v.name): x.cpu().numpy() if torch.is_tensor(x) else x
            for v, x in samples.items()}


def run_incremental(solver, batches, device):
    """Drive an incremental solve through the solver's entry points.
    Returns (per-step timings {"s", "surgery_s", "fit_s", "posterior_s",
    "iters", "trained", "launches"}, per-step host samples {name: (n,
    dim)}).  On a card every phase ends in a synchronize, so its time is
    the device's too; ``launches`` counts the AR-inverse kernel's."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    steps, per_step = [], []
    for ns, fs in batches:
        sync()
        launches = ar_inverse_kernel.launches
        t0 = time.perf_counter()
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        t1 = time.perf_counter()
        solver.fit_tree_density_models()
        sync()
        t2 = time.perf_counter()
        samples = solver._samples = solver.sample_posterior()
        sync()
        t3 = time.perf_counter()
        steps.append({"s": t3 - t0, "surgery_s": t1 - t0, "fit_s": t2 - t1,
                      "posterior_s": t3 - t2,
                      "iters": [int(t) for _, t in
                                solver._temp_training_loss.values()],
                      "trained": len(solver._temp_training_loss),
                      "launches": ar_inverse_kernel.launches - launches})
        per_step.append(host_samples(samples))
    return steps, per_step


def solve_case1(seed: int, device, parallel: bool = False, **overrides):
    """One incremental case1 solve, by ``NFiSAM`` or, with ``parallel``,
    by ``ParallelNFiSAM`` (the JAX package's bench.py solver).  Returns
    (total_s, per-step timings, per-step host samples, solver)."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs

    nodes, _, factors = graph_file_parser(CASE1_FG)
    batches = group_nodes_factors_incrementally(nodes, factors,
                                                incremental_step=1)
    args = NFiSAMArgs(**{**BENCH_ARGS, **overrides, "seed": seed})
    solver = (ParallelNFiSAM if parallel else NFiSAM)(args, device=device)
    steps, per_step = run_incremental(solver, batches, device)
    return float(sum(s["s"] for s in steps)), steps, per_step, solver


def solve_plaza(device, steps: int = PLAZA_STEPS, **overrides):
    """The first ``steps`` incremental steps of plaza1 (5 poses a step)
    by ``ParallelNFiSAM`` at the plaza configuration.  Returns (per-step
    timings, last step's host samples, ground truth by name, solver)."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs

    nodes, truth, factors = graph_file_parser(PLAZA1_FG)
    batches = group_nodes_factors_incrementally(
        nodes, factors, incremental_step=5)[:steps]
    solver = ParallelNFiSAM(NFiSAMArgs(**{**PLAZA_ARGS, **overrides}),
                            device=device)
    timings, per_step = run_incremental(solver, batches, device)
    return (timings, per_step[-1],
            {str(v.name): np.asarray(t) for v, t in truth.items()}, solver)


def robots_graph(core, factors, R: int = ROBOTS, T: int = ROBOT_STEPS):
    """R disjoint robot-and-landmark subproblems (the JAX package's
    multi-chip dry run, ``__graft_entry__.py``): robot r drives T poses
    5 m apart from (0, 10r), ranges its landmark at (25, 10r) from its
    first and last pose (sigma 0.4 m), and the landmark has a tight prior
    (covariance 0.25 I).  ``core`` and ``factors`` are the package's
    modules of those names.  Returns (variables, factors)."""
    cov3 = np.diag([0.01, 0.01, 0.001])
    vars_, fs = [], []
    for r in range(R):
        rid = chr(ord("A") + r)
        xs = [core.SE2Variable(f"{rid}{t}") for t in range(T)]
        lm = core.R2Variable(f"L{r + 1}", core.VariableType.Landmark)
        vars_ += xs
        start = np.array([0.0, 10.0 * r, 0.0])
        lm_true = np.array([25.0, 10.0 * r])
        fs.append(factors.UnarySE2ApproximateGaussianPriorFactor(
            xs[0], start, cov3))
        for a, b in zip(xs, xs[1:]):
            fs.append(factors.SE2RelativeGaussianLikelihoodFactor(
                a, b, np.array([5.0, 0.0, 0.0]), cov3))
        for t in (0, T - 1):
            pos = start[:2] + np.array([5.0 * t, 0.0])
            fs.append(factors.SE2R2RangeGaussianLikelihoodFactor(
                xs[t], lm, float(np.linalg.norm(lm_true - pos)), 0.4))
        fs.append(factors.UnaryR2GaussianPriorFactor(
            lm, lm_true, covariance=np.eye(2) * 0.25))
        vars_.append(lm)
    return vars_, fs


def solve_robots(device, parallel: bool, R: int = ROBOTS,
                 T: int = ROBOT_STEPS, **overrides):
    """The robots graph by ``ParallelNFiSAM`` or by ``NFiSAM``.  Returns
    (per-step timings, last step's host samples, solver)."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.io import group_nodes_factors_incrementally
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs

    vars_, fs = robots_graph(core, factors, R, T)
    batches = group_nodes_factors_incrementally(vars_, fs,
                                                incremental_step=R * T + 1)
    args = NFiSAMArgs(**{**ROBOT_ARGS, **overrides})
    solver = (ParallelNFiSAM if parallel else NFiSAM)(args, device=device)
    timings, per_step = run_incremental(solver, batches, device)
    return timings, per_step[-1], solver


def range_moments(samples, R: int = ROBOTS, T: int = ROBOT_STEPS):
    """Per robot, the mean and std (m) of the posterior range from its
    last pose to its landmark: (R, 2)."""
    out = []
    for r in range(R):
        d = np.linalg.norm(samples[f"{chr(ord('A') + r)}{T - 1}"][:, :2] -
                           samples[f"L{r + 1}"][:, :2], axis=1)
        out.append((d.mean(), d.std()))
    return np.array(out)


def fused_vs_per_clique(solver):
    """The fused pass and the per-clique walk on the solver's final state,
    each pair drawn from the same key stream (rewound between the two),
    in turns: fused, walk, then walk, fused.  Returns (max |fused - walk|
    / max(1, max |sample|) over both pairs, fused seconds, per-clique
    seconds; each time the mean of two and ending in a synchronize)."""
    from nfisam_tpu_torch.solver import LazySamples

    sync = torch.cuda.synchronize if solver.device.type == "cuda" \
        else (lambda: None)
    passes = {"fused": solver.sample_posterior,
              "walk": solver.sample_posterior_per_clique}
    seconds = {"fused": 0.0, "walk": 0.0}
    worst = 0.0
    for order in (("fused", "walk"), ("walk", "fused")):
        keys = copy.deepcopy(solver._keys)
        out = {}
        for which in order:
            solver._keys = copy.deepcopy(keys)
            sync()
            t0 = time.perf_counter()
            out[which] = passes[which]()
            sync()
            seconds[which] += (time.perf_counter() - t0) / 2
        fused, walk = out["fused"], out["walk"]
        if not isinstance(fused, LazySamples) or set(fused) != set(walk):
            raise SystemExit("the fused posterior pass did not run on "
                             "every variable")
        diff = max(float((fused[v] - walk[v]).abs().max()) for v in walk)
        scale = max(1.0, max(float(walk[v].abs().max()) for v in walk))
        worst = max(worst, diff / scale)
    return worst, seconds["fused"], seconds["walk"]


def translation_errors(samples, truth):
    """(max, RMSE) of the posterior-mean translation error (m) over the
    variables with a ground truth; values are (n, dim) samples by name."""
    errs = np.array([np.linalg.norm(np.asarray(x)[:, :2].mean(0) -
                                    np.asarray(truth[name])[:2])
                     for name, x in samples.items()
                     if name in truth])
    return float(errs.max()), float(np.sqrt(np.mean(errs ** 2)))


def _ref_block(mat, order, name2dim, names):
    pos, cur = {}, 0
    for n in order:
        pos[n] = cur
        cur += name2dim[n]
    return np.hstack([mat[:, pos[n]:pos[n] + 2] for n in names])


def accuracy_gate(per_step, name2dim):
    """Joint translation MMD of one solve and of the reference's run1
    against the committed posteriors (dynesty at steps 0-3, nested
    sampling at 4-5), 500-sample subsets from ``default_rng(0)``, averaged
    over steps.  Returns (ours, reference run1, per-step ours)."""
    from nfisam_tpu_torch.eval import mmd

    rng = np.random.default_rng(0)

    def pick(A):
        return A[rng.choice(len(A), min(MMD_SUBSET, len(A)), replace=False)]

    ours, refs = [], []
    for step in MMD_STEPS:
        src = "dyn" if step <= 3 else "ns"
        dyn = np.loadtxt(os.path.join(REF_DIR, f"{src}_step{step}.sample"))
        with open(os.path.join(REF_DIR, f"{src}_step{step}_ordering")) as f:
            dyn_order = f.read().split()
        run1 = np.loadtxt(os.path.join(REF_DIR, f"run1_step{step}"))
        with open(os.path.join(REF_DIR, f"run1_step{step}_ordering")) as f:
            run1_order = f.read().split()
        dyn_block = _ref_block(dyn, dyn_order, name2dim, dyn_order)
        run1_block = _ref_block(run1, run1_order, name2dim, dyn_order)
        our_block = np.hstack([per_step[step][n][:, :2] for n in dyn_order])
        ours.append(mmd(pick(our_block), pick(dyn_block)))
        refs.append(mmd(pick(run1_block), pick(dyn_block)))
    return float(np.mean(ours)), float(np.mean(refs)), ours


def median_gate(per_step_by_seed, name2dim):
    """(median-seed MMD, reference run1 MMD, per-seed results)."""
    results = [accuracy_gate(ps, name2dim) for ps in per_step_by_seed]
    med = int(np.argsort([r[0] for r in results])[len(results) // 2])
    return results[med][0], results[med][1], results


def roundtrip_residuals(solver, inverse_fn, max_cliques: int = 3):
    """z-space residual |forward(inverse(z)) - z| of ``inverse_fn`` and of
    the plain inverse on up to ``max_cliques`` trained single-flow clique
    models (first 2 columns pinned).  Returns (fn's, plain's, count)."""
    from nfisam_tpu_torch.flows import stack_forward, stack_inverse_masked_plain

    worst_fn = worst_plain = 0.0
    checked = 0
    for adapter in solver._clique_density_model.values():
        model = adapter.model
        cfg = model.cfg
        if cfg.num_flows != 1:
            continue        # the identity below holds per flow
        rng = np.random.default_rng(0)
        z = torch.as_tensor(rng.normal(size=(256, cfg.dim)).astype(
            np.float32), device=model.device)
        prefix = torch.zeros_like(z)
        invert = torch.as_tensor(np.arange(cfg.dim) >= 2, device=z.device)
        with torch.no_grad():
            x_fn = inverse_fn(model.flow_params, z, prefix, invert, cfg)
            x_pl = stack_inverse_masked_plain(model.flow_params, z, prefix,
                                              invert, cfg)
            z_fn, _ = stack_forward(model.flow_params, x_fn, cfg)
            z_pl, _ = stack_forward(model.flow_params, x_pl, cfg)
        keep = invert.cpu().numpy()
        worst_fn = max(worst_fn, float(
            (z_fn - z).abs().cpu().numpy()[:, keep].max()))
        worst_plain = max(worst_plain, float(
            (z_pl - z).abs().cpu().numpy()[:, keep].max()))
        checked += 1
        if checked >= max_cliques:
            break
    return worst_fn, worst_plain, checked


# --------------------------------------------------------------------------
# the kernel against its plain version
# --------------------------------------------------------------------------
def random_flow(rng, d, h, K, num_flows, device):
    """Deterministic flow parameters (biases included) from a numpy RNG."""
    p = 3 * K
    flows = []
    for _ in range(num_flows):
        flows.append({
            "W1": rng.uniform(-1, 1, (d, h, d)) /
            np.sqrt(np.maximum(np.arange(d), 1))[:, None, None],
            "b1": rng.uniform(-0.3, 0.3, (d, h)),
            "W2": rng.uniform(-1, 1, (d, h, h)) / np.sqrt(h),
            "b2": rng.uniform(-0.3, 0.3, (d, h)),
            "W3": rng.uniform(-1, 1, (d, p, h)) / np.sqrt(h),
            "b3": rng.uniform(-0.5, 0.5, (d, p))})
    from nfisam_tpu_torch.flows import flow_params_from_numpy
    return flow_params_from_numpy(flows, device)


# (name, n, dim, hidden, knots, flows, sep_dim, circular dims[, z scale])
KERNEL_CASES = [
    ("main n=1000 sep0", 1000, 16, 8, 9, 1, 0, ()),
    ("main n=1000 sep1", 1000, 16, 8, 9, 1, 1, ()),
    ("main n=1000 sep8", 1000, 16, 8, 9, 1, 8, ()),
    ("main n=2000 sep0", 2000, 16, 8, 9, 1, 0, ()),
    ("main n=2000 sep1", 2000, 16, 8, 9, 1, 1, ()),
    ("main n=2000 sep8", 2000, 16, 8, 9, 1, 8, ()),
    ("d32 h16", 1000, 32, 16, 9, 1, 4, ()),
    ("circular", 1000, 16, 8, 9, 1, 2, (2, 5, 9)),
    ("2-flow stack", 1000, 16, 8, 9, 2, 3, ()),
    ("odd n K7", 999, 16, 8, 7, 1, 5, ()),
    ("d64 h32 K12 odd n", 777, 64, 32, 12, 1, 6, (7,)),
    ("n=1", 1, 16, 8, 9, 1, 2, ()),
    ("n=17", 17, 16, 8, 9, 1, 2, ()),
    ("all pinned sep16", 1000, 16, 8, 9, 1, 16, ()),
    ("sep15", 1000, 16, 8, 9, 1, 15, ()),
    ("circular first inverted", 1000, 16, 8, 9, 1, 3, (3, 11)),
    ("z beyond the tail bound", 1000, 16, 8, 9, 1, 2, (), 6.0),
    ("d32 h16 K12", 1000, 32, 16, 12, 1, 4, ()),
    ("d64 h32 K7", 500, 64, 32, 7, 1, 3, ()),
    ("d64 h32 K9", 500, 64, 32, 9, 1, 0, (10,)),
]
# the shapes the timings are taken at: a case1 root clique's posterior
# draw (n=1000) and a separator-factor draw in simulation (n=2000), d=16,
# h=8, K=9, 1 flow, 2 observation columns pinned; the first is the
# kernel line's; then the d=32 and d=64 dim buckets at n=1000, and every
# column pinned (no dim step: the launch, the loads and the store alone)
TIMED_CASES = [("timed n=1000 sep2", 1000, 16, 8, 9, 1, 2, ()),
               ("timed n=2000 sep2", 2000, 16, 8, 9, 1, 2, ()),
               ("timed d32 n=1000 sep2", 1000, 32, 16, 9, 1, 2, ()),
               ("timed d64 n=1000 sep2", 1000, 64, 32, 9, 1, 2, ()),
               ("timed n=1000 all pinned", 1000, 16, 8, 9, 1, 16, ())]
# cycles of the sleep kernel that holds the stream while a call is queued
# (~1 ms), so that the events time the device's work alone
HOLD_CYCLES = 2_000_000


def make_case(case, device, seed):
    from nfisam_tpu_torch.flows import NSFConfig

    _, n, d, h, K, flows, sep, circ, *z_scale = case
    rng = np.random.default_rng(seed)
    circular = tuple(i in circ for i in range(d)) if circ else ()
    cfg = NSFConfig(dim=d, num_knots=K, hidden_dim=h, num_flows=flows,
                    circular=circular)
    params = random_flow(rng, d, h, K, flows, device)
    z = torch.as_tensor((rng.normal(size=(n, d)) *
                         (z_scale[0] if z_scale else 1.5)).astype(np.float32),
                        device=device)
    mask = np.arange(d) >= sep
    xp = rng.normal(size=(n, d)).astype(np.float32) * 0.8
    xp[:, mask] = 0.0
    return (cfg, params, z, torch.as_tensor(xp, device=device),
            torch.as_tensor(mask, device=device))


def ar_inverse_work(n: int, cfg, invert) -> tuple:
    """(bytes, FLOPs) the masked inverse of one flow must move and do at
    this shape: z, x_prefix and the weights read once, the output written
    once; for each inverted dim i and sample, the three layers (2 FLOPs a
    multiply-add, W1 over the i visible inputs), the tanh's, and the
    spline (two K-bin softmaxes, K+1 softplus derivatives, the knots, the
    bin search and select, the quadratic root), counted one FLOP an
    operation, transcendentals included."""
    d, h, K = cfg.dim, cfg.hidden_dim, cfg.num_knots
    p = 3 * K
    weights = d * (h * d + h + h * h + h + p * h + p)
    nbytes = 4 * (3 * n * d + weights) + d
    spline = 2 * (5 * K) + 4 * (K + 1) + 2 * 3 * (K - 1) + 2 * K + 8 * K + 25
    per_dim = [2 * h * i + h + 2 * h * h + 2 * h + 2 * p * h + p + spline
               for i in range(d) if invert[i]]
    return nbytes, float(n * sum(per_dim))


def time_cuda(fn, warmup: int = 5, repeats: int = 30,
              hold: bool = False) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` CUDA-event-timed
    calls after ``warmup`` untimed ones.  With ``hold`` a sleep kernel
    keeps the stream busy while the call is queued, so the events time the
    device's work alone; without, they also take in the host's time to
    issue the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_ar_inverse(device) -> dict:
    """The AR-inverse kernel against its plain version on every case, then
    both timed at ``TIMED_CASES``.  Launches here are not counted as the
    main path's: the caller resets the count before the solve."""
    from nfisam_tpu_torch.flows import (stack_inverse_masked_cuda,
                                        stack_inverse_masked_plain)

    worst = worst_main = 0.0
    for i, case in enumerate(KERNEL_CASES):
        cfg, params, z, xp, mask = make_case(case, device, seed=100 + i)
        with torch.no_grad():
            got = stack_inverse_masked_cuda(params, z, xp, mask, cfg)
            torch.cuda.synchronize()
            ref = stack_inverse_masked_plain(params, z, xp, mask, cfg)
        err = (got - ref).abs()
        bad = err > KERNEL_TOL + KERNEL_TOL * ref.abs()
        max_err = float(err.max())
        log(f"ar_inverse {case[0]}: max |kernel - plain| {max_err:.3e}, "
            f"finite {bool(torch.isfinite(got).all())}")
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"ar_inverse kernel disagrees with its plain "
                             f"version on {case[0]}: max err {max_err:.3e}")
        worst = max(worst, max_err)
        if case[0].startswith("main"):
            worst_main = max(worst_main, max_err)
    log(f"ar_inverse: max |kernel - plain| {worst_main:.3e} at the main "
        f"path's shapes, {worst:.3e} over all, within atol {KERNEL_TOL} + "
        f"rtol {KERNEL_TOL}")

    timed = []
    for case in TIMED_CASES:
        cfg, params, z, xp, mask = make_case(case, device, seed=7)
        with torch.no_grad():
            def call():
                return stack_inverse_masked_cuda(params, z, xp, mask, cfg)
            ms = time_cuda(call)
            device_ms = time_cuda(call, hold=True)
            plain_ms = time_cuda(lambda: stack_inverse_masked_plain(
                params, z, xp, mask, cfg), warmup=2, repeats=10)
        nbytes, flops = ar_inverse_work(z.shape[0], cfg, mask.cpu().numpy())
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        flops_ms = 1e3 * flops / F32_FLOP_PER_S
        log(f"ar_inverse {case[0]}: kernel {ms:.5f} ms a call, "
            f"{device_ms:.5f} ms on the device; plain {plain_ms:.3f} ms; "
            f"bound {max(bytes_ms, flops_ms):.6f} ms ({nbytes} B -> "
            f"{bytes_ms:.6f} ms, {flops:.3e} FLOP -> {flops_ms:.6f} ms)")
        timed.append((ms, plain_ms, bytes_ms, flops_ms))
    ms, plain_ms, bytes_ms, flops_ms = timed[0]
    return {"name": "ar_inverse_masked",
            "route": "cuda",
            "source": "nfisam_tpu_torch/csrc/ar_inverse.cu",
            "replaces": "nfisam_tpu/flows/ar_inverse_pallas.py:168",
            "launches": None,
            "max_abs_err": worst_main,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def build_report() -> None:
    """Each AR-inverse instantiation's block shape, registers, local
    memory and dynamic shared memory, as the runtime reads them from the
    built cubin (ptxas's figures: spills and a stack frame are local
    memory); fails if any instantiation uses local memory."""
    from nfisam_tpu_torch.flows.ar_inverse import (SUPPORTED_DIM_HIDDEN,
                                                   SUPPORTED_KNOTS,
                                                   ar_inverse_kernel)

    local = []
    for d, h in SUPPORTED_DIM_HIDDEN:
        for K in SUPPORTED_KNOTS:
            info = ar_inverse_kernel.info(d, h, K)
            log(f"ar_inverse d={d} h={h} K={K}: {info['threads']} threads "
                f"({info['samples']} samples) a block, {info['registers']} "
                f"registers, {info['local_bytes']} B local (stack and "
                f"spills), {info['smem_bytes']} B dynamic shared memory, "
                f"{info['slots']} ring slots")
            if info["local_bytes"]:
                local.append((d, h, K))
    if local:
        raise SystemExit(f"ar_inverse instantiations with local memory "
                         f"(stack or spills): {local}")


def profile_solve(device) -> None:
    """One more seed-1 ``ParallelNFiSAM`` solve under ``torch.profiler``:
    the device's busy share of the solve's wall time and the kernels that
    fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _, _, _ = solve_case1(SEEDS[0], device, parallel=True)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_s = sum(dev_us(e) for e in rows) / 1e6
    if busy_s == 0.0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile (seed {SEEDS[0]}, profiler on): wall {wall:.3f} s, "
        f"device busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), "
        f"{sum(e.count for e in rows)} kernel launches")
    for e in sorted(rows, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")


def check_finite(samples: dict, where: str) -> None:
    for name, x in samples.items():
        if not np.isfinite(x).all():
            raise SystemExit(f"non-finite posterior samples of {name} "
                             f"({where})")


def log_steps(steps) -> None:
    for i, st in enumerate(steps):
        log(f"  step {i}: {st['s']:.3f} s (surgery {st['surgery_s']:.4f}, "
            f"fit {st['fit_s']:.3f}, posterior {st['posterior_s']:.4f}); "
            f"cliques trained {st['trained']}, ar_inverse launches "
            f"{st['launches']}; Adam iterations {st['iters']}")


def case1_phase(device, parallel: bool, name2dim):
    """case1 for every seed by ``NFiSAM`` or ``ParallelNFiSAM``, each
    solve's kernel launches counted, then the median MMD gate.  Returns
    (launches per seed, the last seed's solver)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    label = "ParallelNFiSAM" if parallel else "NFiSAM"
    per_step_by_seed, launches, solver = [], [], None
    for seed in SEEDS:
        ar_inverse_kernel.launches = 0
        total, steps, per_step, solver = solve_case1(seed, device, parallel)
        launches.append(ar_inverse_kernel.launches)
        log(f"case1 {label} seed {seed}: total {total:.3f} s, posterior "
            f"{sum(st['posterior_s'] for st in steps)} s, ar_inverse "
            f"launches {launches[-1]}")
        log_steps(steps)
        if launches[-1] == 0:
            raise SystemExit(f"the case1 {label} solve never launched the "
                             f"ar_inverse kernel")
        for step, samples in enumerate(per_step):
            check_finite(samples, f"case1 {label} step {step} seed {seed}")
        per_step_by_seed.append(per_step)

    mmd_joint, ref_mmd, results = median_gate(per_step_by_seed, name2dim)
    for seed, (ours, _, per) in zip(SEEDS, results):
        log(f"case1 {label} seed {seed} joint MMD {ours:.4f}, per step "
            f"{[round(x, 4) for x in per]}")
    log(f"case1 {label} accuracy gate: median joint MMD {mmd_joint:.4f} vs "
        f"{MMD_GATE_FACTOR}x reference run1 {ref_mmd:.4f}")
    if not mmd_joint <= MMD_GATE_FACTOR * ref_mmd:
        raise SystemExit(f"case1 {label} accuracy gate failed")
    return launches, solver


def plaza_phase(device):
    """The plaza1 prefix, its kernel launches counted, then the
    translation-error gate.  Returns the solver."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.launches = 0
    steps, samples, truth, solver = solve_plaza(device)
    launches = ar_inverse_kernel.launches
    worst, rmse = translation_errors(samples, truth)
    log(f"plaza1 first {PLAZA_STEPS} steps, ParallelNFiSAM: total "
        f"{sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
        f"{launches}; bucket log {solver.bucket_log}")
    log_steps(steps)
    log(f"plaza1 gate: max posterior-mean translation error {worst:.3f} m "
        f"(<= {PLAZA_GATE_M}), RMSE {rmse:.3f} m over {len(samples)} "
        f"variables")
    check_finite(samples, "plaza1")
    if launches == 0:
        raise SystemExit("the plaza1 solve never launched the ar_inverse "
                         "kernel")
    if not worst <= PLAZA_GATE_M:
        raise SystemExit("plaza1 translation-error gate failed")
    return solver


def robots_phase(device):
    """The robots graph by ``ParallelNFiSAM`` and by ``NFiSAM``, kernel
    launches counted per solver; gates: the batched trainer ran a bucket
    of ``ROBOTS`` cliques, and the two solvers' per-robot range posteriors
    agree.  Returns (parallel solver, sequential solver)."""
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    moments, solvers = [], []
    for parallel in (True, False):
        label = "ParallelNFiSAM" if parallel else "NFiSAM"
        ar_inverse_kernel.launches = 0
        steps, samples, solver = solve_robots(device, parallel)
        launches = ar_inverse_kernel.launches
        log(f"robots R={ROBOTS} T={ROBOT_STEPS} {label}: total "
            f"{sum(st['s'] for st in steps):.3f} s, ar_inverse launches "
            f"{launches}")
        log_steps(steps)
        check_finite(samples, f"robots {label}")
        if launches == 0:
            raise SystemExit(f"the robots {label} solve never launched the "
                             f"ar_inverse kernel")
        moments.append(range_moments(samples))
        solvers.append(solver)
    buckets = solvers[0].bucket_log
    dmu, dsd = np.abs(moments[0] - moments[1]).max(axis=0)
    log(f"robots gate: bucket log {buckets}; range posterior mean "
        f"{np.round(moments[0][:, 0], 3).tolist()} vs "
        f"{np.round(moments[1][:, 0], 3).tolist()}, worst |dmean| {dmu:.3f} "
        f"m, worst |dstd| {dsd:.3f} m (< {ROBOT_GATE_M})")
    if max(b for _, _, b in buckets) < ROBOTS:
        raise SystemExit(f"no bucket reached {ROBOTS} cliques: the batched "
                         f"trainer did not run at full width")
    if not (dmu < ROBOT_GATE_M and dsd < ROBOT_GATE_M):
        raise SystemExit("robots gate failed: the two solvers' range "
                         "posteriors differ")
    return solvers


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one solve with torch.profiler")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.utils.cuda_build import build_all_kernels

    build_s, built = build_all_kernels()
    log(f"build: {len(built)} kernel source(s) in {build_s:.1f} s")
    build_report()

    entry = check_ar_inverse(device)

    nodes, _, _ = graph_file_parser(CASE1_FG)
    name2dim = {str(v.name): v.dim for v in nodes}
    _, seq_solver = case1_phase(device, False, name2dim)

    from nfisam_tpu_torch.flows import stack_inverse_masked_cuda
    res_k, res_p, checked = roundtrip_residuals(seq_solver,
                                                stack_inverse_masked_cuda)
    log(f"roundtrip residual on {checked} trained cliques: kernel "
        f"{res_k:.3e}, plain {res_p:.3e}")
    if checked == 0 or not res_k <= max(4.0 * res_p, 1e-3):
        raise SystemExit("roundtrip residual gate failed")

    launches, par_solver = case1_phase(device, True, name2dim)
    entry["launches"] = launches[0]
    plaza_solver = plaza_phase(device)
    robot_solvers = robots_phase(device)

    for label, solver in (("case1 NFiSAM", seq_solver),
                          ("case1 ParallelNFiSAM", par_solver),
                          ("plaza1 ParallelNFiSAM", plaza_solver),
                          ("robots ParallelNFiSAM", robot_solvers[0]),
                          ("robots NFiSAM", robot_solvers[1])):
        rel, fused_s, walk_s = fused_vs_per_clique(solver)
        log(f"{label}: fused pass vs per-clique walk on the final state, "
            f"max |diff| {rel:.3e} of the samples' scale; posterior_s "
            f"fused {fused_s} s, per-clique {walk_s} s (in turns)")
        if not rel <= FUSED_TOL:
            raise SystemExit(f"{label}: the fused posterior pass disagrees "
                             f"with the per-clique walk ({rel:.3e})")
    if opts.profile:
        profile_solve(device)

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
