"""The case1_da benchmark: the JAX package's ``scripts/case1_da_run.py`` in
the port.

The graph ``data/case1_da_factor_graph.fg`` (6 SE(2) poses, 2 landmarks,
4 ranges as two-way ambiguous data associations with 0.5/0.5 prior
weights; the ground-truth associations X1->L1, X2->L1, X3->L2, X4->L2) is
solved one pose a step at the journal configuration (K=9, hidden 8,
<= 2000 Adam iterations, 2000 training samples, lr 0.025, pose_first,
1000 posterior draws, seed 0) by ``ParallelNFiSAM`` through the run
harness (``solver/run.run_incrementally``), which writes each step's
hypothesis weights to ``step{i}.hypoweights``; those are read back.  The
final weights are then held against an oracle: dynamic nested sampling
over the whole graph (``GlobalNestedSampler``, 1000 live points, 3
batches) and each mixture's ``posterior_weights`` on its samples::

    python -m nfisam_tpu_torch.scripts.case1_da_run
    python -m nfisam_tpu_torch.scripts.case1_da_run --device cpu

The run takes the JAX script's arguments (none) plus ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``), ``--out`` (the result JSON, by default the JAX script's
``case1_da_results.json`` in ``tempfile.gettempdir()``); the run
directory ``run{N}`` is made under ``case1_da`` in that directory.  The JAX script passes no key to the sampler, which
then takes ``[0, 7]``; ``oracle_key(seed)`` is ``[seed, 7]``, that key at
seed 0, and the dynamic sampler splits it (``split_host``) into its base
pass's key and its batches'.  The result has the JAX script's keys and
the port's: the oracle's wall time, ``niter``, ``ncall``, ``logzerr``
and key, the unrounded weights, the launches of the AR-inverse kernel,
``step_rows`` (each step's wall, surgery, fit and posterior seconds,
cliques trained and their iterations, read back from the run directory)
and ``backend``; on a card the kernels are built before the solve
(``build_s``, and ``build_cache_warm``: every library already built).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..utils.cuda_build import build_before_run
from .manhattan_scale_run import REPO

DATA = os.path.join(REPO, "data", "case1_da_factor_graph.fg")
TRUE_ASSOC = {"X1": "L1", "X2": "L1", "X3": "L2", "X4": "L2"}
# the oracle's sampler arguments (the JAX script's :72-74)
ORACLE_LIVE = 1000
ORACLE_BATCHES = 3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.case1_da_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default case1_da_results.json in the "
                         "temporary directory)")
    return ap.parse_args(argv)


def solver_args(seed: int = 0) -> dict:
    """The run's ``NFiSAMArgs`` (the JAX script's :47-50)."""
    return dict(posterior_sample_num=1000, local_sample_num=2000,
                flow_iterations=2000, num_knots=9, learning_rate=0.025,
                hidden_dim=8, elimination_method="pose_first", seed=seed)


def load_graph(parse=None, group=None) -> tuple:
    """(nodes, truth, factors, batches of one pose a step); ``parse`` and
    ``group`` default to the port's."""
    if parse is None:
        from ..io import (graph_file_parser as parse,
                          group_nodes_factors_incrementally as group)
    nodes, truth, factors = parse(DATA, "fg")
    return nodes, truth, factors, group(nodes, factors, incremental_step=1)


def solve(case_dir: str, device, seed: int = 0, verbose: bool = True,
          **overrides) -> tuple:
    """The incremental solve through ``run_incrementally`` (the JAX
    script's :43-54; ``overrides`` replace fields of ``solver_args``).
    Returns (the run directory, the solver, the batches, its seconds, the
    AR-inverse kernel's launches)."""
    from ..flows import ar_inverse_kernel
    from ..parallel import ParallelNFiSAM
    from ..solver import NFiSAMArgs
    from ..solver.run import run_incrementally

    os.makedirs(case_dir, exist_ok=True)
    _, truth, _, batches = load_graph()
    solver = ParallelNFiSAM(NFiSAMArgs(**{**solver_args(seed), **overrides}),
                            device=device)
    launches = ar_inverse_kernel.launches
    t0 = time.perf_counter()
    run_dir = run_incrementally(case_dir, solver, batches, truth,
                                verbose=verbose)
    return (run_dir, solver, batches, time.perf_counter() - t0,
            ar_inverse_kernel.launches - launches)


def read_hypoweights(run_dir: str, n_steps: int) -> dict:
    """Each step's hypothesis weights read back from the run directory
    (:57-67): {step: {observer name: [weight of each candidate]}}; a step
    before the first mixture has no file and no entry."""
    per_step = {}
    for step in range(n_steps):
        path = f"{run_dir}/step{step}.hypoweights"
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                names, ws = line.strip().split(" : ")
                observer = names.split()[0]
                per_step.setdefault(step, {})[observer] = [
                    float(w) for w in ws.split(",")]
    return per_step


def step_rows(run_dir: str, n_steps: int) -> list:
    """Each step's split read back from the run directory (the port's):
    {"s" (``step_timing``), "surgery_s", "fit_s", "posterior_s" (the
    step's ``split_timing``: surgery, each fit, the posterior pass),
    "trained", "iters" (the cliques trained and their Adam iterations,
    from ``step_training_loss``)}."""
    with open(f"{run_dir}/step_timing") as fh:
        walls = [float(t) for t in fh.read().split()]
    rows = []
    for i in range(n_steps):
        with open(f"{run_dir}/step{i}_split_timing") as fh:
            split = [float(t) for t in fh.read().split()]
        with open(f"{run_dir}/step{i}_step_training_loss") as fh:
            losses = json.load(fh)
        rows.append({"s": walls[i], "surgery_s": split[0],
                     "fit_s": sum(split[1:-1]), "posterior_s": split[-1],
                     "trained": len(losses),
                     "iters": [len(v) for v in losses.values()]})
    return rows


def oracle_key(seed: int = 0) -> np.ndarray:
    """The oracle's key: ``[seed, 7]``, at seed 0 the sampler's default,
    the key the JAX script's call takes."""
    return np.array([seed, 7], dtype=np.uint32)


def mixture_weights(nodes, factors, samples: np.ndarray) -> dict:
    """Each mixture's ``posterior_weights`` on joint samples whose columns
    follow ``nodes`` (:75-85), unrounded: {observer name: [weights]}."""
    from ..factors.mixtures import BinaryFactorMixture
    var2col, cur = {}, 0
    for v in nodes:
        var2col[v] = np.arange(cur, cur + v.dim)
        cur += v.dim
    ns_map = {v: samples[:, var2col[v]] for v in nodes}
    return {str(f.observer_var.name): [float(w) for w in
                                       f.posterior_weights(ns_map)]
            for f in factors if isinstance(f, BinaryFactorMixture)}


def oracle_weights(nodes, factors, device, seed: int = 0,
                   live_points: int = ORACLE_LIVE) -> tuple:
    """The oracle (:71-85): dynamic nested sampling over the whole graph
    with ``oracle_key(seed)`` (``ORACLE_BATCHES`` batches), then each
    mixture's posterior weights on its samples.  Returns (weights by
    observer, unrounded; the sampler's summary; its seconds)."""
    from ..samplers import GlobalNestedSampler

    summ = {}
    t0 = time.perf_counter()
    ns = GlobalNestedSampler(nodes, factors, device=device)
    ns_samples = ns.sample(key=oracle_key(seed), live_points=live_points,
                           dynamic=True, n_batches=ORACLE_BATCHES,
                           res_summary=summ)
    seconds = time.perf_counter() - t0
    return mixture_weights(nodes, factors, ns_samples), summ, seconds


def result_record(total: float, run_dir: str, per_step: dict,
                  oracle: dict, summ: dict, oracle_s: float,
                  launches: int, backend: str, steps: list) -> dict:
    """The JAX script's result (:87-95), key for key, and the port's
    keys."""
    final = per_step[max(per_step)]
    return {"total_s": round(total, 1),
            "run_dir": run_dir,
            "final_weights": {k: [round(w, 3) for w in v]
                              for k, v in final.items()},
            "ns_oracle_weights": {k: [round(w, 3) for w in v]
                                  for k, v in oracle.items()},
            "ns_logz": round(summ["logz"], 3),
            "true_assoc": TRUE_ASSOC,
            "per_step": per_step,
            "final_weights_unrounded": final,
            "ns_oracle_weights_unrounded": oracle,
            "ns_logzerr": summ["logzerr"],
            "ns_niter": summ["niter"],
            "ns_ncall": summ["ncall"],
            "oracle_s": round(oracle_s, 1),
            "oracle_key": oracle_key().tolist(),
            "launches": launches,
            "step_rows": steps,
            "backend": backend}


def run(device, case_dir: str) -> dict:
    """The whole benchmark at seed 0: the solve, the read-back and the
    oracle.  Returns the result record."""
    nodes, _, factors, _ = load_graph()
    run_dir, _, batches, total, launches = solve(case_dir, device)
    per_step = read_hypoweights(run_dir, len(batches))
    oracle, summ, oracle_s = oracle_weights(nodes, factors, device,
                                            live_points=ORACLE_LIVE)
    return result_record(total, run_dir, per_step, oracle, summ, oracle_s,
                         launches, device.type,
                         step_rows(run_dir, len(batches)))


def main(argv=None) -> int:
    from ..utils.device import resolve_device
    args = parse_args(argv)
    case_dir = os.path.join(tempfile.gettempdir(), "case1_da")
    try:
        device = resolve_device(args.device)
        build = build_before_run(device)
        result = {**run(device, case_dir), **build}
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"case1_da_run: {e}", file=sys.stderr)
        return 1
    print(json.dumps({k: v for k, v in result.items() if k != "per_step"},
                     indent=1), flush=True)
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   "case1_da_results.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"# wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
