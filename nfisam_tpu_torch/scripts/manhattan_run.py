"""The lawnmower_4x4 north-star runner: the JAX package's
``scripts/manhattan_run.py`` in the port.

The reference's Manhattan-world example (``lawnmower_4x4/run_nfisam.py``:
K=9, hidden 8, <= 2000 Adam iterations, 2000 training samples, lr 0.02,
one pose a step, pose_first, 1000 posterior draws) on
``data/lawnmower_4x4_factor_graph.fg`` (16 SE(2) poses, 3 landmarks, 32
factors, 6 ambiguous ranges), solved by ``ParallelNFiSAM``: each step's
wall, the translation and landmark RMSE of the last step's posterior
means, and posterior samples a second a chip::

    python -m nfisam_tpu_torch.scripts.manhattan_run        # cold, then warm
    python -m nfisam_tpu_torch.scripts.manhattan_run 3      # one run, seed 3
    NFISAM_MESH=8 python -m nfisam_tpu_torch.scripts.manhattan_run

With no argument it runs twice at seed 0, "cold" then "steady"; with a
seed, once ("steady").  ``NFISAM_MESH=N`` (read when ``main`` runs) starts
N ranks of a ``torch.distributed`` group (``gloo`` where they share a
card, as ``parallel/dryrun.py`` starts its ranks); each builds a (2, N/2)
(clique, data) mesh (N odd: (1, N)) and sets it as ``data_parallel_mesh``
and ``sample_mesh``.  Rank 0 gathers every rank's figures (and fails the
run if their posterior means differ) and writes the result.  A rank that
fails stops the others and the run exits 1.

The run takes the JAX script's argument (the seed) plus ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``; the JAX script's mesh ran on virtual CPU devices, the port's ranks
run on the card), ``--out`` (the result JSON, by default the JAX script's
``manhattan_results.json`` or ``manhattan_seed{S}_results.json`` in
``tempfile.gettempdir()``), and ``--rehearse``: the first
``REHEARSAL_STEPS`` steps at ``REHEARSAL_SIZES`` (a few Adam iterations on
few training samples), to try the runner and its mesh mode at a small
size.  Every timer
ends in a synchronize on a card.  On a card the kernels are built before
the first run (``build_s``, and whether every library was already built:
``build_cache_warm``), so no run's wall holds the build.

Each run's record has the JAX script's keys.  Its
``posterior_samples_per_sec_per_chip`` keeps the JAX formula: 1000 draws
a step over the seconds after each step's graph surgery, which hold the
step's training as well as its posterior pass, over the chips; the port
counts the cards its ranks share (1 on one card) where the JAX script
counted its N virtual devices.  Beside them the port's keys:
``step_rows`` (each step's wall, surgery, fit and posterior seconds,
cliques trained and AR-inverse launches), their sums ``surgery_s``,
``fit_s``, ``posterior_s``, ``launches``, ``cards`` and ``backend``; in
mesh mode ``ranks`` (each rank's sums and launches) and
``ranks_max_abs_diff`` (the largest difference of a posterior mean from
rank 0's).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.cuda_build import build_before_run
from .manhattan_scale_run import REPO, run_incremental

DATA = os.path.join(REPO, "data", "lawnmower_4x4_factor_graph.fg")
# ranks' posterior means must agree this closely
RANK_TOL = 1e-5
# seconds the mesh mode's ranks may take together
MESH_TIMEOUT_S = 3000.0
# --rehearse: the stream's first steps, solved at these solver sizes
REHEARSAL_STEPS = 2
REHEARSAL_SIZES = {"flow_iterations": 20, "local_sample_num": 200}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.manhattan_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=0,
                    help="one steady run at this seed (default: cold and "
                         "warm at seed 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="result JSON (default manhattan_results.json or "
                         "manhattan_seed{S}_results.json in the temporary "
                         "directory)")
    ap.add_argument("--rehearse", action="store_true",
                    help=f"the first {REHEARSAL_STEPS} steps at "
                         f"{REHEARSAL_SIZES}")
    # a rank the mesh mode's launcher starts
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def solver_args(seed: int = 0, rehearse: bool = False) -> dict:
    """The runner's ``NFiSAMArgs`` (the JAX script's :52-54; with
    ``rehearse``, at ``REHEARSAL_SIZES``)."""
    args = dict(posterior_sample_num=1000, local_sample_num=2000,
                flow_iterations=2000, num_knots=9, learning_rate=0.02,
                hidden_dim=8, elimination_method="pose_first", seed=seed)
    return {**args, **REHEARSAL_SIZES} if rehearse else args


def mesh_shape(mesh_n: int) -> tuple:
    """(clique, data) axes of the mesh on ``mesh_n`` ranks (:57-58)."""
    n_clique = 2 if mesh_n % 2 == 0 else 1
    return n_clique, mesh_n // n_clique


def build_solver(args, device, mesh_n: int = 0):
    """The run's ``ParallelNFiSAM`` (:51-64), on a (clique, data) mesh of
    the process group's ``mesh_n`` ranks when ``mesh_n`` is set."""
    from ..parallel import ParallelNFiSAM
    from ..solver import NFiSAMArgs

    kwargs = solver_args(args.seed, args.rehearse)
    if mesh_n:
        from ..parallel.mesh import make_mesh
        n_clique, n_data = mesh_shape(mesh_n)
        mesh = make_mesh(n_data=n_data, n_clique=n_clique)
        kwargs.update(data_parallel_mesh=mesh, sample_mesh=mesh)
    return ParallelNFiSAM(NFiSAMArgs(**kwargs), device=device)


def load_stream(limit_steps: int = 0, parse=None, group=None) -> tuple:
    """(truth, batches of one pose a step, cut to ``limit_steps``);
    ``parse`` and ``group`` default to the port's."""
    if parse is None:
        from ..io import (graph_file_parser as parse,
                          group_nodes_factors_incrementally as group)
    nodes, truth, factors = parse(DATA, "fg")
    batches = group(nodes, factors, incremental_step=1)
    return truth, batches[:limit_steps] if limit_steps else batches


def readout(samples: dict, truth: dict, step_times, post_times,
            n_steps: int, mesh_devices: int, n_chips: int,
            total: float) -> dict:
    """The JAX script's record (:92-112) from the last step's host samples
    and the truth, both by name, and the per-step times."""
    errs, lmk_errs = [], []
    for v in samples:
        if v not in truth:
            continue
        mean = np.asarray(samples[v]).mean(0)
        e = float(np.linalg.norm(mean[:2] - np.asarray(truth[v])[:2]))
        errs.append(e)
        if v.startswith("L"):
            lmk_errs.append(e)
    return {"total_s": round(total, 2),
            "n_steps": n_steps,
            "step_times": [round(t, 3) for t in step_times],
            "median_step_s": round(float(np.median(step_times)), 3),
            "trans_rmse": round(float(np.sqrt(np.mean(
                np.array(errs) ** 2))), 3),
            "landmark_rmse": round(float(np.sqrt(np.mean(
                np.array(lmk_errs) ** 2))), 3) if lmk_errs else None,
            "posterior_samples_per_sec_per_chip": round(
                1000.0 * n_steps / (sum(post_times) * n_chips), 0),
            "mesh_devices": mesh_devices or 1}


def n_cards(device, world: int) -> int:
    """The cards ``world`` ranks on ``device`` run on: each its own where
    there are enough, else they share one; 1 on the CPU."""
    if torch.device(device).type != "cuda":
        return 1
    return world if torch.cuda.device_count() >= world else 1


def run_once(tag: str, args, device, mesh_n: int = 0) -> tuple:
    """One run (:67-112): the stream solved step by step
    (``run_incremental``'s split timers; a step's wall runs from adding
    its nodes, microseconds before the JAX script's timer starts), then
    the read-out.  Returns (the record, the last step's host samples by
    name, the solver)."""
    truth, batches = load_stream(REHEARSAL_STEPS if args.rehearse else 0)
    solver = build_solver(args, device, mesh_n)

    def progress(i, ns, fs, step):
        print(f"[{tag}] step {i}/{len(batches)}: {step['s']:.2f}s",
              flush=True)

    t_all = time.perf_counter()
    steps, per_step = run_incremental(solver, batches, device, progress,
                                      keep_all=False)
    total = time.perf_counter() - t_all
    samples = per_step[-1]
    record = readout(samples, {str(v.name): np.asarray(t)
                               for v, t in truth.items()},
                     [st["s"] for st in steps],
                     [st["fit_s"] + st["posterior_s"] for st in steps],
                     len(batches), mesh_n, n_cards(device, mesh_n or 1),
                     total)
    record.update(
        step_rows=[{"step": i, "wall": round(st["s"], 4),
                    "surgery": round(st["surgery_s"], 4),
                    "fit": round(st["fit_s"], 4),
                    "posterior": round(st["posterior_s"], 4),
                    "trained": st["trained"], "launches": st["launches"]}
                   for i, st in enumerate(steps)],
        surgery_s=round(sum(st["surgery_s"] for st in steps), 3),
        fit_s=round(sum(st["fit_s"] for st in steps), 3),
        posterior_s=round(sum(st["posterior_s"] for st in steps), 3),
        launches=sum(st["launches"] for st in steps),
        cards=n_cards(device, mesh_n or 1),
        backend=torch.device(device).type)
    return record, samples, solver


def run_all(args, device, mesh_n: int = 0) -> tuple:
    """The JAX script's ``main`` (:115-131): one "steady" run for a seed,
    else "cold" then "steady" at seed 0.  Returns (the result, the last
    run's host samples)."""
    if args.seed:
        record, samples, _ = run_once(f"seed{args.seed}", args, device,
                                      mesh_n)
        return {"steady": record}, samples
    cold, *_ = run_once("cold", args, device, mesh_n)
    warm, samples, _ = run_once("warm", args, device, mesh_n)
    return {"cold": cold, "steady": warm}, samples


def summary(res: dict) -> dict:
    """The result without its per-step lists, as the JAX script prints
    it."""
    return {k: {kk: vv for kk, vv in v.items()
                if kk not in ("step_times", "step_rows")}
            for k, v in res.items() if isinstance(v, dict)}


def out_path(args) -> str:
    name = ("manhattan_results.json" if args.seed == 0
            else f"manhattan_seed{args.seed}_results.json")
    return args.out or os.path.join(tempfile.gettempdir(), name)


def write(res: dict, args) -> None:
    print(json.dumps(summary(res), indent=1), flush=True)
    out = out_path(args)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"# wrote {out}", file=sys.stderr)


def rank_main(args) -> int:
    """One rank of the mesh mode: join the group, run, and (rank 0) gather
    every rank's figures, check that their posterior means agree, and
    write the result."""
    import torch.distributed as dist

    from ..parallel.multihost import (destroy_process_group,
                                      init_process_group)
    device = torch.device(args.device or "cuda")
    torch.set_num_threads(1)     # the ranks share the host's cores
    init_process_group(args.rank, args.world, f"file://{args.rendezvous}",
                       device)
    try:
        res, samples = run_all(args, device, args.world)
        means = {n: np.asarray(x).mean(0) for n, x in samples.items()}
        mine = {"rank": args.rank, "means": means,
                "runs": {k: {kk: r[kk] for kk in
                             ("total_s", "surgery_s", "fit_s",
                              "posterior_s", "launches")}
                         for k, r in res.items()}}
        gathered = [None] * args.world
        dist.all_gather_object(gathered, mine)
    finally:
        destroy_process_group()
    if args.rank != 0:
        return 0
    diff = max(float(np.abs(g["means"][n] - means[n]).max())
               for g in gathered for n in means)
    res["ranks"] = [{"rank": g["rank"], **g["runs"]} for g in gathered]
    res["ranks_max_abs_diff"] = diff
    write(res, args)
    if not diff <= RANK_TOL:
        print(f"manhattan_run: the ranks' posterior means differ by {diff}",
              file=sys.stderr)
        return 1
    return 0


def mesh_main(args, device, mesh_n: int) -> int:
    """The mesh mode's launcher: the kernels built once, then ``mesh_n``
    ranks of this module, all at once; rank 0's output printed and the
    build's figures added to its result."""
    from ..parallel.dryrun import run_processes

    build = build_before_run(device)
    if build:
        print(f"# kernels built in {build['build_s']} s (cache warm: "
              f"{build['build_cache_warm']})", flush=True)
    flags = [str(args.seed), "--device", device.type, "--out",
             os.path.abspath(out_path(args))]
    flags += ["--rehearse"] if args.rehearse else []
    tmp = tempfile.mkdtemp(prefix="nfisam_mesh_")
    try:
        rdv = os.path.join(tmp, "rendezvous")
        t0 = time.perf_counter()
        run_processes([flags + ["--rank", str(r), "--world", str(mesh_n),
                                "--rendezvous", rdv]
                       for r in range(mesh_n)], tmp,
                      module="nfisam_tpu_torch.scripts.manhattan_run",
                      timeout_s=MESH_TIMEOUT_S)
        with open(os.path.join(tmp, "proc0.log")) as fh:
            print(fh.read(), end="", flush=True)
        print(f"# {mesh_n} ranks in {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(out_path(args)) as fh:
        res = json.load(fh)
    res.update(build)
    with open(out_path(args), "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


def main(argv=None) -> int:
    from ..utils.device import resolve_device
    args = parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    mesh_n = int(os.environ.get("NFISAM_MESH", "0"))
    try:
        device = resolve_device(args.device)
        if mesh_n:
            try:
                return mesh_main(args, device, mesh_n)
            except SystemExit as e:      # a rank failed
                print(f"manhattan_run: {e}", file=sys.stderr)
                return 1
        build = build_before_run(device)
        res, _ = run_all(args, device)
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"manhattan_run: {e}", file=sys.stderr)
        return 1
    res.update(build)
    write(res, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
