"""Command-line front end of the port:

  python -m nfisam_tpu_torch solve     --fg graph.fg --out runs/ [knobs]
  python -m nfisam_tpu_torch simulate  --grid 4x4 --cell 20 --out graph.fg
  python -m nfisam_tpu_torch baseline  --fg graph.fg   (MAP + Laplace)
  python -m nfisam_tpu_torch reference --fg graph.fg --sampler nested|nuts|smc
  python -m nfisam_tpu_torch mmd       A.txt B.txt     (quality metric)

The JAX package's commands and flags (``nfisam_tpu/cli.py``), with
``--device`` in place of ``--platform`` and ``--compile-cache``: solve,
baseline and reference run on ``cuda`` unless ``--device`` names
another, and exit non-zero when there is no card.  Any flag may also come
from ``--config config.json`` (flags win).  ``solve --plot`` draws each
step to ``step{i}.png`` and needs matplotlib: without it, it exits with
code 2 before solving.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--config", type=str, default=None,
                   help="JSON file of default argument values")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")


def _merge_config(args, parser):
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = json.load(f)
        defaults = {a.dest for a in parser._actions}
        for k, v in cfg.items():
            k = k.replace("-", "_")
            if k in defaults and parser.get_default(k) == getattr(args, k):
                setattr(args, k, v)
    return args


def _device(args):
    from .utils.device import resolve_device
    return resolve_device(args.device)


def _build_solver_args(args):
    from .solver import NFiSAMArgs
    return NFiSAMArgs(
        elimination_method=args.elimination,
        posterior_sample_num=args.posterior_samples,
        local_sample_num=args.train_samples,
        flow_iterations=args.iters,
        num_knots=args.knots,
        learning_rate=args.lr,
        hidden_dim=args.hidden,
        flow_type=args.flow_type,
        training_set_frac=args.training_set_frac,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed)


def cmd_solve(argv):
    parser = argparse.ArgumentParser(prog="nfisam_tpu_torch solve")
    parser.add_argument("--fg", required=True)
    parser.add_argument("--format", default="fg",
                        choices=["fg", "g2o", "toro"])
    parser.add_argument("--out", default=".")
    parser.add_argument("--incremental-step", type=int, default=1)
    parser.add_argument("--knots", type=int, default=9)
    parser.add_argument("--iters", type=int, default=2000)
    parser.add_argument("--train-samples", type=int, default=2000)
    parser.add_argument("--posterior-samples", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.025)
    parser.add_argument("--hidden", type=int, default=8)
    parser.add_argument("--elimination", default="pose_first",
                        choices=["natural", "pose_first", "ccolamd"])
    parser.add_argument("--flow-type", default="NSF_AR",
                        choices=["NSF_AR", "NSF_AR_CS"])
    parser.add_argument("--training-set-frac", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parallel", action="store_true",
                        help="wavefront clique-parallel scheduler")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--prior-cov-scale", type=float, default=0.1)
    _add_common(parser)
    args = _merge_config(parser.parse_args(argv), parser)
    if args.plot:
        from .eval.viz import matplotlib_pyplot
        try:
            matplotlib_pyplot()
        except ImportError as e:
            print(f"nfisam_tpu_torch: solve --plot: {e}", file=sys.stderr)
            return 2
    device = _device(args)

    from .io import graph_file_parser, group_nodes_factors_incrementally
    from .solver import NFiSAM, run_incrementally
    nodes, truth, factors = graph_file_parser(
        args.fg, args.format, prior_cov_scale=args.prior_cov_scale)
    batches = group_nodes_factors_incrementally(
        nodes, factors, incremental_step=args.incremental_step)
    if args.parallel:
        from .parallel import ParallelNFiSAM as SolverCls
    else:
        SolverCls = NFiSAM
    solver = SolverCls(_build_solver_args(args), device=device)
    os.makedirs(args.out, exist_ok=True)
    run_dir = run_incrementally(args.out, solver, batches, truth,
                                plot_args={} if args.plot else None)
    print(f"run artifacts: {run_dir}")
    return 0


def cmd_simulate(argv):
    parser = argparse.ArgumentParser(prog="nfisam_tpu_torch simulate")
    parser.add_argument("--grid", default="4x4")
    parser.add_argument("--cell", type=float, default=20.0)
    parser.add_argument("--trajectory", default="lawnmower",
                        choices=["lawnmower", "edge", "random"])
    parser.add_argument("--waypoints", type=int, default=20,
                        help="random-walk waypoint count")
    parser.add_argument("--landmarks", type=int, default=3)
    parser.add_argument("--range-prob", type=float, default=0.5)
    parser.add_argument("--range-std", type=float, default=2.0)
    parser.add_argument("--odom-std", type=float, default=0.01)
    parser.add_argument("--ada-prob", type=float, default=0.0)
    parser.add_argument("--outlier-prob", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--out", required=True)
    _add_common(parser)
    args = _merge_config(parser.parse_args(argv), parser)

    from .io.fg_io import write_factor_graph_to_file
    from .sim import (GridBeacon, GridRobot, ManhattanGrid,
                      ManhattanSimulator, SimulationArgs)
    nx, ny = (int(t) for t in args.grid.split("x"))
    env = ManhattanGrid((nx + 2, ny + 2), args.cell,
                        robot_area=[(1, 1), (nx, ny)])
    rng = np.random.default_rng(args.seed)
    cand = np.argwhere(env.landmark_feasibility)
    for k in range(args.landmarks):
        i, j = cand[rng.integers(len(cand))]
        env.add_landmark(GridBeacon(f"L{k + 1}"), int(i), int(j))
    rbt = GridRobot("X", step_scale=args.cell, range_std=args.range_std,
                    odom_cov=np.diag([args.odom_std, args.odom_std,
                                      args.odom_std / 10]))
    env.add_robot(rbt, 1, 1)
    sim = ManhattanSimulator(env, SimulationArgs(
        range_sensing_prob=args.range_prob,
        ambiguous_data_association_prob=args.ada_prob,
        outlier_prob=args.outlier_prob,
        seed=args.seed, range_std=args.range_std))
    if args.trajectory == "random":
        rbt_vars, lmk_vars, factors, truth = sim.random_walk_slam(
            rbt, num_waypoints=args.waypoints)
    else:
        wps = (env.lawnmower_path() if args.trajectory == "lawnmower"
               else env.edge_path())[1:]
        rbt_vars, lmk_vars, factors, truth = sim.waypoint_slam(rbt, wps)
    write_factor_graph_to_file(rbt_vars + lmk_vars, factors, truth,
                               args.out)
    print(f"wrote {len(rbt_vars)} poses, {len(lmk_vars)} landmarks, "
          f"{len(factors)} factors -> {args.out}")
    return 0


def cmd_baseline(argv):
    parser = argparse.ArgumentParser(prog="nfisam_tpu_torch baseline")
    parser.add_argument("--fg", required=True)
    parser.add_argument("--format", default="fg")
    parser.add_argument("--samples", type=int, default=1000)
    parser.add_argument("--out", default=None)
    _add_common(parser)
    args = _merge_config(parser.parse_args(argv), parser)
    device = _device(args)

    from .io import graph_file_parser
    from .solver import GaussNewtonMAP
    nodes, truth, factors = graph_file_parser(args.fg, args.format)
    m = GaussNewtonMAP(nodes, factors, device=device)
    t0 = time.time()
    x, cov, nll, it = m.solve()
    print(f"MAP: {it} LM iterations, NLL {nll:.3f}, "
          f"{(time.time() - t0):.3f} s")
    for v in nodes:
        idx = np.asarray(m.joint.var_to_indices[v])
        print(f"  {v.name}: {np.round(x[idx], 3)}")
    if args.out:
        np.savetxt(args.out, m.sample(np.array([0, 0], dtype=np.uint32),
                                      args.samples))
        print(f"wrote {args.samples} Laplace samples -> {args.out}")
    return 0


def cmd_reference(argv):
    parser = argparse.ArgumentParser(prog="nfisam_tpu_torch reference")
    parser.add_argument("--fg", required=True)
    parser.add_argument("--format", default="fg")
    parser.add_argument("--sampler", default="nested",
                        choices=["nested", "nuts", "smc"])
    parser.add_argument("--samples", type=int, default=1000)
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=0)
    _add_common(parser)
    args = _merge_config(parser.parse_args(argv), parser)
    device = _device(args)

    from .io import graph_file_parser
    nodes, truth, factors = graph_file_parser(args.fg, args.format)
    key = np.array([0, args.seed], dtype=np.uint32)
    summary = {}
    t0 = time.time()
    if args.sampler == "nested":
        from .samplers import GlobalNestedSampler
        s = GlobalNestedSampler(nodes, factors, device=device).sample(
            key=key, live_points=args.samples, res_summary=summary)
    elif args.sampler == "nuts":
        from .samplers import GlobalMCMCSampler
        sampler = GlobalMCMCSampler(nodes, factors, device=device)
        s = sampler.sample(key=key, num_samples=args.samples)
        summary = sampler.diagnostics
    else:
        from .samplers import GlobalSMCSampler
        s = GlobalSMCSampler(nodes, factors, device=device).sample(
            key=key, num_samples=args.samples, summary=summary)
    print(f"{args.sampler}: {s.shape[0]} samples in "
          f"{time.time() - t0:.1f} s; {summary}")
    if args.out:
        np.savetxt(args.out, s)
        with open(args.out + "_ordering", "w") as f:
            f.write(" ".join(str(v.name) for v in nodes))
        print(f"wrote -> {args.out}")
    return 0


def cmd_mmd(argv):
    parser = argparse.ArgumentParser(prog="nfisam_tpu_torch mmd")
    parser.add_argument("samples", nargs=2)
    parser.add_argument("--subset", type=int, default=500)
    parser.add_argument("--sigma2", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    _add_common(parser)
    args = _merge_config(parser.parse_args(argv), parser)
    from .eval import mmd
    A = np.loadtxt(args.samples[0])
    B = np.loadtxt(args.samples[1])
    rng = np.random.default_rng(args.seed)
    n = min(args.subset, len(A), len(B))
    A = A[rng.choice(len(A), n, replace=False)]
    B = B[rng.choice(len(B), n, replace=False)]
    print(json.dumps({"mmd": mmd(A, B, args.sigma2), "n": n}))
    return 0


COMMANDS = {
    "solve": cmd_solve,
    "simulate": cmd_simulate,
    "baseline": cmd_baseline,
    "reference": cmd_reference,
    "mmd": cmd_mmd,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"Unknown command '{cmd}'. Commands: "
              f"{', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    try:
        return COMMANDS[cmd](argv[1:])
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(f"nfisam_tpu_torch {cmd}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
