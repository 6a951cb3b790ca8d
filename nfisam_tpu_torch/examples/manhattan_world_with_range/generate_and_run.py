"""Generate a lawnmower Manhattan-world range-SLAM dataset and solve it
incrementally (the reference's ``lawnmower_4x4`` benchmark family): the
JAX repo's ``examples/manhattan_world_with_range/generate_and_run.py`` in
the port::

    python -m nfisam_tpu_torch.examples.manhattan_world_with_range.generate_and_run
    python -m nfisam_tpu_torch.examples.manhattan_world_with_range.generate_and_run --device cpu --out DIR

``generate`` lays a 4 x 4 grid of 20 m cells with 3 landmarks through the
port's simulator (``nfisam_tpu_torch.sim``) and drives a robot along its
lawnmower path; ``lawnmower_seed{seed}/factor_graph.fg`` under ``--out``
is written by the port's ``.fg`` writer, the JAX example's file byte for
byte.  The graph is then solved 5 poses a step by ``NFiSAM`` through
``run_incrementally`` (500 draws, 2000 training samples, <= 2000
iterations, K=9, lr 0.02, hidden 8, pose_first, the dataset's seed).
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

from .. import default_out, example_device, plot_args

FAMILY = "manhattan_world_with_range"
# the JAX example's NFiSAMArgs, less the seed (its --seed)
GENERATE_RUN_ARGS = dict(posterior_sample_num=500, local_sample_num=2000,
                         flow_iterations=2000, num_knots=9,
                         learning_rate=0.02, hidden_dim=8,
                         elimination_method="pose_first")


def generate(seed=1, grid=(4, 4), cell=20.0, n_landmarks=3,
             range_std=2.0, odom_std=0.01, ada_prob=0.0, outlier_prob=0.0):
    """The dataset: (robot variables, landmark variables, factors, truth
    by variable), as the JAX example's ``generate``."""
    from ...sim import (GridBeacon, GridRobot, ManhattanGrid,
                        ManhattanSimulator, SimulationArgs)

    env = ManhattanGrid((grid[0] + 2, grid[1] + 2), cell,
                        robot_area=[(1, 1), (grid[0], grid[1])])
    rng = np.random.default_rng(seed)
    cand = np.argwhere(env.landmark_feasibility)
    for k in range(n_landmarks):
        i, j = cand[rng.integers(len(cand))]
        env.add_landmark(GridBeacon(f"L{k + 1}"), int(i), int(j))
    rbt = GridRobot("X", step_scale=cell, range_std=range_std,
                    odom_cov=np.diag([odom_std, odom_std, odom_std / 10]))
    env.add_robot(rbt, 1, 1)
    sim = ManhattanSimulator(env, SimulationArgs(
        range_sensing_prob=0.5, seed=seed, range_std=range_std,
        ambiguous_data_association_prob=ada_prob,
        outlier_prob=outlier_prob))
    wps = env.lawnmower_path()[1:]
    return sim.waypoint_slam(rbt, wps)


def sha256(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def run(device, out_dir: str, seed: int = 1, ada_prob: float = 0.0,
        outlier_prob: float = 0.0, incremental_step: int = 5,
        steps: int = None, verbose: bool = True, solver_seed: int = None,
        **overrides) -> dict:
    """The example, cut to its first ``steps`` steps if given
    (``overrides`` of its ``NFiSAMArgs``; the solver's seed is the
    dataset's ``seed`` unless ``solver_seed`` is given): {"lines" (its
    last line), "fg", "fg_sha256", "run_dir", "trans_rmse" (the last
    step's posterior-mean translation RMSE against the truth, m), "steps"
    (each step's wall, split, cliques trained and iterations, read back
    from the run directory), "samples" (the last step's, by name),
    "solver"}."""
    from ...io import group_nodes_factors_incrementally
    from ...io.fg_io import write_factor_graph_to_file
    from ...scripts.case1_da_run import step_rows
    from ...scripts.manhattan_scale_run import host_samples, point_errors
    from ...solver import NFiSAM, NFiSAMArgs
    from ...solver.run import run_incrementally

    rbt_vars, lmk_vars, factors, truth = generate(
        seed=seed, ada_prob=ada_prob, outlier_prob=outlier_prob)
    case_dir = os.path.join(out_dir, f"lawnmower_seed{seed}")
    os.makedirs(case_dir, exist_ok=True)
    fg = os.path.join(case_dir, "factor_graph.fg")
    write_factor_graph_to_file(rbt_vars + lmk_vars, factors, truth, fg)

    batches = group_nodes_factors_incrementally(
        rbt_vars + lmk_vars, factors,
        incremental_step=incremental_step)[:steps]
    solver = NFiSAM(NFiSAMArgs(**{
        **GENERATE_RUN_ARGS, **overrides,
        "seed": seed if solver_seed is None else solver_seed}), device=device)
    run_dir = run_incrementally(case_dir, solver, batches, truth,
                                plot_args=plot_args(verbose),
                                verbose=verbose)
    samples = host_samples(solver._samples)
    rmse, _ = point_errors({n: x[:, :2].mean(0) for n, x in samples.items()},
                           {str(v.name): t for v, t in truth.items()})
    return {"lines": [f"artifacts: {run_dir}"], "fg": fg,
            "fg_sha256": sha256(fg), "run_dir": run_dir, "trans_rmse": rmse,
            "steps": step_rows(run_dir, len(batches)), "samples": samples,
            "solver": solver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples."
             "manhattan_world_with_range.generate_and_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ada-prob", type=float, default=0.0)
    ap.add_argument("--outlier-prob", type=float, default=0.0)
    ap.add_argument("--incremental-step", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=default_out(FAMILY),
                    help="the directory lawnmower_seed{seed} goes to")
    args = ap.parse_args(argv)
    device = example_device("generate_and_run", args.device)
    if device is None:
        return 1
    r = run(device, args.out, seed=args.seed, ada_prob=args.ada_prob,
            outlier_prob=args.outlier_prob,
            incremental_step=args.incremental_step)
    print("\n".join(r["lines"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
