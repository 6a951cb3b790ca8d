"""Eight SE(2) poses on a circle with a loop closure, the classic Pose2SLAM
loop: the JAX repo's ``examples/toy_examples/eight_pose_circle.py`` in the
port::

    python -m nfisam_tpu_torch.examples.toy_examples.eight_pose_circle
    python -m nfisam_tpu_torch.examples.toy_examples.eight_pose_circle --device cpu

Moves of 4 m and turns of 2 pi / 8 from a prior on x1, and x8 -> x1 closes
the loop; one batch solve through ``update_physical_and_working_graphs``
and ``incremental_inference`` by ``NFiSAM`` at the JAX example's
configuration (natural ordering, K=9, 1000 training samples, <= 1000
iterations, lr 0.02, 500 draws, seed 0).  Each pose's mean and std are
printed.  ``run`` also holds the posterior against ``GaussNewtonMAP`` of
the same graph.  It writes no file.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import (example_device, map_distances, map_estimate, moment_line,
                solve_steps)

# the JAX example's NFiSAMArgs
EIGHT_POSE_ARGS = dict(posterior_sample_num=500, local_sample_num=1000,
                       flow_iterations=1000, num_knots=9, learning_rate=0.02,
                       elimination_method="natural")


def eight_pose_graph(core, factors):
    """The loop in the package whose ``core`` and ``factors`` are given.
    Returns (poses x1..x8, factors: the prior, 7 odometry factors, the
    loop closure)."""
    n = 8
    move = 4.0
    prior_noise = np.diag([0.3 ** 2, 0.3 ** 2, 0.1 ** 2])
    odometry_noise = np.diag([0.2 ** 2, 0.2 ** 2, 0.1 ** 2])
    xs = [core.SE2Variable(f"x{i + 1}") for i in range(n)]
    fs = [factors.UnarySE2ApproximateGaussianPriorFactor(
        xs[0], np.array([0.0, 0.0, np.pi / 8]), prior_noise)]
    turn = 2 * np.pi / n
    fs += [factors.SE2RelativeGaussianLikelihoodFactor(
        xs[i], xs[i + 1], np.array([move, 0.0, turn]), odometry_noise)
        for i in range(n - 1)]
    fs.append(factors.SE2RelativeGaussianLikelihoodFactor(
        xs[-1], xs[0], np.array([move, 0.0, turn]), odometry_noise))
    return xs, fs


def run(device, seed: int = 0, **overrides) -> dict:
    """The example (``overrides`` of ``EIGHT_POSE_ARGS``): {"lines" (what
    it prints), "trans_err" and "heading_err" (each pose's posterior mean
    from the MAP, m and rad), "std" (each pose's sample std), "timings",
    "samples" (by name), "solver"}."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors

    xs, fs = eight_pose_graph(core, factors)
    steps, per_step, solver = solve_steps(
        {**EIGHT_POSE_ARGS, **overrides, "seed": seed}, [(xs, fs)], device)
    samples = per_step[-1]
    names = [str(v.name) for v in xs]
    trans, heading = map_distances(samples, map_estimate(xs, fs, device),
                                   names)
    return {"lines": [moment_line(n, samples[n]) for n in names],
            "trans_err": trans, "heading_err": heading,
            "std": {n: samples[n].std(0).tolist() for n in names},
            "timings": steps, "samples": samples, "solver": solver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples.toy_examples."
             "eight_pose_circle", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = example_device("eight_pose_circle", args.device)
    if device is None:
        return 1
    print("\n".join(run(device)["lines"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
