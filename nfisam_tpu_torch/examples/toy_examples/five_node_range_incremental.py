"""The five-node SE(2) + range toy graph, incremental: the JAX repo's
``examples/toy_examples/five_node_range_incremental.py`` in the port::

    python -m nfisam_tpu_torch.examples.toy_examples.five_node_range_incremental
    python -m nfisam_tpu_torch.examples.toy_examples.five_node_range_incremental --device cpu

Four SE(2) poses 5 m apart on the x-axis and a landmark L1 ranged at 7, 5
and 7 m from X0, X2 and X3, so L1's posterior has two modes mirrored in
the x-axis; four steps by ``NFiSAM`` at the JAX example's configuration
(pose_first, K=8, 1000 training samples, <= 800 iterations, lr 0.03, 500
draws, seed 0), each step's means and stds printed.  ``run`` also holds
each step's poses against ``GaussNewtonMAP`` of that step's graph and
counts L1's samples above the axis.  It writes no file.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import (example_device, map_distances, map_estimate, solve_steps,
                step_lines)

# the JAX example's NFiSAMArgs
FIVE_NODE_ARGS = dict(posterior_sample_num=500, local_sample_num=1000,
                      flow_iterations=800, num_knots=8, learning_rate=0.03,
                      elimination_method="pose_first")


def five_node_graph(core, factors):
    """The example's four steps in the package whose ``core`` and
    ``factors`` are given.  Returns [(new nodes, new factors)]."""
    xs = [core.SE2Variable(f"X{i}") for i in range(4)]
    lm = core.R2Variable("L1", core.VariableType.Landmark)
    cov3 = np.diag([0.01, 0.01, 0.001])
    rel = factors.SE2RelativeGaussianLikelihoodFactor
    rng = factors.SE2R2RangeGaussianLikelihoodFactor
    return [([xs[0], lm], [factors.UnarySE2ApproximateGaussianPriorFactor(
                xs[0], np.zeros(3), cov3), rng(xs[0], lm, 7.0, 0.3)]),
            ([xs[1]], [rel(xs[0], xs[1], np.array([5.0, 0, 0]), cov3)]),
            ([xs[2]], [rel(xs[1], xs[2], np.array([5.0, 0, 0]), cov3),
                       rng(xs[2], lm, 5.0, 0.3)]),
            ([xs[3]], [rel(xs[2], xs[3], np.array([5.0, 0, 0]), cov3),
                       rng(xs[3], lm, 7.0, 0.3)])]


def run(device, seed: int = 0, **overrides) -> dict:
    """The example (``overrides`` of ``FIVE_NODE_ARGS``): {"lines" (what
    it prints), "pose_err" (per step, each pose's posterior-mean distance
    from that step's MAP, m), "l1_above" (the share of L1's last-step
    samples at y > 0), "timings", "per_step" (host samples by name),
    "solver"}."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors

    steps = five_node_graph(core, factors)
    timings, per_step, solver = solve_steps(
        {**FIVE_NODE_ARGS, **overrides, "seed": seed}, steps, device)
    nodes, fs, pose_err = [], [], []
    for (ns, new_fs), samples in zip(steps, per_step):
        nodes += ns
        fs += new_fs
        poses = [str(v.name) for v in nodes if str(v.name).startswith("X")]
        pose_err.append(map_distances(
            samples, map_estimate(nodes, fs, device), poses)[0])
    return {"lines": step_lines(per_step), "pose_err": pose_err,
            "l1_above": float(np.mean(per_step[-1]["L1"][:, 1] > 0)),
            "timings": timings, "per_step": per_step, "solver": solver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples.toy_examples."
             "five_node_range_incremental",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = example_device("five_node_range_incremental", args.device)
    if device is None:
        return 1
    print("\n".join(run(device)["lines"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
