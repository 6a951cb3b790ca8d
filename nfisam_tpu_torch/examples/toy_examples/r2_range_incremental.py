"""Five R(2) nodes with range measurements, incremental: the JAX repo's
``examples/toy_examples/r2_range_incremental.py`` in the port.  The
posterior of a landmark constrained only by ranges is ring-shaped and
multi-modal, the canonical non-Gaussian SLAM example::

    python -m nfisam_tpu_torch.examples.toy_examples.r2_range_incremental
    python -m nfisam_tpu_torch.examples.toy_examples.r2_range_incremental --device cpu

Four steps by ``NFiSAM`` at the JAX example's configuration (pose_first,
K=8, 1000 training samples, <= 800 iterations, lr 0.03, 500 draws, seed
0, mode repair on by default); each step's means and stds are printed.
It writes no file.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import example_device, solve_steps, step_lines

# the JAX example's NFiSAMArgs
R2_RANGE_ARGS = dict(posterior_sample_num=500, local_sample_num=1000,
                     flow_iterations=800, num_knots=8, learning_rate=0.03,
                     elimination_method="pose_first")


def r2_range_graph(core, factors):
    """The example's four steps in the package whose ``core`` and
    ``factors`` are given: R^2 poses on an odometry chain, ranges from
    three of them to one landmark.  Returns [(new nodes, new factors)]."""
    xs = [core.R2Variable(f"X{i}") for i in range(4)]
    lm = core.R2Variable("L1", core.VariableType.Landmark)
    cov2 = np.diag([0.04, 0.04])
    rel = factors.R2RelativeGaussianLikelihoodFactor
    rng = factors.R2RangeGaussianLikelihoodFactor
    return [([xs[0], lm], [factors.UnaryR2GaussianPriorFactor(
                xs[0], np.zeros(2), cov2), rng(xs[0], lm, 5.0, 0.3)]),
            ([xs[1]], [rel(xs[0], xs[1], np.array([4.0, 0.0]), cov2)]),
            ([xs[2]], [rel(xs[1], xs[2], np.array([4.0, 0.0]), cov2),
                       rng(xs[2], lm, 4.0, 0.3)]),
            ([xs[3]], [rel(xs[2], xs[3], np.array([0.0, 4.0]), cov2),
                       rng(xs[3], lm, 5.0, 0.3)])]


def solve(seed: int, device, **overrides) -> tuple:
    """The four steps by ``NFiSAM`` (``overrides`` of ``R2_RANGE_ARGS``).
    Returns (per-step timings, per-step host samples by name, solver)."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors

    return solve_steps({**R2_RANGE_ARGS, **overrides, "seed": seed},
                       r2_range_graph(core, factors), device)


def run(device, seed: int = 0, **overrides) -> dict:
    """The example: {"lines" (what it prints), "timings", "per_step"
    (host samples by name), "solver"}."""
    steps, per_step, solver = solve(seed, device, **overrides)
    return {"lines": step_lines(per_step), "timings": steps,
            "per_step": per_step, "solver": solver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples.toy_examples."
             "r2_range_incremental", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = example_device("r2_range_incremental", args.device)
    if device is None:
        return 1
    print("\n".join(run(device)["lines"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
