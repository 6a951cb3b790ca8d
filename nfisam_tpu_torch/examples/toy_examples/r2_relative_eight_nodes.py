"""Eight R(2) nodes chained by linear-Gaussian displacement factors: the
JAX repo's ``examples/toy_examples/r2_relative_eight_nodes.py`` in the
port.  The posterior is exactly Gaussian, so each sample mean is printed
beside the closed form (``gaussian_displacement_graph_moments``)::

    python -m nfisam_tpu_torch.examples.toy_examples.r2_relative_eight_nodes
    python -m nfisam_tpu_torch.examples.toy_examples.r2_relative_eight_nodes --device cpu

One step by ``NFiSAM`` at the JAX example's configuration (natural
ordering, K=8, 1500 training samples, <= 800 iterations, lr 0.03, 1000
draws, seed 0).  It writes no file.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import example_device, solve_steps

# the JAX example's NFiSAMArgs
EIGHT_NODE_ARGS = dict(posterior_sample_num=1000, local_sample_num=1500,
                       flow_iterations=800, num_knots=8, learning_rate=0.03,
                       elimination_method="natural")


def eight_node_graph(core, factors):
    """The eight-node chain in the package whose ``core`` and ``factors``
    are given: a Gaussian prior on X0 and displacements of 3 m,
    alternately along x and y.  Returns (variables, factors, the closed
    form's (variables, displacements, priors) arguments)."""
    xs = [core.R2Variable(f"X{i}") for i in range(8)]
    prior_cov = np.diag([0.09, 0.09])
    odom_cov = np.diag([0.04, 0.04])
    moves = [np.array([3.0, 0.0]) if i % 2 == 0 else np.array([0.0, 3.0])
             for i in range(7)]
    fs = [factors.UnaryR2GaussianPriorFactor(xs[0], np.zeros(2), prior_cov)]
    fs += [factors.R2RelativeGaussianLikelihoodFactor(xs[i], xs[i + 1], mv,
                                                      odom_cov)
           for i, mv in enumerate(moves)]
    oracle = (xs, {(xs[i], xs[i + 1]): (mv, odom_cov)
                   for i, mv in enumerate(moves)},
              {xs[0]: (np.zeros(2), prior_cov)})
    return xs, fs, oracle


def solve(seed: int, device, **overrides) -> tuple:
    """The chain by ``NFiSAM`` in one step (``overrides`` of
    ``EIGHT_NODE_ARGS``).  Returns (timings, host samples by name, solver,
    closed-form arguments)."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors

    xs, fs, oracle = eight_node_graph(core, factors)
    steps, per_step, solver = solve_steps(
        {**EIGHT_NODE_ARGS, **overrides, "seed": seed}, [(xs, fs)], device)
    return steps, per_step[-1], solver, oracle


def run(device, seed: int = 0, **overrides) -> dict:
    """The example: {"lines" (what it prints), "mean_err" (each sample
    mean's distance from the closed form, m), "timings", "samples",
    "solver"}."""
    from ...eval import gaussian_displacement_graph_moments

    steps, samples, solver, oracle = solve(seed, device, **overrides)
    mean, _ = gaussian_displacement_graph_moments(*oracle)
    lines, errs = [], []
    for i, v in enumerate(oracle[0]):
        s = samples[str(v.name)]
        exact = mean[2 * i:2 * i + 2]
        errs.append(float(np.linalg.norm(s.mean(0) - exact)))
        lines.append(f"{v.name}: sample mean {np.round(s.mean(0), 2)} "
                     f"closed form {np.round(exact, 2)} "
                     f"err {errs[-1]:.3f}")
    return {"lines": lines, "mean_err": errs, "timings": steps,
            "samples": samples, "solver": solver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples.toy_examples."
             "r2_relative_eight_nodes", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = example_device("r2_relative_eight_nodes", args.device)
    if device is None:
        return 1
    print("\n".join(run(device)["lines"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
