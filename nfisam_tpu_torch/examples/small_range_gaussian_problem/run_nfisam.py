"""Incremental NF-iSAM on case1 at the journal configuration: the JAX
repo's ``examples/small_range_gaussian_problem/run_nfisam.py`` in the
port::

    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.run_nfisam
    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.run_nfisam --device cpu --out DIR

One pose a step by the plain ``NFiSAM`` through ``run_incrementally``
(K=9, hidden 8, <= 2000 iterations, 2000 training samples, lr 0.025,
pose_first, 1000 draws, seed 0).  The run directory ``run{N}`` under
``--out`` holds the run harness's files, among them ``step{i}`` and
``step{i}_ordering``, which ``compute_mmd`` reads; the step plots are drawn
where matplotlib imports.
"""
from __future__ import annotations

import argparse
import sys

from .. import default_out, example_device, plot_args
from . import FAMILY, case1_graph

# the JAX example's NFiSAMArgs
RUN_ARGS = dict(posterior_sample_num=1000, local_sample_num=2000,
                flow_iterations=2000, num_knots=9, learning_rate=0.025,
                hidden_dim=8, elimination_method="pose_first", seed=0)


def run(device, case_dir: str, steps: int = None, verbose: bool = True,
        **overrides) -> dict:
    """The example, cut to its first ``steps`` steps if given
    (``overrides`` of ``RUN_ARGS``): {"lines" (its last line), "run_dir",
    "steps" (each step's wall, split, cliques trained and iterations,
    read back from the run directory), "solver"}."""
    from ...scripts.case1_da_run import step_rows
    from ...solver import NFiSAM, NFiSAMArgs
    from ...solver.run import run_incrementally

    _, truth, _, batches = case1_graph()
    batches = batches[:steps]
    solver = NFiSAM(NFiSAMArgs(**{**RUN_ARGS, **overrides}), device=device)
    run_dir = run_incrementally(case_dir, solver, batches, truth,
                                plot_args=plot_args(verbose),
                                verbose=verbose)
    return {"lines": [f"artifacts: {run_dir}"], "run_dir": run_dir,
            "steps": step_rows(run_dir, len(batches)), "solver": solver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples."
             "small_range_gaussian_problem.run_nfisam",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=default_out(FAMILY),
                    help="the directory the run directory goes to")
    args = ap.parse_args(argv)
    device = example_device("run_nfisam", args.device)
    if device is None:
        return 1
    print("\n".join(run(device, args.out)["lines"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
