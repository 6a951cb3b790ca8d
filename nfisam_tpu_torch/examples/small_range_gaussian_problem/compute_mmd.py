"""Joint and per-marginal MMD of a solver run's step against the
nested-sampling reference: the JAX repo's
``examples/small_range_gaussian_problem/compute_mmd.py`` in the port (the
reference's protocol: RBF kernel, 500-sample subsets, translation
dims)::

    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.compute_mmd RUN_PREFIX REF_PREFIX

``RUN_PREFIX`` is a run's ``step{i}`` (with ``step{i}_ordering`` beside
it), ``REF_PREFIX`` a reference's ``step{i}`` (``.sample`` and
``_ordering``), from either package's run.  numpy alone: no device.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from . import FG

SUBSET = 500


def translation_columns(mat, order, name2var, names):
    """The x, y columns of ``names`` in a sample matrix whose columns
    follow ``order``."""
    cur, pos = 0, {}
    for n in order:
        pos[n] = cur
        cur += name2var[n].dim
    return np.hstack([mat[:, pos[n]:pos[n] + 2] for n in names])


def name_to_var(fg: str = FG) -> dict:
    from ...io import graph_file_parser
    nodes, _, _ = graph_file_parser(fg, "fg")
    return {str(v.name): v for v in nodes}


def mmds(run, run_order, ref, ref_order, name2var, subset: int = SUBSET,
         seed: int = 0) -> tuple:
    """The joint MMD of ``ref_order``'s translation columns and each
    variable's, on ``subset``-row subsets drawn from ``default_rng(seed)``
    in the JAX example's order.  Returns (joint, {name: MMD})."""
    from ...eval import mmd

    rng = np.random.default_rng(seed)

    def pick(A):
        return A[rng.choice(len(A), min(subset, len(A)), replace=False)]

    joint_run = translation_columns(run, run_order, name2var, ref_order)
    joint_ref = translation_columns(ref, ref_order, name2var, ref_order)
    joint = mmd(pick(joint_run), pick(joint_ref))
    marginals = {}
    for n in ref_order:
        a = translation_columns(run, run_order, name2var, [n])
        b = translation_columns(ref, ref_order, name2var, [n])
        marginals[n] = mmd(pick(a), pick(b))
    return joint, marginals


def read_ordering(path: str) -> list:
    with open(path) as fh:
        return fh.read().split()


def compute(run_prefix: str, ref_prefix: str, subset: int = SUBSET,
            seed: int = 0) -> tuple:
    """``mmds`` of a run's step file against a reference's."""
    return mmds(np.loadtxt(run_prefix), read_ordering(run_prefix +
                                                      "_ordering"),
                np.loadtxt(ref_prefix + ".sample"),
                read_ordering(ref_prefix + "_ordering"), name_to_var(),
                subset, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples."
             "small_range_gaussian_problem.compute_mmd",
        description=__doc__.split("\n")[0])
    ap.add_argument("run_prefix")
    ap.add_argument("ref_prefix")
    args = ap.parse_args(argv)
    joint, marginals = compute(args.run_prefix, args.ref_prefix)
    print("joint MMD:", joint)
    for n, x in marginals.items():
        print(f"  {n}: {x:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
