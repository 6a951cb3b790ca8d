"""Nested-sampling ground truth for case1, step by step: the JAX repo's
``examples/small_range_gaussian_problem/generate_reference_solution.py``
in the port::

    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.generate_reference_solution
    python -m nfisam_tpu_torch.examples.small_range_gaussian_problem.generate_reference_solution --device cpu --out DIR

Each prefix of case1 (one pose a step) by a static ``GlobalNestedSampler``
at 1000 live points and the sampler's default key, as the JAX example
passes none; ``ns_reference/step{i}.sample`` and ``step{i}_ordering``
under ``--out`` in the JAX example's format, one line a step with the
sampler's summary.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .. import default_out, example_device
from . import FAMILY, case1_graph

LIVE_POINTS = 1000


def run(device, out_dir: str, steps: int = None,
        live_points: int = LIVE_POINTS) -> dict:
    """The example into ``out_dir/ns_reference``, cut to its first
    ``steps`` steps if given: {"lines" (what it prints), "ref_dir",
    "steps" ({"n", "summary", "s"} a step), "samples" ((samples, column
    names) a step)}."""
    from ...samplers import GlobalNestedSampler

    nodes, _, _, batches = case1_graph()
    ref_dir = os.path.join(out_dir, "ns_reference")
    os.makedirs(ref_dir, exist_ok=True)
    vs, fs, lines, rows, out = [], [], [], [], []
    for step, (ns_, fs_) in enumerate(batches[:steps]):
        vs += ns_
        fs += fs_
        sampler = GlobalNestedSampler(vs, fs, device=device)
        summary = {}
        t0 = time.perf_counter()
        samples = sampler.sample(live_points=live_points,
                                 res_summary=summary)
        seconds = time.perf_counter() - t0
        np.savetxt(os.path.join(ref_dir, f"step{step}.sample"), samples)
        with open(os.path.join(ref_dir, f"step{step}_ordering"), "w") as f:
            f.write(" ".join(str(v.name) for v in vs))
        lines.append(f"step {step}: {samples.shape[0]} samples, {summary}")
        rows.append({"n": int(samples.shape[0]), "summary": summary,
                     "s": seconds})
        out.append((samples, [str(v.name) for v in vs]))
    return {"lines": lines, "ref_dir": ref_dir, "steps": rows,
            "samples": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.examples."
             "small_range_gaussian_problem.generate_reference_solution",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=default_out(FAMILY),
                    help="the directory ns_reference goes to")
    args = ap.parse_args(argv)
    device = example_device("generate_reference_solution", args.device)
    if device is None:
        return 1
    for line in run(device, args.out)["lines"]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
