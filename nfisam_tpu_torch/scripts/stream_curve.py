"""A runner's per-step rows, read back from its result JSON: the totals of
the step wall and its split, the median step of each quarter of the
stream, and every K-th step's row with the running error where the
runner recorded one::

    python -m nfisam_tpu_torch.scripts.stream_curve RESULT.json [--every K]

It reads the ``step_rows`` (and ``err_curve``) that
``manhattan_scale_run`` and ``plaza_family_run`` write: wall, surgery,
fit and posterior seconds a step, and, from the Manhattan-scale runner,
the MAP floor's update-and-solve seconds, the variables solved and the
kernel's launches.  Numpy only; it runs nothing on a device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SPLIT = ("wall", "surgery", "fit", "posterior", "floor")


def totals(rows) -> dict:
    """Seconds summed over the steps for each part of the split present,
    and the kernel's launches."""
    out = {k: float(sum(r[k] for r in rows)) for k in SPLIT if k in rows[0]}
    if "launches" in rows[0]:
        out["launches"] = int(sum(r["launches"] for r in rows))
    return out


def quarter_medians(rows) -> list:
    """The median step wall of each quarter of the steps, cut as the
    Manhattan-scale runner cuts its q2 and q4 (``k n // 4``)."""
    walls = np.array([r["wall"] for r in rows])
    n = len(walls)
    return [float(np.median(walls[k * n // 4:(k + 1) * n // 4]))
            for k in range(4)]


def curve(result: dict, every: int) -> list:
    """Every ``every``-th step row and the last, each with the running
    error recorded at that step (None where there is none)."""
    rows = result["step_rows"]
    err = {e["step"]: e for e in result.get("err_curve", [])}
    keep = [r for r in rows if r["step"] % every == 0] + \
        ([rows[-1]] if rows[-1]["step"] % every else [])
    return [{**{k: r[k] for k in ("step", *SPLIT, "n_vars", "launches")
                if k in r},
             "err": {k: err[r["step"]][k] for k in ("rmse", "max")}
             if r["step"] in err else None} for r in keep]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.stream_curve",
        description=__doc__.split("\n")[0])
    ap.add_argument("result", help="a runner's result JSON")
    ap.add_argument("--every", type=int, default=64)
    args = ap.parse_args(argv)
    with open(args.result) as fh:
        result = json.load(fh)
    rows = result["step_rows"]
    print(json.dumps({"steps": len(rows), "totals": totals(rows),
                      "quarter_median_wall": quarter_medians(rows)}))
    for row in curve(result, args.every):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
