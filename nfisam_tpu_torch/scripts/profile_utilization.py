"""Device-utilization accounting of the two hot paths: the JAX package's
``scripts/profile_utilization.py`` in the port.

For (a) one clique-flow fit, alone (``fit_flow_raw``) and in buckets of B
(``fit_flows_batched``), and (b) the fused root-to-leaf posterior pass
over a synthetic 16-clique chain (``solver/posterior_pass.run_plan``, the
code the solver's pass runs), at clique scale and at saturating sample
counts, it reports the wall time a call (and an Adam iteration), the
achieved FLOP/s against the card's peak (MFU) and the samples a second.
The FLOP counts are the JAX script's analytic ones, carried over
exactly: the masked conditioner's three einsums and a per-scalar RQS
estimate; ~3x a forward pass for a training iteration; one single-dim
conditioner and one RQS inversion a dim for the AR inverse.

The fits run fixed work as in the JAX script (``loss_delta_tol=0``: the
plateau stop never fires): 2000 iterations at n = 2000 and 100 at
n = 262144 alone, 500 at n = 2000 in buckets of B in {1, 4, 16, 64}; the
pass runs at n in {1000, 4096, 16384, 65536, 262144}.  Each timed call
gets fresh inputs (a new key), as in the JAX script, after one untimed
call; every timer ends in a synchronize.  MFU is quoted against the
H100 SXM's published float32 rate outside the tensor cores (67 TFLOP/s,
the paths' type: TF32 is off) and, beside it, its dense TF32 tensor-core
rate (495 TFLOP/s); the card's name and power limit, and the peak memory
of each row (``torch.cuda.max_memory_allocated``), are in the output::

    python -m nfisam_tpu_torch.scripts.profile_utilization

The run takes the JAX script's arguments (none) plus ``--device``
(default ``cuda``: without a card it exits 1 unless given ``--device
cpu``, whose rows are no device figures) and ``--out`` (the JSON, by
default ``profile_utilization.json`` in ``tempfile.gettempdir()``; never
the repository's ``PROFILE.json``, a TPU run).  It prints a table to
stderr and one JSON line.  To rehearse on the CPU, call the ``profile_*``
functions at small sizes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.cuda_build import build_before_run

# the H100 SXM's data sheet, dense, at its 700 W limit: float32 outside
# the tensor cores, and TF32 on them
PEAK_F32 = 67e12
PEAK_TF32 = 495e12

DIM, KNOTS, HIDDEN = 16, 9, 8
RQS_FLOPS_PER_SCALAR = 45   # bin-search compares + rational quadratic

# (n, iterations) of the lone fit; the buckets' n, iterations and B; the
# pass's chain length and sample counts (the JAX script's)
FIT_CASES = ((2000, 2000), (262144, 100))
BATCHED_N, BATCHED_ITERS, BATCHED_B = 2000, 500, (1, 4, 16, 64)
CHAIN_L = 16
PASS_N = (1000, 4096, 16384, 65536, 262144)


def cfg():
    from ..flows.nsf import NSFConfig
    return NSFConfig(dim=DIM, num_knots=KNOTS, hidden_dim=HIDDEN,
                     num_flows=1)


def conditioner_flops_per_sample(d=DIM, h=HIDDEN, p=3 * KNOTS) -> int:
    """All-dims masked conditioner: three einsums (MACs x2)."""
    return 2 * (d * h * d + d * h * h + d * p * h)


def trainer_flops_per_iter(n: int, d=DIM, h=HIDDEN, k=KNOTS) -> float:
    """value_and_grad of the NLL: ~3x the forward cost (fwd + bwd)."""
    fwd = n * (conditioner_flops_per_sample(d, h, 3 * k)
               + d * RQS_FLOPS_PER_SCALAR)
    return 3.0 * fwd


def inverse_flops_per_sample(d=DIM, h=HIDDEN, k=KNOTS) -> float:
    """Sequential AR inverse: one single-dim conditioner (three matvecs,
    MACs x2) plus one RQS inversion per dim step."""
    matvecs = d * h + h * h + h * 3 * k
    return d * (2 * matvecs + RQS_FLOPS_PER_SCALAR)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_keys(fn, make_args, device, reps: int = 2) -> tuple:
    """(mean seconds of ``reps`` calls of ``fn``, each on fresh inputs
    ``make_args(r)``, after one untimed call; the peak memory allocated
    over the timed calls (None on the CPU); the last output)."""
    fn(*make_args(0))
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for r in range(1, reps + 1):
        out = fn(*make_args(r))
    sync(device)
    wall = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    return wall, peak, out


def mfu_keys(flops: float, wall: float) -> dict:
    return {"mfu_f32_pct": round(100 * flops / wall / PEAK_F32, 4),
            "mfu_tf32_pct": round(100 * flops / wall / PEAK_TF32, 4)}


def fixed_work(iters: int):
    """The training settings of a fixed-work fit: no plateau stop."""
    from ..train.trainer import TrainConfig
    return TrainConfig(max_iters=iters, learning_rate=0.025,
                       loss_delta_tol=0.0)


def profile_trainer(device, cases) -> list:
    """One clique fit (n = 2000, 2000 iterations: the journal config) and
    a saturated fit (n = 262144, 100 iterations)."""
    from ..train.trainer import fit_flow_raw
    rows = []
    for n, max_iters in cases:
        tc = fixed_work(max_iters)
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(n, DIM)).astype(np.float32), device=device)
        mask = [False] * DIM

        def make_args(r, x=x, tc=tc, mask=mask):
            return (np.array([7, r], dtype=np.uint32), x, cfg(), tc, mask)

        wall, peak, out = timed_keys(fit_flow_raw, make_args, device)
        iters = int(out[2])
        flops = trainer_flops_per_iter(n) * iters
        rows.append({"component": "clique_fit", "n": n, "iters": iters,
                     "wall_s": round(wall, 4),
                     "per_iter_us": round(1e6 * wall / max(iters, 1), 1),
                     "analytic_flops": flops, **mfu_keys(flops, wall),
                     "peak_mem_bytes": peak})
        print(f"clique_fit n={n:>7}: {wall:7.3f} s/call, {iters} iters, "
              f"{1e6 * wall / max(iters, 1):8.1f} us/iter, MFU "
              f"{rows[-1]['mfu_f32_pct']:7.4f}% (f32 peak)", file=sys.stderr)
    return rows


def profile_batched_trainer(device, n: int, iters: int, buckets) -> list:
    """The bucketed clique trainer at bucket sizes B, fixed work:
    clique-fits a second and MFU per B."""
    from ..train.trainer import fit_flows_batched
    tc = fixed_work(iters)
    rows, base_mfu = [], None
    for B in buckets:
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(B, n, DIM)).astype(np.float32), device=device)
        masks = np.zeros((B, DIM), dtype=bool)

        def make_args(r, x=x, masks=masks, B=B):
            keys = np.zeros((B, 2), dtype=np.uint32)
            keys[:, 0] = 7
            keys[:, 1] = np.arange(B) + 1000 * r
            return (keys, x, cfg(), tc, masks)

        wall, peak, out = timed_keys(fit_flows_batched, make_args, device)
        it = int(out[2][0])
        flops = B * trainer_flops_per_iter(n) * it
        mfu = flops / wall / PEAK_F32
        if base_mfu is None:
            base_mfu = mfu
        rows.append({"component": "clique_fit_batched", "B": B, "n": n,
                     "iters": it, "wall_s": round(wall, 4),
                     "clique_fits_per_s": round(B / wall, 2),
                     "analytic_flops": flops, **mfu_keys(flops, wall),
                     "mfu_recovery_vs_B1": round(mfu / base_mfu, 2),
                     "peak_mem_bytes": peak})
        print(f"clique_fit_batched B={B:>3}: {wall:7.3f} s/call, "
              f"{B / wall:8.2f} fits/s, MFU {100 * mfu:7.4f}% "
              f"({mfu / base_mfu:5.2f}x vs B=1)", file=sys.stderr)
    return rows


def chain_plan(device):
    """The JAX script's synthetic chain (:170-189): ``CHAIN_L`` cliques of
    one d=16 flow each (the same parameters, from the zero key; mean 0,
    std 1; nothing circular), no observation and no separator (every dim
    inverted), each writing its 16 frontal columns.  The JAX script
    wraps the last column onto column 0 to fit its 256-wide buffer; here
    the buffer holds all 256 and the pass's zero column."""
    from ..flows.model import CliqueFlowModel
    from ..flows.nsf import init_flow_params
    from ..solver.posterior_pass import pack_plan
    from ..utils.keys import torch_generator

    c = cfg()
    params = init_flow_params(torch_generator(np.zeros(2, np.uint32),
                                              device), c, device)
    model = CliqueFlowModel(c, params, torch.zeros(DIM, device=device),
                            torch.ones(DIM, device=device), [False] * DIM,
                            aug_sep_dim=0)
    specs = [(model, np.zeros(0, np.float32), [], i * DIM, DIM)
             for i in range(CHAIN_L)]
    return pack_plan(specs, CHAIN_L * DIM, device)


def profile_fused_pass(device, sizes) -> list:
    """The fused posterior pass over the 16-clique chain across sample
    counts: samples a second and MFU at clique scale and saturation."""
    from ..solver.posterior_pass import run_plan
    plan = chain_plan(device)
    rows = []
    for n in sizes:
        def make_args(r, n=n):
            keys = iter(np.array([[0, r]] * CHAIN_L, dtype=np.uint32))
            return (plan, lambda: next(keys), n, device)

        wall, peak, _ = timed_keys(run_plan, make_args, device)
        flops = n * CHAIN_L * inverse_flops_per_sample()
        sps = n / wall
        rows.append({"component": "fused_posterior_pass", "n": n,
                     "wall_s": round(wall, 5), "samples_per_s": round(sps),
                     "analytic_flops": flops, **mfu_keys(flops, wall),
                     "peak_mem_bytes": peak})
        print(f"fused_pass n={n:>8}: {wall * 1e3:9.2f} ms/call, "
              f"{sps / 1e6:8.3f} M samples/s, MFU "
              f"{rows[-1]['mfu_f32_pct']:7.4f}% (f32 peak)", file=sys.stderr)
    return rows


def card_reading(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device
    type off a card."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def summarize(rows: list, device, card: str) -> dict:
    """The JAX script's output (:215-227) and the port's keys."""
    fp = [r for r in rows if r["component"] == "fused_posterior_pass"]
    best = max(r["samples_per_s"] for r in fp)
    sat = next(r["n"] for r in fp if r["samples_per_s"] >= 0.7 * best)
    launch_bound = fp[0]["samples_per_s"] < 0.1 * best
    bt = [r for r in rows if r["component"] == "clique_fit_batched"]
    return {"backend": device.type, "rows": rows,
            "saturation_batch": sat,
            "clique_scale_launch_bound": bool(launch_bound),
            "batched_trainer_mfu_recovery": bt[-1]["mfu_recovery_vs_B1"]
            if bt else None,
            "peak_f32_flops": PEAK_F32,
            "peak_tf32_flops": PEAK_TF32,
            "card": card,
            "device_name": torch.cuda.get_device_name(device)
            if device.type == "cuda" else None}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m nfisam_tpu_torch.scripts.profile_utilization",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="the JSON (default profile_utilization.json in the "
                         "temporary directory)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..utils.device import resolve_device
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"profile_utilization: {e}", file=sys.stderr)
        return 1
    card = card_reading(device)
    print(f"# backend: {device.type}, device: {card}", file=sys.stderr)
    build = build_before_run(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = (profile_trainer(device, FIT_CASES)
            + profile_batched_trainer(device, BATCHED_N, BATCHED_ITERS,
                                      BATCHED_B)
            + profile_fused_pass(device, PASS_N))
    out = {**summarize(rows, device, card), **build}
    print(json.dumps(out))
    path = args.out or os.path.join(tempfile.gettempdir(),
                                    "profile_utilization.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"# wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
