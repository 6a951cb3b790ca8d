#!/usr/bin/env python
"""Diagnostics of the generic AR-inverse kernel
(``nfisam_tpu_torch/csrc/ar_inverse_generic.cu``) on one GPU, apart from
the smoke check: what each part of a dim step costs and what the compiler
made of it.  Run from the repository root:

- ``python3 probe_ar_inverse_generic.py --ablate DIR`` writes copies of
  the source with one part of a step cut out each (no card needed; the
  cuts are found by text in the source, and a cut whose text is gone
  stops the script);
- ``python3 probe_ar_inverse_generic.py --compare SRC [SRC ...]`` builds
  each source with the generic kernel's C interface (such copies, or an
  earlier commit's: ``git show <commit>:nfisam_tpu_torch/csrc/
  ar_inverse_generic.cu > old.cu``) and times it beside this tree's
  kernel in turns, on the device (``chip_smoke.time_cuda``);
- ``python3 probe_ar_inverse_generic.py --sass`` lists each generic
  instantiation's main loop by opcode (``cuobjdump -sass``), beside the
  specialised kernel's at (16, 8, 9).

Imports nothing of JAX.  The copies' results are wrong by design: they
time a step without one of its parts."""
import argparse
import os
import subprocess
import sys

import torch

from chip_smoke import HERE, TIMED_CASES, log, make_case, time_cuda

# the parts of a generic step that ``write_generic_ablations`` cuts out of
# copies of its source, for timing only (their results are wrong): (name,
# the cut's first text, the text it stops before, what replaces it)
GENERIC_ABLATIONS = [
    ("no_layer1", "    // layer 1: the previous column's term",
     "    // the next dim's layer 1", "    float h1r = pre0 + xprev;\n"),
    ("no_partial", "    partial(nxt.w1, nx);", "    // layer 2, its units", ""),
    ("no_layer2", "    // layer 2, its units", "    __syncwarp();\n    // layer 3",
     "    if (lane < h) h2_s[lane] = h1r;\n"),
    ("no_layer3", "    float pw = 0.f, ph = 0.f, pd = 0.f;",
     "    // the spline inverse",
     "    float pw = h2_s[lane], ph = pw + 1.f, pd = pw - 1.f;\n"),
    ("no_spline", "    float cw_lo, cw_up, ch_lo, ch_up, d_lo, d_up;\n"
     "    if (NK == 1) {", "    const float in_w",
     "    float cw_lo = -bound, cw_up = bound, ch_lo = -bound, ch_up = bound,"
     " d_lo = 1.f + pw * 1e-9f, d_up = 1.f + ph * 1e-9f + pd;\n")]
# the shapes the diagnostics time: the generic timed cases, one block
# alone (n=8: the chain's latency) and every column pinned (no step)
COMPARE_CASES = [c for c in TIMED_CASES if "generic" in c[0]] + [
    ("generic d16 h16 n=8 sep2", 8, 16, 16, 9, 1, 2, ()),
    ("generic d16 h16 n=1000 all pinned", 1000, 16, 16, 9, 1, 16, ())]


def write_generic_ablations(out_dir: str) -> list:
    """Copies of ``csrc/ar_inverse_generic.cu`` in ``out_dir``: the source
    as it is (``gen_base.cu``) and one with each part of
    ``GENERIC_ABLATIONS`` cut out.  Returns their paths."""
    from nfisam_tpu_torch.flows.ar_inverse import ARInverseKernel

    with open(ARInverseKernel.sources["generic"]) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, start, end, repl in [("base", "", "", "")] + GENERIC_ABLATIONS:
        text = src
        if start:
            a, b = src.find(start), src.find(end, src.find(start))
            if a < 0 or b < 0:
                raise SystemExit(f"ablation {name}: its markers are no longer "
                                 f"in the source; update GENERIC_ABLATIONS")
            text = src[:a] + repl + src[b:]
        path = os.path.join(out_dir, f"gen_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        paths.append(path)
    return paths


def compare_generic_builds(device, sources) -> None:
    """Each source with the generic kernel's C interface (an earlier
    commit's ``ar_inverse_generic.cu``, ablation copies) built and timed
    beside this tree's generic kernel at ``COMPARE_CASES``: device ms
    (``time_cuda`` with the stream held), in turns forward then backward,
    and each one's max |x - plain|."""
    import ctypes

    from nfisam_tpu_torch.flows import (stack_inverse_masked_cuda,
                                        stack_inverse_masked_plain)
    from nfisam_tpu_torch.flows.rqs import BOUNDARY_RAW_DERIV
    from nfisam_tpu_torch.utils.cuda_build import build_shared_libs

    built = build_shared_libs(list(sources))
    fns = {}
    for src in sources:
        fn = ctypes.CDLL(built[src][0]).nfisam_ar_inverse_generic_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[os.path.relpath(src, HERE)] = fn
    for case in COMPARE_CASES:
        cfg, params, z, xp, mask = make_case(case, device, seed=7)
        p = params[0]
        inv = mask.contiguous().view(torch.uint8)
        circ = torch.as_tensor(cfg.circular_mask.astype("uint8"),
                               device=device)
        out = torch.empty_like(z)

        def bind(fn):
            def call():
                err = fn(z.data_ptr(), xp.data_ptr(), inv.data_ptr(),
                         circ.data_ptr(), p["W1"].data_ptr(),
                         p["b1"].data_ptr(), p["W2"].data_ptr(),
                         p["b2"].data_ptr(), p["W3"].data_ptr(),
                         p["b3"].data_ptr(), out.data_ptr(), z.shape[0],
                         cfg.dim, cfg.hidden_dim, cfg.num_knots,
                         float(cfg.tail_bound), BOUNDARY_RAW_DERIV,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"build failed to launch: {err}")
            return call

        calls = {"this tree": lambda: stack_inverse_masked_cuda(
            params, z, xp, mask, cfg, "generic")}
        calls.update({name: bind(fn) for name, fn in fns.items()})
        with torch.no_grad():
            ref = stack_inverse_masked_plain(params, z, xp, mask, cfg)
            errs = {}
            for name, call in calls.items():
                got = call() if name == "this tree" else (call(), out)[1]
                torch.cuda.synchronize()
                errs[name] = float((got - ref).abs().max())
            ms = {name: [] for name in calls}
            for order in (list(calls), list(reversed(calls))):
                for name in order:
                    ms[name].append(time_cuda(calls[name], hold=True))
        log(f"compare {case[0]} (device ms in turns; max |x - plain|): " +
            "; ".join(f"{name} {t[0]:.5f}, {t[1]:.5f} ({errs[name]:.2e})"
                      for name, t in ms.items()))


def sass_report(source: str, only: str = "") -> None:
    """The instructions of each instantiation's main loop (its longest
    predicated backward branch: the divergence fallbacks jump back
    unconditionally) in the built library of ``source``, by opcode, as
    ``cuobjdump -sass`` lists them (static counts: an inner loop's body
    counts once); ``only``: the functions whose mangled name holds it."""
    import re
    import shutil
    from collections import Counter

    from nfisam_tpu_torch.utils.cuda_build import build_shared_libs

    lib = build_shared_libs([source])[source][0]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        if only not in name:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        loops = [(a - int(t.split("0x")[-1], 16), int(t.split("0x")[-1], 16), a)
                 for a, t in ins if re.match(r"@!?P\d+ BRA 0x[0-9a-f]+$", t)
                 and int(t.split("0x")[-1], 16) < a]
        body = [t for a, t in ins if loops and max(loops)[1] <= a <= max(loops)[2]]
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                      for t in body)
        log(f"sass {name[-60:]}: main loop {len(body)} instructions; "
            f"{', '.join(f'{k} {v}' for k, v in ops.most_common(12))}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ablate", metavar="DIR",
                        help="write copies of the generic kernel with one "
                        "part of a step cut out each to DIR")
    parser.add_argument("--compare", metavar="SRC", nargs="+",
                        help="time builds of these generic-kernel sources "
                        "beside this tree's on the card")
    parser.add_argument("--sass", action="store_true",
                        help="print each generic instantiation's main "
                        "loop (and the specialised kernel's at d=16, h=8, "
                        "K=9) by opcode")
    opts = parser.parse_args()
    if opts.ablate:
        for path in write_generic_ablations(opts.ablate):
            print(path)
    if not (opts.compare or opts.sass):
        return 0
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from nfisam_tpu_torch.flows.ar_inverse import ARInverseKernel
    from nfisam_tpu_torch.utils.cuda_build import build_all_kernels

    build_all_kernels()
    if opts.sass:
        sass_report(ARInverseKernel.sources["generic"])
        sass_report(ARInverseKernel.sources["specialized"], "ILi16ELi8ELi9E")
    if opts.compare:
        compare_generic_builds(torch.device("cuda"),
                               [os.path.abspath(p) for p in opts.compare])
    return 0


if __name__ == "__main__":
    sys.exit(main())
