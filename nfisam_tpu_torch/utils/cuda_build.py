"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded through ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into ``nfisam_tpu_torch/_build/`` under a name that carries a
hash of the source, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return path


def library_path(source: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build_shared_libs(sources: List[str]) -> Dict[str, Tuple[str, str]]:
    """Compile every source not built yet, in parallel.  Returns
    ``{source: (library path, nvcc's stderr)}``; raises naming the source
    and nvcc's message when one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, out = {}, {}
    for src in sources:
        lib = library_path(src)
        if os.path.exists(lib):
            out[src] = (lib, "")
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[src] = (lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for src, (lib, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{stdout}{stderr}")
        os.replace(tmp, lib)
        out[src] = (lib, stderr)
    return out


def build_all_kernels() -> Tuple[float, Dict[str, Tuple[str, str]]]:
    """Build every ``csrc/*.cu`` at once; returns (seconds, per-source
    result of ``build_shared_libs``)."""
    sources = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    built = build_shared_libs(sources)
    return time.perf_counter() - t0, built


def build_before_run(device) -> Dict[str, object]:
    """For a run on ``device``: on a card, every kernel built before the
    run's timers start, so that no timed step holds ``nvcc``; returns
    {"build_s", "build_cache_warm"} (every library was already built).
    Elsewhere {} and nothing built."""
    import torch
    if torch.device(device).type != "cuda":
        return {}
    seconds, built = build_all_kernels()
    return {"build_s": round(seconds, 1),
            "build_cache_warm": all(err == "" for _, err in built.values())}
