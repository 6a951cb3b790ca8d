"""Masked autoregressive flow inverse: the CUDA kernel and its plain version.

``ar_inverse_kernel`` launches ``csrc/ar_inverse.cu`` (the port of the
Pallas TPU kernel ``nfisam_tpu/flows/ar_inverse_pallas.py``) on CUDA
tensors: one launch per flow, the whole sequential-in-dim inverse of that
flow fused.  It takes nothing but contiguous float32 CUDA tensors (the
weights 16-byte aligned, for the kernel's bulk copies) at a (dim, hidden,
knots) it has an instantiation for, raises on anything else, and never
falls back.  The library is built with ``nvcc`` at first use.

``flow_inverse_masked_plain`` / ``stack_inverse_masked_plain`` are the
same function in plain PyTorch (``nsf.flow_inverse_masked``); the model
layer sends CPU tensors there, and the tests and the card's smoke check
hold the kernel against it.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List

import torch

from ..utils.cuda_build import CSRC_DIR, build_shared_libs
from .nsf import NSFConfig, flow_inverse_masked, stack_inverse_masked
from .rqs import BOUNDARY_RAW_DERIV

# (dim, hidden) pairs of the solver's dim buckets (hidden = dim // 2, at
# least 8) and the knot counts the kernel is instantiated for
SUPPORTED_DIM_HIDDEN = ((16, 8), (32, 16), (64, 32))
SUPPORTED_KNOTS = (7, 9, 12)
WEIGHTS = ("W1", "b1", "W2", "b2", "W3", "b3")
# what ``ARInverseKernel.info`` reports, in the C function's order
INFO_FIELDS = ("registers", "local_bytes", "smem_bytes", "threads",
               "samples", "slots")


# the plain PyTorch versions: one flow, and the stack (last flow first)
flow_inverse_masked_plain = flow_inverse_masked
stack_inverse_masked_plain = stack_inverse_masked


class ARInverseKernel:
    """ctypes handle on the built kernel, with its launch count."""

    source = os.path.join(CSRC_DIR, "ar_inverse.cu")

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._circular: Dict[tuple, torch.Tensor] = {}

    def load(self) -> None:
        if self._lib is not None:
            return
        path, _ = build_shared_libs([self.source])[self.source]
        lib = ctypes.CDLL(path)
        fn = lib.nfisam_ar_inverse_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._lib = lib

    def info(self, d: int, h: int, K: int) -> Dict[str, int]:
        """Build facts of the (d, h, K) instantiation on the current card:
        registers and local (spill) bytes a thread, dynamic shared memory
        bytes, threads and samples a block, and weight ring slots."""
        self.load()
        fn = self._lib.nfisam_ar_inverse_info
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * len(INFO_FIELDS))()
        err = fn(d, h, K, out)
        if err != 0:
            raise RuntimeError(f"ar_inverse kernel: no build facts for "
                               f"d={d}, h={h}, K={K}: cudaError_t {err}")
        return dict(zip(INFO_FIELDS, out))

    def _circular_flags(self, cfg: NSFConfig, device) -> torch.Tensor:
        key = (cfg.circular, cfg.dim, str(device))
        flags = self._circular.get(key)
        if flags is None:
            flags = torch.as_tensor(cfg.circular_mask.astype("uint8"),
                                    device=device)
            self._circular[key] = flags
        return flags

    def __call__(self, params: dict, z_full: torch.Tensor,
                 x_prefix_full: torch.Tensor, invert_mask: torch.Tensor,
                 cfg: NSFConfig) -> torch.Tensor:
        """One flow's masked inverse; returns a new (n, dim) tensor."""
        d, h, K = cfg.dim, cfg.hidden_dim, cfg.num_knots
        if (d, h) not in SUPPORTED_DIM_HIDDEN or K not in SUPPORTED_KNOTS:
            raise ValueError(
                f"ar_inverse kernel has no instantiation for dim={d}, "
                f"hidden={h}, knots={K} (dim/hidden in "
                f"{SUPPORTED_DIM_HIDDEN}, knots in {SUPPORTED_KNOTS})")
        if not z_full.is_cuda:
            raise ValueError("ar_inverse kernel takes CUDA tensors only")
        n = z_full.shape[0]
        shapes = {"z_full": (z_full, (n, d)),
                  "x_prefix_full": (x_prefix_full, (n, d)),
                  "W1": (params["W1"], (d, h, d)), "b1": (params["b1"], (d, h)),
                  "W2": (params["W2"], (d, h, h)), "b2": (params["b2"], (d, h)),
                  "W3": (params["W3"], (d, 3 * K, h)),
                  "b3": (params["b3"], (d, 3 * K))}
        for name, (t, shape) in shapes.items():
            if t.dtype != torch.float32 or t.device != z_full.device or \
                    tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"ar_inverse kernel: {name} must be a contiguous float32 "
                    f"tensor of shape {shape} on {z_full.device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                    f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
        for name in WEIGHTS:
            if params[name].data_ptr() % 16:
                raise ValueError(f"ar_inverse kernel: {name} must be 16-byte "
                                 f"aligned (the kernel bulk-copies it)")
        if invert_mask.dtype != torch.bool or \
                tuple(invert_mask.shape) != (d,) or \
                invert_mask.device != z_full.device:
            raise ValueError(f"ar_inverse kernel: invert_mask must be a bool "
                             f"tensor of shape ({d},) on {z_full.device}")
        self.load()
        invert = invert_mask.contiguous().view(torch.uint8)
        circular = self._circular_flags(cfg, z_full.device)
        out = torch.empty_like(z_full)
        stream = torch.cuda.current_stream(z_full.device).cuda_stream
        err = self._lib.nfisam_ar_inverse_f32(
            z_full.data_ptr(), x_prefix_full.data_ptr(), invert.data_ptr(),
            circular.data_ptr(), params["W1"].data_ptr(),
            params["b1"].data_ptr(), params["W2"].data_ptr(),
            params["b2"].data_ptr(), params["W3"].data_ptr(),
            params["b3"].data_ptr(), out.data_ptr(), n, d, h, K,
            float(cfg.tail_bound), BOUNDARY_RAW_DERIV, stream)
        if err != 0:
            raise RuntimeError(f"ar_inverse kernel launch failed: "
                               f"cudaError_t {err}")
        self.launches += 1
        return out


ar_inverse_kernel = ARInverseKernel()


def stack_inverse_masked_cuda(flow_params: List[dict], z_full, x_prefix_full,
                              invert_mask, cfg: NSFConfig) -> torch.Tensor:
    """The stack inverse through the kernel: one launch per flow, last
    flow first."""
    x_full = z_full
    for params in reversed(flow_params):
        x_full = ar_inverse_kernel(params, z_full, x_prefix_full,
                                   invert_mask, cfg)
        z_full = x_full
    return x_full
