"""Masked autoregressive flow inverse: the CUDA kernels and their plain
version.

``ar_inverse_kernel`` launches one of two kernels on CUDA tensors, both
ports of the Pallas TPU kernel ``nfisam_tpu/flows/ar_inverse_pallas.py``:
one launch per flow, the whole sequential-in-dim inverse of that flow
fused.  ``kernel_variant(d, h, K)`` names the one a shape goes to:

- ``"specialized"``, ``csrc/ar_inverse.cu``: compile-time (d, h, K) at the
  solver's dim buckets (h = d/2, at least 8) and every knot count the JAX
  package's entry points use; 16 lanes a sample, the weights in shared
  memory by TMA (so they must be 16-byte aligned);
- ``"generic"``, ``csrc/ar_inverse_generic.cu``: every other d >= 1,
  h >= 1, K >= 2 at run time (another ``hidden_dim``,
  ``scale_hidden_with_dim=False``, ``pad_dim_multiple``, another
  ``num_knots``, the 256 dim bucket); a group of 8, 16 or 32 lanes a
  sample, the weights in shared memory by TMA where they fit, at any
  alignment (``ARInverseKernel.info`` reports how a shape launches).

A shape goes to exactly one of them (``launch`` names one, for checks
and timings).  The wrapper takes nothing but
contiguous float32 CUDA tensors, raises on anything else or on a failed
build or launch, and never falls back.  The libraries are built with
``nvcc`` at first use.

``flow_inverse_masked_plain`` / ``stack_inverse_masked_plain`` are the
same function in plain PyTorch (``nsf.flow_inverse_masked``); the model
layer sends CPU tensors there, and the tests and the card's smoke check
hold the kernels against it.
"""
from __future__ import annotations

import ctypes
import os
from collections import Counter
from typing import Dict, List

import torch

from ..utils.cuda_build import CSRC_DIR, build_shared_libs
from .nsf import (NSFConfig, flow_forward, flow_inverse_masked,
                  stack_inverse_masked)
from .rqs import BOUNDARY_RAW_DERIV

# (dim, hidden) pairs of the solver's power-of-two dim buckets at the
# default width (hidden = dim // 2, at least 8) and the knot counts the
# specialised kernel is instantiated for: every K the JAX package's entry
# points and tests use
SUPPORTED_DIM_HIDDEN = ((16, 8), (32, 16), (64, 32), (128, 64))
SUPPORTED_KNOTS = (5, 6, 7, 8, 9, 10, 12)
VARIANTS = ("specialized", "generic")
WEIGHTS = ("W1", "b1", "W2", "b2", "W3", "b3")
# what ``ARInverseKernel.info`` reports, in the C functions' order
INFO_FIELDS = ("registers", "local_bytes", "smem_bytes", "threads",
               "samples", "slots")


# the plain PyTorch versions: one flow, and the stack (last flow first)
flow_inverse_masked_plain = flow_inverse_masked
stack_inverse_masked_plain = stack_inverse_masked


def kernel_variant(d: int, h: int, K: int) -> str:
    """The kernel a flow of dim ``d``, conditioner width ``h`` and ``K``
    knots launches: "specialized" at an instantiation of
    ``csrc/ar_inverse.cu``, else "generic"; raises for a shape neither
    takes."""
    if d < 1 or h < 1 or K < 2:
        raise ValueError(f"ar_inverse kernel: no kernel for dim={d}, "
                         f"hidden={h}, knots={K} (dim >= 1, hidden >= 1, "
                         f"knots >= 2)")
    if (d, h) in SUPPORTED_DIM_HIDDEN and K in SUPPORTED_KNOTS:
        return "specialized"
    return "generic"


def _staging(slots: int, d: int) -> str:
    """How a kernel with ``slots`` weight slots at dim ``d`` holds the
    weights: the whole flow in shared memory, a ring, or through L2."""
    return "flow" if slots == d else ("ring" if slots else "l2")


class ARInverseKernel:
    """ctypes handles on the two built kernels, with one count of their
    launches by (variant, n, d, h, K) since the process began
    (``counts``).  From it: since the last ``reset_launches``,
    ``launches`` (all), ``variant_launches`` (by variant) and
    ``shape_launches`` (by (variant, d, h, K)); since the last
    ``clear_shapes``, the (variant, n, d, h, K) launched
    (``launched_shapes``, which the card's smoke check holds against the
    plain version)."""

    sources = {"specialized": os.path.join(CSRC_DIR, "ar_inverse.cu"),
               "generic": os.path.join(CSRC_DIR, "ar_inverse_generic.cu")}
    symbols = {"specialized": "nfisam_ar_inverse",
               "generic": "nfisam_ar_inverse_generic"}

    def __init__(self) -> None:
        self.counts: Counter = Counter()
        # ``counts`` at the last ``reset_launches`` / ``clear_shapes``
        self._launch_mark: Counter = Counter()
        self._shape_mark: Counter = Counter()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._circular: Dict[tuple, torch.Tensor] = {}

    def _since(self, mark: Counter) -> Dict[tuple, int]:
        return {k: c - mark.get(k, 0) for k, c in self.counts.items()
                if c > mark.get(k, 0)}

    @property
    def launches(self) -> int:
        return sum(self.counts.values()) - sum(self._launch_mark.values())

    @property
    def variant_launches(self) -> Dict[str, int]:
        out = dict.fromkeys(VARIANTS, 0)
        for (variant, *_), c in self._since(self._launch_mark).items():
            out[variant] += c
        return out

    @property
    def shape_launches(self) -> Dict[tuple, int]:
        out: Dict[tuple, int] = {}
        for (variant, _, d, h, K), c in self._since(
                self._launch_mark).items():
            out[(variant, d, h, K)] = out.get((variant, d, h, K), 0) + c
        return out

    @property
    def launched_shapes(self) -> set:
        return set(self._since(self._shape_mark))

    def reset_launches(self) -> None:
        """Count ``launches``, ``variant_launches`` and ``shape_launches``
        from zero again."""
        self._launch_mark = Counter(self.counts)

    def clear_shapes(self) -> None:
        """Gather ``launched_shapes`` from nothing again."""
        self._shape_mark = Counter(self.counts)

    def load(self) -> None:
        """Build (both sources at once, in parallel) and load the kernels."""
        if len(self._libs) == len(VARIANTS):
            return
        built = build_shared_libs(list(self.sources.values()))
        for variant, source in self.sources.items():
            lib = ctypes.CDLL(built[source][0])
            fn = getattr(lib, f"{self.symbols[variant]}_f32")
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
                [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            info = getattr(lib, f"{self.symbols[variant]}_info")
            info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            info.restype = ctypes.c_int
            self._libs[variant] = lib

    def info(self, d: int, h: int, K: int) -> Dict[str, object]:
        """Build facts of the kernel that (d, h, K) goes to, on the current
        card: its variant, registers and local (spill) bytes a thread,
        dynamic shared memory bytes, threads and samples a block, weight
        slots, lanes a sample (``group``) and how the weights are held
        (``staging``: "flow", "ring" or "l2")."""
        variant = kernel_variant(d, h, K)
        self.load()
        out = (ctypes.c_int * len(INFO_FIELDS))()
        err = getattr(self._libs[variant],
                      f"{self.symbols[variant]}_info")(d, h, K, out)
        if err != 0:
            raise RuntimeError(f"ar_inverse {variant} kernel: no build facts "
                               f"for d={d}, h={h}, K={K}: cudaError_t {err}")
        facts = dict(zip(INFO_FIELDS, out))
        return {"variant": variant, **facts,
                "group": facts["threads"] // facts["samples"],
                "staging": _staging(facts["slots"], d)}

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
        """One flow's masked inverse through the kernel ``kernel_variant``
        names; returns a new (n, dim) tensor."""
        return self.launch(params, z_full, x_prefix_full, invert_mask, cfg,
                           kernel_variant(cfg.dim, cfg.hidden_dim,
                                          cfg.num_knots))

    def launch(self, params: dict, z_full: torch.Tensor,
               x_prefix_full: torch.Tensor, invert_mask: torch.Tensor,
               cfg: NSFConfig, variant: str) -> torch.Tensor:
        """One flow's masked inverse through ``variant``: the generic
        kernel takes every shape, the specialised one its instantiations
        only.  The solver's paths call the wrapper; this names a variant
        for the checks and timings that compare the two."""
        d, h, K = cfg.dim, cfg.hidden_dim, cfg.num_knots
        if variant not in VARIANTS or (
                variant == "specialized" and
                kernel_variant(d, h, K) != "specialized"):
            raise ValueError(f"ar_inverse kernel: no {variant} kernel at "
                             f"d={d}, h={h}, K={K}")
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
            if variant == "specialized" and params[name].data_ptr() % 16:
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
        launch = getattr(self._libs[variant],
                         f"{self.symbols[variant]}_f32")
        err = launch(
            z_full.data_ptr(), x_prefix_full.data_ptr(), invert.data_ptr(),
            circular.data_ptr(), params["W1"].data_ptr(),
            params["b1"].data_ptr(), params["W2"].data_ptr(),
            params["b2"].data_ptr(), params["W3"].data_ptr(),
            params["b3"].data_ptr(), out.data_ptr(), n, d, h, K,
            float(cfg.tail_bound), BOUNDARY_RAW_DERIV, stream)
        if err != 0:
            raise RuntimeError(f"ar_inverse {variant} kernel launch failed "
                               f"at d={d}, h={h}, K={K}: cudaError_t {err}")
        self.counts[(variant, n, d, h, K)] += 1
        return out


ar_inverse_kernel = ARInverseKernel()


def stack_inverse_masked_cuda(flow_params: List[dict], z_full, x_prefix_full,
                              invert_mask, cfg: NSFConfig,
                              variant: str | None = None) -> torch.Tensor:
    """The stack inverse through the kernel (``kernel_variant``'s, or
    ``variant``): one launch per flow, last flow first."""
    variant = variant or kernel_variant(cfg.dim, cfg.hidden_dim,
                                        cfg.num_knots)
    x_full = z_full
    for params in reversed(flow_params):
        x_full = ar_inverse_kernel.launch(params, z_full, x_prefix_full,
                                          invert_mask, cfg, variant)
        z_full = x_full
    return x_full


def _forward_jacobians(params: dict, x: torch.Tensor,
                       cfg: NSFConfig) -> torch.Tensor:
    """Each row's Jacobian of one flow's forward, dz/dx (n, dim, dim):
    lower-triangular, since z_i depends on x_j for j <= i only."""
    def forward_row(row):
        return flow_forward(params, row[None], cfg)[0][0]

    with torch.enable_grad():
        return torch.func.vmap(torch.func.jacrev(forward_row))(x)


class MaskedStackInverse(torch.autograd.Function):
    """The masked AR inverse of a flow stack, differentiable in ``z_full``.

    Forward: ``inverse_fn`` one flow at a time, last flow first (the
    kernel on a card, the plain version on the CPU), keeping each flow's
    output.  Backward: the implicit-function VJP.  Flow k maps its output
    x to its input by its forward f (the pinned columns held at the
    prefix), so dx/dz = (df/dx)^-1 over the inverted columns, and
    dL/dz = (df/dx)^-T dL/dx: one triangular solve a row and a flow, from
    the first flow's output back to ``z_full``.  The pinned columns carry
    no gradient; the flow's parameters, the prefix and the mask take none.
    """

    @staticmethod
    def forward(ctx, z_full, x_prefix_full, invert_mask, flow_params, cfg,
                inverse_fn):
        outputs, x = [], z_full
        for params in reversed(flow_params):
            x = inverse_fn([params], x, x_prefix_full, invert_mask, cfg)
            outputs.append(x)
        ctx.save_for_backward(invert_mask, *outputs)
        ctx.flow_params, ctx.cfg = flow_params, cfg
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_x):
        invert_mask, *outputs = ctx.saved_tensors
        idx = torch.nonzero(invert_mask)[:, 0]
        g = grad_x[:, idx]
        # the first flow ran last: its output is outputs[-1]
        for params, x in zip(ctx.flow_params, reversed(outputs)):
            jac = _forward_jacobians(
                {k: v.detach() for k, v in params.items()}, x.detach(),
                ctx.cfg)[:, idx][:, :, idx]
            g = torch.linalg.solve_triangular(
                jac.transpose(1, 2), g[:, :, None], upper=True)[:, :, 0]
        grad_z = torch.zeros_like(grad_x)
        grad_z[:, idx] = g
        return grad_z, None, None, None, None, None


def stack_inverse_masked_differentiable(flow_params: List[dict], z_full,
                                        x_prefix_full, invert_mask,
                                        cfg: NSFConfig, inverse_fn):
    """``inverse_fn`` (``stack_inverse_masked_cuda`` or ``_plain``) with a
    gradient in ``z_full`` (``MaskedStackInverse``)."""
    return MaskedStackInverse.apply(z_full, x_prefix_full, invert_mask,
                                    flow_params, cfg, inverse_fn)
