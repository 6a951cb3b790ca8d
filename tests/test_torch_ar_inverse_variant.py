"""The AR-inverse wrapper's launch by named variant (``launch``, the
card's checks and timings), on the CPU: a variant without a kernel at the
shape raises before any device check, either kernel refuses CPU tensors,
and no refused launch counts.  The launch plan of the generic kernel is
its C side's alone (``make_plan`` in ``csrc/ar_inverse_generic.cu``,
reported by ``ARInverseKernel.info``); ``tests/test_torch_cuda.py`` holds
it on the card."""
import numpy as np
import pytest
import torch

from nfisam_tpu_torch.flows import NSFConfig, ar_inverse_kernel
from nfisam_tpu_torch.flows.ar_inverse import (kernel_variant,
                                               stack_inverse_masked_cuda)


def _flow(d, h, K):
    rng = np.random.default_rng(0)
    p = {"W1": rng.normal(size=(d, h, d)), "b1": rng.normal(size=(d, h)),
         "W2": rng.normal(size=(d, h, h)), "b2": rng.normal(size=(d, h)),
         "W3": rng.normal(size=(d, 3 * K, h)),
         "b3": rng.normal(size=(d, 3 * K))}
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}


def _call(shape, variant, stack):
    d, h, K = shape
    cfg = NSFConfig(dim=d, num_knots=K, hidden_dim=h)
    z = torch.zeros((4, d))
    mask = torch.ones(d, dtype=torch.bool)
    if stack:
        return stack_inverse_masked_cuda([_flow(d, h, K)], z, z, mask, cfg,
                                         variant)
    return ar_inverse_kernel.launch(_flow(d, h, K), z, z, mask, cfg, variant)


@pytest.mark.parametrize("shape,variant,stack,match", [
    ((16, 16, 9), "specialized", False, "no specialized kernel"),
    ((16, 16, 9), "bogus", False, "no bogus kernel"),
    ((16, 8, 9), "generic", False, "CUDA tensors only"),
    ((16, 8, 9), "specialized", False, "CUDA tensors only"),
    ((16, 8, 9), "generic", True, "CUDA tensors only"),
    ((7, 5, 3), "specialized", True, "no specialized kernel"),
], ids=["specialized-at-generic-shape", "unknown-variant",
        "generic-at-specialized-shape", "specialized", "stack-generic",
        "stack-specialized-at-generic-shape"])
def test_launch_by_named_variant_raises_before_counting(shape, variant,
                                                        stack, match):
    before = dict(ar_inverse_kernel.variant_launches)
    with pytest.raises(ValueError, match=match):
        _call(shape, variant, stack)
    assert ar_inverse_kernel.variant_launches == before


@pytest.mark.parametrize("shape", [(16, 8, 9), (16, 16, 9), (12, 8, 9),
                                   (128, 64, 12), (256, 128, 9)])
def test_the_wrapper_launches_what_kernel_variant_names(shape,
                                                        monkeypatch):
    """``__call__`` (the solver's paths) hands each shape to the kernel
    ``kernel_variant`` names."""
    d, h, K = shape
    chosen = []
    monkeypatch.setattr(ar_inverse_kernel, "launch",
                        lambda *args: chosen.append(args[-1]))
    cfg = NSFConfig(dim=d, num_knots=K, hidden_dim=h)
    z = torch.zeros((2, d))
    ar_inverse_kernel({}, z, z, torch.ones(d, dtype=torch.bool), cfg)
    assert chosen == [kernel_variant(d, h, K)]
    assert chosen[0] == ("specialized" if (d, h) in ((16, 8), (128, 64))
                         else "generic")
