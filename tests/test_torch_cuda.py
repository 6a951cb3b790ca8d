"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  This file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed.  Every test carries the ``cuda`` marker and
skips without a card.  On a card: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_cuda.py`` (the tests'
``conftest.py`` imports JAX).
Tolerance: atol 1e-5, rtol 1e-5, as the JAX package's Pallas tests."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from nfisam_tpu_torch.flows import (NSFConfig, ar_inverse_kernel,  # noqa: E402
                                    stack_inverse_masked_cuda,
                                    stack_inverse_masked_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip when this host has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _case(case, seed=0):
    """(cfg, params, z, x_prefix, mask) on the CPU and on the card."""
    cpu = chip_smoke.make_case(case, "cpu", seed)
    cfg, params, z, xp, mask = cpu
    dev = torch.device("cuda")
    return cpu, (cfg, [{k: v.to(dev) for k, v in p.items()} for p in params],
                 z.to(dev), xp.to(dev), mask.to(dev))


@pytest.mark.parametrize("case", chip_smoke.KERNEL_CASES,
                         ids=[c[0] for c in chip_smoke.KERNEL_CASES])
def test_cuda_kernel_matches_plain(cuda, case):
    (cfg, params, z, xp, mask), on_card = _case(case)
    ref = stack_inverse_masked_plain(params, z, xp, mask, cfg)
    got = stack_inverse_masked_cuda(*on_card[1:], cfg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), **TOL)


def test_cuda_launch_counter_counts_each_flow(cuda):
    _, (cfg, params, z, xp, mask) = _case(
        ("two flows", 100, 16, 8, 9, 2, 3, ()))
    before = ar_inverse_kernel.launches
    stack_inverse_masked_cuda(params, z, xp, mask, cfg)
    assert ar_inverse_kernel.launches == before + 2


def test_cuda_kernel_raises_on_bad_inputs(cuda):
    _, (cfg, params, z, xp, mask) = _case(
        ("bad inputs", 100, 16, 8, 9, 1, 2, ()))
    before = ar_inverse_kernel.launches
    with pytest.raises(ValueError, match="float32"):
        ar_inverse_kernel(params[0], z.double(), xp, mask, cfg)
    wide = torch.zeros((100, 32), device=cuda)
    with pytest.raises(ValueError, match="non-contiguous"):
        ar_inverse_kernel(params[0], wide[:, ::2], xp, mask, cfg)
    with pytest.raises(ValueError, match="no instantiation"):
        ar_inverse_kernel(params[0], z, xp, mask,
                          NSFConfig(dim=16, num_knots=8, hidden_dim=8))
    assert ar_inverse_kernel.launches == before


def test_cuda_kernel_raises_on_misaligned_weights(cuda):
    """The kernel bulk-copies the weights, which needs 16-byte alignment:
    a view off that alignment is refused, not launched."""
    _, (cfg, params, z, xp, mask) = _case(
        ("misaligned", 100, 16, 8, 9, 1, 2, ()))
    before = ar_inverse_kernel.launches
    for name in ("W1", "b3"):
        t = params[0][name]
        buf = torch.empty(t.numel() + 1, device=cuda)
        moved = buf[1:].view(t.shape)
        moved.copy_(t)
        with pytest.raises(ValueError, match="16-byte"):
            ar_inverse_kernel({**params[0], name: moved}, z, xp, mask, cfg)
    assert ar_inverse_kernel.launches == before


def test_cuda_build_facts_of_every_instantiation(cuda):
    """Every instantiation runs without spills in one block of 128
    threads, and its dynamic shared memory fits one SM."""
    from nfisam_tpu_torch.flows.ar_inverse import (SUPPORTED_DIM_HIDDEN,
                                                   SUPPORTED_KNOTS)
    for d, h in SUPPORTED_DIM_HIDDEN:
        for K in SUPPORTED_KNOTS:
            info = ar_inverse_kernel.info(d, h, K)
            assert info["local_bytes"] == 0, (d, h, K, info)
            assert info["threads"] == 128 and info["smem_bytes"] <= 232448
            assert info["slots"] == (d if d < 64 else 3)


def test_cuda_model_draws_through_the_kernel(cuda):
    """A clique model on the card samples through the kernel, one launch
    per flow per draw."""
    from nfisam_tpu_torch.flows import CliqueFlowModel
    (cfg, params, _, _, _), _ = _case(("model", 10, 16, 8, 9, 1, 0, ()))
    model = CliqueFlowModel(
        cfg, [{k: v.to(cuda) for k, v in p.items()} for p in params],
        torch.zeros(16, device=cuda), torch.ones(16, device=cuda),
        [False] * 16, aug_sep_dim=0)
    before = ar_inverse_kernel.launches
    x = model.conditional_sample(np.array([1, 2], np.uint32), 500)
    assert x.shape == (500, 16) and bool(torch.isfinite(x).all())
    assert ar_inverse_kernel.launches == before + 1
