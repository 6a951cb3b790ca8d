"""The port's CUDA kernels against their plain PyTorch versions, and the
paths around them (the fused posterior pass against the per-clique walk,
the batched trainer), on a card.  This file imports neither JAX nor the
JAX package, so it also runs
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


@pytest.mark.parametrize("d,h", [(16, 8), (32, 16), (64, 32)])
@pytest.mark.parametrize("K", [5, 6, 8, 10])
def test_cuda_added_knot_counts_match_plain(cuda, d, h, K):
    """The knot counts added beside 7/9/12 (the JAX package's entry points
    and tests use them), at every dim bucket, with a circular column."""
    (cfg, params, z, xp, mask), on_card = _case(
        (f"K{K} d{d}", 300, d, h, K, 1, 3, (d - 2,)), seed=K)
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
                          NSFConfig(dim=16, num_knots=11, hidden_dim=8))
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


def test_cuda_fused_pass_equals_per_clique_walk(cuda):
    """On a small solved case (two robots of three poses), the fused
    posterior pass and the per-clique walk, from the same key stream,
    agree within 1e-6 of the samples' scale, and both launch the
    kernel."""
    small = dict(local_sample_num=300, flow_iterations=40,
                 posterior_sample_num=500)
    _, _, solver = chip_smoke.solve_robots(cuda, True, R=2, T=3, **small)
    before = ar_inverse_kernel.launches
    rel, _, _ = chip_smoke.fused_vs_per_clique(solver)
    assert rel <= 1e-6
    # two rounds of both passes, one launch a clique each
    assert ar_inverse_kernel.launches - before == \
        4 * len(solver.physical_bayes_tree.clique_nodes)


def test_cuda_batched_trainer_follows_single_fits(cuda):
    """``fit_flows_batched`` on the card: each member's first iterations
    follow its own ``fit_flow_raw`` (rounding may differ on the card, so
    1e-4 relative over 5 iterations), and every member trains."""
    from nfisam_tpu_torch.flows import NSFConfig
    from nfisam_tpu_torch.train import (TrainConfig, fit_flow_raw,
                                        fit_flows_batched)
    d, B = 16, 4
    cfg = NSFConfig(dim=d, num_knots=9, hidden_dim=8)
    tc = TrainConfig(max_iters=120, learning_rate=0.025, average_window=20,
                     loss_delta_tol=0.02)
    rng = np.random.default_rng(0)
    raw = torch.as_tensor((rng.normal(size=(B, 500, d)) *
                           rng.uniform(0.5, 30, (B, 1, d))).astype(
                               np.float32), device=cuda)
    keys = np.array([[5, b] for b in range(B)], np.uint32)
    masks = np.zeros((B, d), bool)
    params, loss, t, mean, std = fit_flows_batched(keys, raw, cfg, tc, masks)
    assert params[0]["W3"].shape == (B, d, 27, 8)
    assert loss.shape == (B, 120) and mean.shape == std.shape == (B, d)
    for b in range(B):
        _, loss1, _, _, _ = fit_flow_raw(keys[b], raw[b], cfg, tc, masks[b])
        np.testing.assert_allclose(loss[b, :5].cpu().numpy(),
                                   loss1[:5].cpu().numpy(), rtol=1e-4)
        assert 40 < t[b] <= 120
        assert float(loss[b, t[b] - 1]) < float(loss[b, 0])
