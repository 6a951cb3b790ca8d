"""The port's CUDA kernels against their plain PyTorch versions, and the
paths around them (the fused posterior pass against the per-clique walk,
the batched trainer, the MAP solvers against themselves on the CPU), on
a card.  This file imports neither JAX nor the
JAX package, so it also runs
where JAX is not installed.  Every test carries the ``cuda`` marker and
skips without a card.  On a card: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_cuda.py`` (the tests'
``conftest.py`` imports JAX).
Tolerance: atol 1e-5, rtol 1e-5, as the JAX package's Pallas tests.

Run as a script on a card, ``python tests/test_torch_cuda.py``, it
diagnoses the banked MAP's repeatability at plaza1's truth (float64):
each part of an LM iteration repeated 50 times at one input, then the
truth floor solved in one process by the LM-CG loop as it was before the
repair (cuSPARSE's ``torch.mv``, autograd's gradient) four times, once
under ``torch.use_deterministic_algorithms(True)``, twice with a dense
``H @ v``, and three times as it is (``lm_cg_solve``)."""
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


def test_cuda_generator_seed_is_the_keys_64_bit_word(cuda):
    """The card's generator is seeded with ``hi << 32 | lo`` whole, so
    its Philox streams do not depend on the CPU's fold."""
    from nfisam_tpu_torch.utils.keys import generator_seed, torch_generator
    key = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    assert torch_generator(key, cuda).initial_seed() == \
        generator_seed(key, "cuda") == 0x12345678 << 32 | 0x9ABCDEF0
    chip_smoke.check_generator_seed(cuda)


def test_cuda_launch_counter_counts_each_flow(cuda):
    _, (cfg, params, z, xp, mask) = _case(
        ("two flows", 100, 16, 8, 9, 2, 3, ()))
    before = ar_inverse_kernel.launches
    by_shape = ar_inverse_kernel.shape_launches.get(
        ("specialized", 16, 8, 9), 0)
    stack_inverse_masked_cuda(params, z, xp, mask, cfg)
    assert ar_inverse_kernel.launches == before + 2
    assert ar_inverse_kernel.shape_launches[
        ("specialized", 16, 8, 9)] == by_shape + 2
    assert ar_inverse_kernel.counts[("specialized", 100, 16, 8, 9)] >= 2
    assert ("specialized", 100, 16, 8, 9) in \
        ar_inverse_kernel.launched_shapes


def test_cuda_kernel_raises_on_bad_inputs(cuda):
    _, (cfg, params, z, xp, mask) = _case(
        ("bad inputs", 100, 16, 8, 9, 1, 2, ()))
    before = ar_inverse_kernel.launches
    with pytest.raises(ValueError, match="float32"):
        ar_inverse_kernel(params[0], z.double(), xp, mask, cfg)
    wide = torch.zeros((100, 32), device=cuda)
    with pytest.raises(ValueError, match="non-contiguous"):
        ar_inverse_kernel(params[0], wide[:, ::2], xp, mask, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ar_inverse_kernel(params[0], z, xp, mask,
                          NSFConfig(dim=16, num_knots=1, hidden_dim=8))
    assert ar_inverse_kernel.launches == before


def test_cuda_each_shape_launches_one_kernel(cuda):
    """A specialised shape counts on the specialised kernel, any other
    on the generic one; the generic kernel takes weights off the 16-byte
    alignment (it reads them through the read-only cache)."""
    for case, variant in ((("spec", 64, 16, 8, 9, 1, 2, ()), "specialized"),
                          (("gen", 64, 16, 16, 9, 1, 2, ()), "generic")):
        (cfg, p_cpu, z_cpu, xp_cpu, m_cpu), (_, params, z, xp, mask) = \
            _case(case)
        before = dict(ar_inverse_kernel.variant_launches)
        stack_inverse_masked_cuda(params, z, xp, mask, cfg)
        after = ar_inverse_kernel.variant_launches
        assert after[variant] == before[variant] + 1
        assert sum(after.values()) == sum(before.values()) + 1
    t = params[0]["W1"]
    buf = torch.empty(t.numel() + 1, device=cuda)
    moved = buf[1:].view(t.shape)
    moved.copy_(t)
    got = ar_inverse_kernel({**params[0], "W1": moved}, z, xp, mask, cfg)
    ref = stack_inverse_masked_plain(p_cpu, z_cpu, xp_cpu, m_cpu, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("case", chip_smoke.GRAD_CASES,
                         ids=[c[0] for c in chip_smoke.GRAD_CASES])
def test_cuda_masked_inverse_gradient_matches_plain_autograd(cuda, case):
    """``MaskedStackInverse`` with the kernel's forward: its VJP against
    autograd through the plain inverse on the card, within GRAD_RTOL of
    each entry and of the largest."""
    from nfisam_tpu_torch.flows.ar_inverse import \
        stack_inverse_masked_differentiable
    _, (cfg, params, z, xp, mask) = _case(case)
    w = torch.randn(z.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    grads = []
    for run in (lambda zz: stack_inverse_masked_differentiable(
                    params, zz, xp, mask, cfg, stack_inverse_masked_cuda),
                lambda zz: stack_inverse_masked_plain(params, zz, xp, mask,
                                                      cfg)):
        zz = z.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((run(zz) * w).sum(), zz)
        grads.append(g)
    got, ref = grads
    tol = chip_smoke.GRAD_RTOL * (ref.abs() + ref.abs().max())
    assert bool(((got - ref).abs() <= tol).all())
    assert float(got[:, ~mask].abs().max()) == 0.0


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
            assert info["variant"] == "specialized"
            # the whole flow at d <= 32, else the largest ring that fits:
            # 3 slots at d=64 and at d=128 with K=5, 2 at d=128 above
            assert info["slots"] == {16: 16, 32: 32, 64: 3}.get(
                d, 3 if K == 5 else 2)
    generic = ar_inverse_kernel.info(16, 16, 9)
    assert generic["variant"] == "generic" and generic["local_bytes"] == 0


def test_cuda_build_facts_of_every_generic_instantiation(cuda):
    """Each of the generic kernel's nine instantiations (and every generic
    shape of the cases) runs without local memory, in whole warps of at
    most 256 threads, within one SM's shared memory."""
    from nfisam_tpu_torch.flows.ar_inverse import kernel_variant
    shapes = {c[2:5] for c in chip_smoke.KERNEL_CASES + chip_smoke.TIMED_CASES
              if kernel_variant(*c[2:5]) == "generic"}
    for d, h, K in sorted(shapes | set(chip_smoke.GENERIC_INSTANCES.values())):
        info = ar_inverse_kernel.info(d, h, K)
        assert info["variant"] == "generic" and info["local_bytes"] == 0
        assert info["threads"] % 32 == 0 and info["threads"] <= 256
        assert info["group"] in (8, 16, 32)
        assert info["group"] >= min(32, max(h, K))
        assert info["smem_bytes"] <= 232448, (d, h, K, info)


@pytest.mark.parametrize("seed", range(2))
def test_cuda_generic_takes_every_shape_the_first_port_took(cuda, seed):
    """The first generic kernel took every (d, h, K) whose four samples of
    d + 2h + 5K + 2 floats fit a block: each still gets a launch plan
    that fits (``info`` raises for a shape without one), and shapes out of
    the range still raise."""
    rng = np.random.default_rng(seed)
    shapes = [(14514, 1, 2), (1, 7257, 2), (1, 1, 2904)]
    while len(shapes) < 300:
        d, h, K = (int(rng.integers(1, 15000)), int(rng.integers(1, 7300)),
                   int(rng.integers(2, 3000)))
        if 16 * (d + 2 * h + 5 * K + 2) <= 232448:
            shapes.append((d, h, K))
    for d, h, K in shapes:
        info = ar_inverse_kernel.info(d, h, K)
        assert info["smem_bytes"] <= 232448 and info["samples"] >= 1
    for d, h, K in ((1, 20000, 2), (40000, 8, 9)):
        with pytest.raises(RuntimeError, match="no build facts"):
            ar_inverse_kernel.info(d, h, K)


def test_cuda_generic_matches_specialized_on_the_same_inputs(cuda):
    """The generic kernel launched by name at the specialised kernel's
    main shape agrees with it and with the plain version."""
    (cfg, params, z, xp, mask), on_card = _case(
        ("generic vs specialised", 1000, 16, 8, 9, 1, 2, (6,)))
    ref = stack_inverse_masked_plain(params, z, xp, mask, cfg).numpy()
    got = {v: stack_inverse_masked_cuda(*on_card[1:], cfg, v).cpu().numpy()
           for v in ("specialized", "generic")}
    np.testing.assert_allclose(got["generic"], ref, **TOL)
    np.testing.assert_allclose(got["generic"], got["specialized"], **TOL)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_cuda_generic_takes_weights_at_any_alignment(cuda, shift):
    """The generic kernel bulk-copies the 16-byte granules each weight
    array touches, so views at any 4-byte offset copy and agree."""
    (cfg, p_cpu, z_cpu, xp_cpu, m_cpu), (_, params, z, xp, mask) = _case(
        ("odd h*d", 300, 7, 5, 3, 1, 2, (4,)))
    moved = {}
    for k, (name, t) in enumerate(params[0].items()):
        buf = torch.empty(t.numel() + 8, device=cuda)
        off = (shift + k - buf.data_ptr() // 4) % 4
        moved[name] = buf[off:off + t.numel()].view(t.shape)
        moved[name].copy_(t)
    got = ar_inverse_kernel(moved, z, xp, mask, cfg)
    ref = stack_inverse_masked_plain(p_cpu, z_cpu, xp_cpu, m_cpu, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), **TOL)


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


def test_cuda_graphed_training_equals_eager(cuda, monkeypatch):
    """``train_flow`` with its loss and gradient replayed from a CUDA graph
    gives the eager loop's bits: parameters, loss curve and plateau stop,
    at the bench's d=16 and at the 32 bucket (h=16)."""
    from nfisam_tpu_torch.train import TrainConfig, fit_flow_raw, trainer

    tc = TrainConfig(max_iters=300, learning_rate=0.01, average_window=25,
                     loss_delta_tol=0.04)
    rng = np.random.default_rng(1)
    for d, h in ((16, 8), (32, 16)):
        cfg = NSFConfig(dim=d, num_knots=9, hidden_dim=h)
        raw = torch.as_tensor((rng.normal(size=(2000, d)) * rng.uniform(
            0.5, 30, d)).astype(np.float32), device=cuda)
        key, mask = np.array([3, d], np.uint32), np.zeros(d, bool)
        graphed = fit_flow_raw(key, raw, cfg, tc, mask)
        with monkeypatch.context() as mp:
            mp.setattr(trainer, "_GraphedLossGrad", lambda *a: None)
            eager = fit_flow_raw(key, raw, cfg, tc, mask)
        assert graphed[2] == eager[2] < 300
        assert torch.equal(graphed[1], eager[1])
        for a, b in zip(graphed[0], eager[0]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_cuda_plaza_prefix_step_is_repeatable(cuda):
    """One step of plaza1_ada0.4 through the plaza runner at its
    configuration (mode repair on), solved twice in one process: the same
    samples bit for bit, the same DA snapshot and kernel launches."""
    runs = []
    for _ in range(2):
        result, _, samples, _, _, solver, launches = chip_smoke.plaza_prefix(
            "plaza1_ada0.4", 1, cuda)
        runs.append((samples, result["hypo_curve"], launches))
    (a, hypo_a, n_a), (b, hypo_b, n_b) = runs
    assert set(a) == set(b) and n_a == n_b > 0 and hypo_a == hypo_b
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_cuda_manhattan_plaza_lone_fits_take_the_graphed_path(
        cuda, monkeypatch, tmp_path):
    """The manhattan_plaza runner's first 3 steps: every lone clique's fit
    (a bucket of one; 500 iterations, no held-out rows, no shard) captures
    its loss and gradient in a CUDA graph, one capture a fit."""
    from nfisam_tpu_torch.scripts import manhattan_plaza_run as mpr
    from nfisam_tpu_torch.train import trainer

    made = []

    class Counting(trainer._GraphedLossGrad):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)
    monkeypatch.setattr(trainer, "_GraphedLossGrad", Counting)
    _, _, _, solver = mpr.solve_manhattan_plaza(
        mpr.parse_args(["--limit-steps", "3", "--device", "cuda"]),
        str(tmp_path))
    lone = sum(1 for _, _, b in solver.bucket_log if b == 1)
    assert lone > 0 and len(made) == lone


def test_cuda_graph_captures_equal_the_lone_fits(cuda):
    """The tracer's ``graph_captures`` and ``train.capture`` spans on the
    card: one capture a lone fit (a bucket of one), none for a batched
    one, step by step."""
    import nfisam_tpu_torch.core as core
    import nfisam_tpu_torch.factors as factors
    from nfisam_tpu_torch.examples.toy_examples.five_node_range_incremental \
        import five_node_graph
    from nfisam_tpu_torch.parallel import ParallelNFiSAM
    from nfisam_tpu_torch.solver import NFiSAMArgs
    from nfisam_tpu_torch.utils.tracing import tracer

    solver = ParallelNFiSAM(NFiSAMArgs(
        posterior_sample_num=200, local_sample_num=400, flow_iterations=200,
        num_knots=8, learning_rate=0.03, elimination_method="pose_first",
        seed=1), device=cuda)
    lone_fits = 0
    for nodes, fs in five_node_graph(core, factors):
        for v in nodes:
            solver.add_node(v)
        for f in fs:
            solver.add_factor(f)
        logged = len(solver.bucket_log)
        solver.update_physical_and_working_graphs()
        row = tracer.rows[-1]
        solver.fit_tree_density_models()
        solver.sample_posterior()
        lone = sum(1 for _, _, b in solver.bucket_log[logged:] if b == 1)
        assert row.count("graph_captures") == row.calls("train.capture") \
            == lone
        assert row.count("cliques_trained") == len(
            solver._temp_training_loss)
        lone_fits += lone
    assert lone_fits > 0


def test_cuda_banked_floor_matches_the_cpu(cuda):
    """The banked NLL (rtol 1e-5) and its gradient (1e-4 of the largest
    entry, the CPU parity tests' tolerance) on the card and on the CPU at
    plaza1's first two steps' truth moved by 1-5 cm and a few mrad (at the
    truth itself the gradient is a float32 rounding of tight priors times
    their precision), and the truth-initialised floor's final NLL within
    1e-4 relative."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP
    from nfisam_tpu_torch.solver.banked_joint import _banked_nll

    nodes, truth, factors = graph_file_parser(chip_smoke.PLAZA1_FG)
    batches = group_nodes_factors_incrementally(nodes, factors, 5)[:2]
    vals = {}
    for dev in ("cpu", cuda):
        m = IncrementalGaussNewtonMAP(device=dev)
        m.update([n for ns, _ in batches for n in ns],
                 [f for _, fs in batches for f in fs])
        rng = np.random.default_rng(3)
        x = torch.as_tensor(np.concatenate(
            [np.asarray(truth[v], np.float64)[:v.dim] +
             rng.normal(size=v.dim) * np.array([0.03, 0.03, 0.003])[:v.dim]
             for v in m.vars]).astype(np.float32), device=dev)
        banks = m.banks.to_device(dev)
        g = torch.func.grad(lambda y: _banked_nll(y, banks))(x)
        vals[str(dev)] = (float(_banked_nll(x, banks)), g.cpu().numpy(),
                          chip_smoke.floor_from_truth(m, truth)["nll"])
    (n_c, g_c, f_c), (n_g, g_g, f_g) = vals["cpu"], vals[str(cuda)]
    assert abs(n_g - n_c) <= 1e-5 * abs(n_c), (n_g, n_c)
    np.testing.assert_allclose(g_g, g_c, rtol=1e-4,
                               atol=1e-4 * np.abs(g_c).max())
    assert abs(f_g - f_c) <= 1e-4 * abs(f_c), (f_g, f_c)


def test_cuda_laplace_map_matches_the_cpu(cuda):
    """GaussNewtonMAP on case1 from the truth on the card and the CPU: the
    MAP within 1e-4, the Laplace covariance rtol 1e-3."""
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.solver import GaussNewtonMAP

    nodes, truth, factors = graph_file_parser(chip_smoke.CASE1_FG)
    out = []
    for dev in ("cpu", cuda):
        m = GaussNewtonMAP(nodes, factors, device=dev)
        x0 = np.concatenate([np.asarray(truth[v], np.float32)[:v.dim]
                             for v in m.joint.vars])
        out.append(m.solve(x0=x0))
    (xc, cc, _, _), (xg, cg, _, _) = out
    np.testing.assert_allclose(xg, xc, atol=1e-4)
    np.testing.assert_allclose(cg, cc, rtol=1e-3,
                               atol=1e-3 * np.abs(cc).max())


def test_cuda_fixed_order_sums_match_autograd_and_cusparse(cuda):
    """The banked MAP's gradient and Hessian product, summed in a fixed
    order, against autograd's gradient and cuSPARSE's ``torch.mv`` at
    plaza1's first two steps (1e-12 of the largest entry, float64), and
    the same bits on every repeat."""
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally)
    from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP
    from nfisam_tpu_torch.solver import banked_joint as bj

    nodes, truth, factors = graph_file_parser(chip_smoke.PLAZA1_FG)
    batches = group_nodes_factors_incrementally(nodes, factors, 5)[:2]
    m = IncrementalGaussNewtonMAP(device=cuda)
    m.update([n for ns, _ in batches for n in ns],
             [f for _, fs in batches for f in fs])
    banks = m.banks.to_device(cuda, bj.MAP_DTYPE)
    x = torch.as_tensor(np.concatenate(
        [np.asarray(truth[v], np.float64)[:v.dim] for v in m.vars]) + 0.01,
        dtype=bj.MAP_DTYPE, device=cuda)
    v = torch.randn(x.shape, dtype=x.dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    hs = bj.SparseHessian(banks, m.dim)
    H = hs.at(x)
    g = torch.func.grad(lambda y: bj._banked_nll(y, banks))(x)
    assert float((hs.grad(x) - g).abs().max()) <= 1e-12 * float(
        g.abs().max())
    hv = torch.mv(H, v)
    assert float((hs.mv(H, v) - hv).abs().max()) <= 1e-12 * float(
        hv.abs().max())
    first = (hs.grad(x), hs.mv(H, v))
    for _ in range(5):
        assert torch.equal(hs.grad(x), first[0])
        assert torch.equal(hs.mv(H, v), first[1])


def test_cuda_cli_solve_runs_on_the_card(cuda, tmp_path):
    """``solve`` with no ``--device`` runs on the card and launches the
    kernel."""
    from nfisam_tpu_torch import cli
    from nfisam_tpu_torch.flows import ar_inverse_kernel

    ar_inverse_kernel.reset_launches()
    assert cli.main(["solve", "--fg", chip_smoke.CASE1_FG, "--out",
                     str(tmp_path), "--iters", "30", "--train-samples",
                     "300", "--posterior-samples", "200",
                     "--parallel"]) == 0
    assert ar_inverse_kernel.launches > 0
    assert np.isfinite(np.loadtxt(tmp_path / "run1" / "step5")).all()


def test_cuda_jax_checkpoint_restores_on_the_card(cuda, tmp_path):
    """The JAX package's case1 store restores on the card with no clique
    trained."""
    import shutil

    ckpt = tmp_path / "ckpt"
    shutil.copytree(chip_smoke.CASE1_JAX_CKPT, ckpt)
    _, steps, per_step, _ = chip_smoke.solve_case1(
        1, cuda, parallel=True, checkpoint_dir=str(ckpt),
        posterior_sample_num=200)
    assert [st["trained"] for st in steps] == [0] * 6
    assert all(st["launches"] > 0 for st in steps)
    for samples in per_step:
        assert all(np.isfinite(x).all() for x in samples.values())


def _flow_prior(device, obs_dim: int = 2):
    """A ``FlowsPriorFactor`` over [X1 (SE2), L1 (R2)] on a random 16-dim
    flow (K=9, h=8) with ``obs_dim`` observation columns pinned."""
    import nfisam_tpu_torch.core as core
    from nfisam_tpu_torch.flows import CliqueFlowModel
    from nfisam_tpu_torch.solver.nfisam import FlowsPriorFactor

    rng = np.random.default_rng(3)
    cfg = NSFConfig(dim=16, num_knots=9, hidden_dim=8)
    model = CliqueFlowModel(
        cfg, chip_smoke.random_flow(rng, 16, 8, 9, 1, device),
        torch.as_tensor(rng.normal(size=16).astype(np.float32), device=device),
        torch.as_tensor(rng.uniform(0.5, 2, 16).astype(np.float32),
                        device=device),
        [False] * 16, obs_dim + 5, pad_dims=4)
    return FlowsPriorFactor([core.SE2Variable("X1"), core.R2Variable("L1")],
                            model, rng.normal(size=obs_dim),
                            [False, False, True, False, False], lambda: None)


@pytest.mark.parametrize("n", [8, 25, 50])
def test_cuda_flow_prior_unif_to_sample_through_the_kernel(cuda, n):
    """Nested clique sampling's transform: one launch a call, and the
    plain inverse's numbers."""
    factor = _flow_prior(cuda)
    u = torch.as_tensor(np.random.default_rng(n).uniform(
        0.01, 0.99, (n, 5)).astype(np.float32), device=cuda)
    before = ar_inverse_kernel.launches
    got = factor.unif_to_sample(u)
    assert ar_inverse_kernel.launches == before + 1
    ref = factor._unif_to_sample(u, stack_inverse_masked_plain)
    assert got.shape == (n, 5) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, **TOL)


def test_cuda_batched_loglike_matches_rowwise(cuda):
    """``loglike_rows`` of every likelihood factor of case1_da (its
    ambiguous ranges take both sides of the 5-nat rule) equals
    ``evaluate_loglike`` row by row, and a CUDA graph's replay of the
    joint's likelihood equals the eager call bit for bit."""
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.samplers import StructuredJointFactor
    from nfisam_tpu_torch.utils.cuda_graph import CudaGraphed

    nodes, _, factors = graph_file_parser(os.path.join(
        chip_smoke.HERE, "data", "case1_da_factor_graph.fg"))
    joint = StructuredJointFactor(factors, nodes)
    u = torch.as_tensor(np.random.default_rng(0).uniform(
        0.01, 0.99, (64, joint.dim)).astype(np.float32), device=cuda)
    x = joint.ptform(u)
    for f in joint.likelihood_factors:
        xf = x[:, joint._index(f, cuda)]
        rows = torch.stack([f.evaluate_loglike(r) for r in xf])
        torch.testing.assert_close(f.loglike_rows(xf), rows, **TOL)
    graphed = CudaGraphed(lambda u: joint.loglike(joint.ptform(u)))
    eager = joint.loglike(joint.ptform(u))
    for _ in range(4):
        assert torch.equal(graphed(u), eager)


def test_cuda_one_ns_iteration(cuda):
    """One nested-sampling iteration on case1 on the card: the K worst
    retire, their refills lie above the threshold, and ncall is K a
    shrink step."""
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.samplers import StructuredJointFactor
    from nfisam_tpu_torch.samplers.nested import (HOST_READS, NestedConfig,
                                                  _Target,
                                                  build_ns_iteration)

    nodes, _, factors = graph_file_parser(chip_smoke.CASE1_FG)
    joint = StructuredJointFactor(factors, nodes)
    cfg = NestedConfig(n_live=200, replace_batch=8)
    target = _Target(joint.ptform, joint.loglike)
    U = torch.rand((200, joint.dim), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(0))
    L = target.like(U)
    it = build_ns_iteration(target, joint.dim, cfg)
    HOST_READS.clear()
    (U2, L2, logvol, logz, X_dead, L_dead, dead_idx, L_thresh,
     logz_remain, ncall) = it(np.array([0, 1], np.uint32), U, L,
                              torch.zeros((), device=cuda),
                              torch.full((), -1e30, device=cuda))
    assert ncall == 8 * HOST_READS["ns_shrink"] > 0
    assert X_dead.shape == (8, joint.dim)
    assert bool(torch.isfinite(L2).all())
    assert bool((L2[dead_idx] > L_thresh).all())
    assert float(L_thresh) == float(torch.sort(L).values[7])
    torch.testing.assert_close(L2[dead_idx], target.like(U2[dead_idx]),
                               **TOL)


# ------------------------------------------------- two gloo ranks on one card
def test_cuda_public_helpers_run_on_the_card(cuda):
    """The JAX package's last public helpers in the port
    (``tests/test_torch_helpers.py`` holds them against the JAX package on
    the CPU) on card tensors against the same call on the CPU: geometry
    and mixture densities to 1e-5, mixture and standard-normal draws in
    distribution (5 standard errors), ``fit_flow`` from ``init_params``
    (the graphed fit on the card, the eager one on the CPU) by its loss
    curve to rtol 1e-3."""
    from nfisam_tpu_torch.core import distributions, geometry
    from nfisam_tpu_torch.flows import nsf, normal_sample
    from nfisam_tpu_torch.train import TrainConfig, fit_flow
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32))
    for fn in (geometry.se2_grad_x_logmap, geometry.se2_grad_xi_expmap,
               geometry.se2_grad_det_grad_logmap):
        np.testing.assert_allclose(fn(p.to(cuda)).cpu().numpy(),
                                   fn(p).numpy(), **TOL)
    np.testing.assert_allclose(
        geometry.se2_chordal_dist(p.to(cuda), q.to(cuda)).cpu().numpy(),
        geometry.se2_chordal_dist(p, q).numpy(), **TOL)
    mix = distributions.GaussianMixtureDistribution(
        [0.3, 0.7], [np.zeros(3), np.ones(3) * 2.0],
        [np.eye(3), np.diag([0.5, 1.0, 2.0])])
    for method in (mix.log_pdf, mix.grad_x_log_pdf):
        np.testing.assert_allclose(method(q.to(cuda)).cpu().numpy(),
                                   method(q).numpy(), **TOL)
    n = 40000
    x = mix.rvs(np.array([1, 2], np.uint32), n, cuda).cpu().numpy()
    mean = 0.7 * np.ones(3) * 2.0
    var = np.array([0.3 * 1 + 0.7 * c for c in (0.5, 1.0, 2.0)]) + \
        0.3 * 0.7 * 4.0
    assert np.all(np.abs(x.mean(0) - mean) < 5 * np.sqrt(var / n))
    z = normal_sample(torch.Generator(device=cuda).manual_seed(3), (n, 2),
                      cuda).cpu().numpy()
    assert np.abs(z.mean(0)).max() < 5 / np.sqrt(n)
    cfg = nsf.NSFConfig(dim=3, num_knots=6, hidden_dim=8)
    start = nsf.init_flow_params(torch.Generator().manual_seed(1), cfg,
                                 "cpu")
    data = p / p.std(0)
    tc = TrainConfig(max_iters=40, learning_rate=0.01)
    on_card = fit_flow(np.array([0, 0], np.uint32), data.to(cuda), cfg, tc,
                       init_params=[{k: v.to(cuda) for k, v in f.items()}
                                    for f in start])
    on_cpu = fit_flow(np.array([0, 0], np.uint32), data, cfg, tc,
                      init_params=start)
    assert on_card[2] == on_cpu[2] == 40
    np.testing.assert_allclose(on_card[1].cpu().numpy(), on_cpu[1].numpy(),
                               rtol=1e-3)


def _ranks(name, tmp):
    """Case ``name`` of ``torch_rank_cases`` in 2 rank processes sharing
    the card (gloo through the host, a (1, 2) mesh)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_rank_cases
    return torch_rank_cases, torch_rank_cases.run_ranks(name, 2, tmp,
                                                        "cuda")


def test_two_ranks_train_chunked_is_bit_exact(cuda, tmp_path):
    """``train_chunked`` on 2 ranks of the card: each rank's chunk trains
    at the stack's width, so the gathered stacks equal
    ``fit_flows_batched`` on the whole stack bit for bit (a batched fit
    on a card depends on the loop's width, not on the other members)."""
    from nfisam_tpu_torch.train import fit_flows_batched
    cases, ranks = _ranks("chunked", tmp_path)
    cfg, tc, stack = cases.inputs("chunked", cuda)
    for B in (3, 4, 5):
        ref = fit_flows_batched(cases.keys(B), stack[:B], cfg, tc,
                                np.zeros((B, 4), bool))
        for rank in ranks:
            p, il, t, m, s = rank[B][:5]
            assert t == ref[2]
            for mine, theirs in zip(p, ref[0]):
                for k in theirs:
                    assert torch.equal(mine[k], theirs[k].cpu()), (B, k)
            for a, b in ((il, ref[1]), (m, ref[3]), (s, ref[4])):
                assert torch.equal(a, b.cpu())


def test_two_ranks_sharded_step_equals_world_one(cuda, tmp_path):
    """One sharded train step of 2 ranks (32 of 64 rows each, gradients
    summed over gloo) equals the world-1 step on the card within 1e-6."""
    from nfisam_tpu_torch.parallel import make_mesh
    cases, ranks = _ranks("step", tmp_path)
    (params, loss1), _ = cases.step_run(make_mesh(), cuda)
    for rank in ranks:
        (p, l1), _ = rank["first"], rank["last"]
        np.testing.assert_allclose(l1.numpy(), loss1.cpu().numpy(),
                                   atol=1e-6, rtol=1e-6)
        for mine, ref in zip(p, params):
            for k in ref:
                np.testing.assert_allclose(mine[k].numpy(),
                                           ref[k].cpu().numpy(), atol=1e-6,
                                           rtol=0)


def test_two_ranks_sharded_sampler_is_exact(cuda, tmp_path):
    """The sharded conditional sampler through the kernel on 2 ranks
    equals the world-1 draw bit for bit."""
    from nfisam_tpu_torch.parallel import (build_sharded_conditional_sampler,
                                           make_mesh)
    cases, ranks = _ranks("sampler", tmp_path)
    cfg, xp, z = cases.inputs("sampler", cuda)
    launches = ar_inverse_kernel.launches
    ref = build_sharded_conditional_sampler(cfg, make_mesh(), 2)(
        cases.sampler_params(cfg, cuda), xp, z).cpu()
    assert ar_inverse_kernel.launches > launches
    for rank in ranks:
        assert torch.equal(rank["out"], ref)


def test_two_ranks_sharded_fused_pass_is_bit_exact(cuda, tmp_path):
    """The fused pass of 2 ranks with ``sample_mesh`` (256 of 512 rows
    each, gathered) equals the world-1 solve's on the card bit for bit."""
    cases, ranks = _ranks("fused", tmp_path)
    ref, rows = cases.r2_graph_solve(cuda)
    assert rows == 512
    for rank in ranks:
        assert rank["shard_rows"] == 256
        for name, x in ref.items():
            assert torch.equal(rank["samples"][name], x), name


def _diagnose_map_repeatability(reps: int = 50) -> None:
    """The C1 diagnosis (module docstring)."""
    import time

    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP
    from nfisam_tpu_torch.solver import banked_joint as bj

    dev = torch.device("cuda")
    log = chip_smoke.log
    nodes, truth, factors = graph_file_parser(chip_smoke.PLAZA1_FG)
    m = IncrementalGaussNewtonMAP(device=dev)
    m.update(nodes, factors)
    banks = m.banks.to_device(dev, bj.MAP_DTYPE)
    cpu = torch.Generator().manual_seed(0)
    x = torch.as_tensor(np.concatenate(
        [np.asarray(truth[v], np.float64)[:v.dim] for v in m.vars]),
        dtype=bj.MAP_DTYPE)
    x = (x + 1e-3 * torch.randn(x.shape, generator=cpu,
                                dtype=x.dtype)).to(dev)
    v = torch.randn(x.shape, generator=cpu, dtype=x.dtype).to(dev)
    hs = bj.SparseHessian(banks, m.dim)
    autograd = torch.func.grad(lambda y: bj._banked_nll(y, banks))
    H = hs.at(x)
    Hd = H.to_dense()

    def repeat(name, fn):
        ref, bad, worst = fn(), 0, 0.0
        for _ in range(reps):
            out = fn()
            if not torch.equal(out, ref):
                bad += 1
                worst = max(worst, float((out - ref).abs().max()))
        log(f"C1 {name}: {bad} of {reps} repeats differ from the first "
            f"(max |diff| {worst:.3e})")

    repeat("autograd gradient of the gathers", lambda: autograd(x))
    repeat("fixed-order gradient", lambda: hs.grad(x))
    repeat("Hessian assembly", lambda: hs.at(x).values())
    repeat("cuSPARSE torch.mv", lambda: torch.mv(H, v))
    repeat("fixed-order CSR product", lambda: hs.mv(H, v))
    repeat("dense H @ v", lambda: Hd @ v)

    def before_repair(x0, banks, max_iters, dense=False):
        """``lm_cg_solve`` as it was: autograd's gradient and cuSPARSE's
        product (or a dense one)."""
        def nll(y):
            return bj._banked_nll(y, banks)
        grad_fn = torch.func.grad(nll)
        hessian = bj.SparseHessian(banks, x0.shape[0])
        x, it = x0, 0
        lam = torch.tensor(bj.MAP_INIT_DAMPING, dtype=x0.dtype,
                           device=x0.device)
        f_val = nll(x)
        while it < max_iters:
            H = hessian.at(x)
            if dense:
                H = H.to_dense()
            x_new = x + bj.conjugate_gradient(
                lambda p, H=H, lam=lam: torch.mv(H, p) + lam * p,
                -grad_fn(x), bj.MAP_CG_ITERS)
            f_new = nll(x_new)
            better = f_new < f_val
            done = better & (torch.abs(f_val - f_new) <
                             bj.MAP_TOL * (1.0 + torch.abs(f_val)))
            x = torch.where(better, x_new, x)
            lam = torch.clamp(torch.where(
                better, lam * bj.MAP_DAMPING_DOWN,
                lam * bj.MAP_DAMPING_UP), 1e-10, 1e10)
            f_val = torch.where(better, f_new, f_val)
            it += 1
            if bool(done):
                break
        return x, f_val, it

    def floor(label):
        t0 = time.perf_counter()
        r = chip_smoke.map_case(chip_smoke.REPEAT_MAP_CASE,
                                graph_file_parser,
                                lambda: IncrementalGaussNewtonMAP(device=dev))
        log(f"C1 floor [{label}]: RMSE {r['rmse']!r} m, NLL {r['nll']!r}, "
            f"{r['iters']} LM iterations, solve {r['s']:.3f} s "
            f"({time.perf_counter() - t0:.3f} s with parsing)")

    repaired = bj.lm_cg_solve
    bj.lm_cg_solve = before_repair
    for label in ("warm-up", "1", "2", "3"):
        floor(f"before the repair: {label}")
    torch.use_deterministic_algorithms(True)
    floor("before the repair, use_deterministic_algorithms")
    torch.use_deterministic_algorithms(False)
    bj.lm_cg_solve = lambda x0, b, n: before_repair(x0, b, n, dense=True)
    for label in ("1", "2"):
        floor(f"before the repair with a dense H @ v: {label}")
    bj.lm_cg_solve = repaired
    for label in ("1", "2", "3"):
        floor(f"as it is: {label}")


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    _diagnose_map_repeatability()
