"""The JAX package's flow options in the port, against the JAX package on
the CPU: the validation-based stop of the trainer (single fit and batched,
member by member), the dim bucketing and conditioner width
(``_dim_bucket``, ``effective_hidden_dim``), the kernel a shape goes to
(``kernel_variant``), and a small solve with every option set, in
distribution.  The plain inverse at the shapes these options reach is
held against the Pallas kernel in ``test_torch_ar_inverse_shapes.py``.

Run as a script, ``python tests/test_torch_flow_options.py``, it solves
case1 with the JAX package on the CPU at phase 23's options and prints
each solve's mean joint MMD (``chip_smoke.JAX_OPTIONS_MMD_WORST``)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from nfisam_tpu.flows.nsf import NSFConfig as JNSFConfig  # noqa: E402
from nfisam_tpu.flows.nsf import init_flow_params as j_init_flow_params  # noqa: E402
from nfisam_tpu.solver.nfisam import NFiSAM as JNFiSAM  # noqa: E402
from nfisam_tpu.solver.nfisam import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu.solver.nfisam import (  # noqa: E402
    effective_hidden_dim as j_effective_hidden_dim)
from nfisam_tpu.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from nfisam_tpu.train.trainer import _cached_program  # noqa: E402
from nfisam_tpu_torch.flows import NSFConfig, flow_params_from_numpy  # noqa: E402
from nfisam_tpu_torch.flows.ar_inverse import (SUPPORTED_DIM_HIDDEN,  # noqa: E402
                                               SUPPORTED_KNOTS,
                                               kernel_variant)
from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs, effective_hidden_dim  # noqa: E402
from nfisam_tpu_torch.train import (TrainConfig, fit_flow_raw,  # noqa: E402
                                    fit_flows_batched, train_flow,
                                    train_flows_batched)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------- the validation stop
def _split_data(n_train, n_test, d=6, seed=0):
    """A curved, correlated target, normalized, as a small training set
    (so that the held-out loss turns up) and a held-out set."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    a = rng.normal(size=(n, 2))
    x = np.column_stack([a[:, 0], a[:, 1] + 0.5 * a[:, 0] ** 2,
                         np.sin(a[:, 0]) + 0.1 * rng.normal(size=n),
                         rng.normal(size=(n, d - 3))])
    x = ((x - x.mean(0)) / x.std(0)).astype(np.float32)
    return x[:n_train], x[n_train:]


def _configs(max_iters, d=6, lr=0.015):
    jcfg = JNSFConfig(dim=d, num_knots=9, hidden_dim=8)
    cfg = NSFConfig(dim=d, num_knots=9, hidden_dim=8)
    kw = dict(max_iters=max_iters, learning_rate=lr, average_window=10,
              loss_delta_tol=0.05, validation_interval=10,
              slower_stop_rate=2.0, training_set_frac=0.5)
    return jcfg, cfg, JTrainConfig(**kw), TrainConfig(**kw)


def _carried(jparams):
    return flow_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_validation_stop_lands_on_the_same_iteration(seed):
    """JAX's compiled loop with a held-out set (``_build_train_program(cfg,
    tc, True)``) and the port's ``train_flow`` from the same init on the
    same train and held-out arrays: the first iterations' losses agree to
    1e-5, and the slower stop lands on the same iteration, well before
    the budget (the plateau rule, whose tolerance 0.05 would stop the
    curve sooner, is off)."""
    jcfg, cfg, jtc, tc = _configs(400)
    train, test = _split_data(40, 200, seed=seed)
    jparams = j_init_flow_params(jax.random.PRNGKey(seed + 3), jcfg)
    _, jloss, jt = _cached_program(jcfg, jtc, True)(
        jparams, jnp.asarray(train), jnp.asarray(test))
    _, loss, t = train_flow(_carried(jparams), torch.as_tensor(train), cfg,
                            tc, torch.as_tensor(test))
    jloss, jt = np.asarray(jloss), int(jt)
    np.testing.assert_allclose(loss.numpy()[:10], jloss[:10], **TOL)
    assert t == jt and 20 < t < 400
    # the stopping iteration skips its update and repeats the last loss
    assert loss[t - 1] == loss[t - 2]


def test_validation_stop_runs_to_max_iters_when_the_loss_keeps_falling():
    """Plenty of training data: the held-out loss does not turn up within
    the budget, so neither loop stops early."""
    jcfg, cfg, jtc, tc = _configs(60)
    train, test = _split_data(600, 300)
    jparams = j_init_flow_params(jax.random.PRNGKey(5), jcfg)
    _, _, jt = _cached_program(jcfg, jtc, True)(
        jparams, jnp.asarray(train), jnp.asarray(test))
    _, _, t = train_flow(_carried(jparams), torch.as_tensor(train), cfg, tc,
                         torch.as_tensor(test))
    assert t == int(jt) == 60


def test_batched_validation_stop_follows_each_member():
    """``train_flows_batched`` with held-out sets against the JAX
    package's single-clique program run member by member (``vmap`` of
    its loop is that loop per member): each member's first losses agree
    to 1e-5 and each stops where its own fit stops, though the members
    stop at different iterations."""
    jcfg, cfg, jtc, tc = _configs(400)
    members = [(0, 3), (1, 4), (2, 5)]
    inits, trains, tests, jts, jlosses = [], [], [], [], []
    for data_seed, key in members:
        train, test = _split_data(40, 200, seed=data_seed)
        jparams = j_init_flow_params(jax.random.PRNGKey(key), jcfg)
        _, jloss, jt = _cached_program(jcfg, jtc, True)(
            jparams, jnp.asarray(train), jnp.asarray(test))
        inits.append(jparams)
        trains.append(train)
        tests.append(test)
        jts.append(int(jt))
        jlosses.append(np.asarray(jloss))
    params = [{name: torch.as_tensor(np.stack([np.asarray(p[f][name])
                                               for p in inits]))
               for name in inits[0][f]} for f in range(len(inits[0]))]
    _, loss, t = train_flows_batched(
        params, torch.as_tensor(np.stack(trains)), cfg, tc,
        torch.as_tensor(np.stack(tests)))
    assert t == jts and len(set(jts)) > 1
    np.testing.assert_allclose(loss.numpy()[:, :10],
                               np.stack(jlosses)[:, :10], **TOL)


def test_fit_shuffles_and_splits_as_the_jax_fit():
    """``fit_flow_raw`` and ``fit_flows_batched`` with
    ``training_set_frac`` < 1: the normalizer is over all the samples
    (the shuffle does not move it), a held-out part exists, and the
    batched fit of one member equals the single fit from the same key."""
    rng = np.random.default_rng(3)
    raw = (rng.normal(size=(300, 4)) * [30, 2, 0.1, 5] +
           [90, -30, 1.0, 0]).astype(np.float32)
    cfg = NSFConfig(dim=4, num_knots=9, hidden_dim=8)
    tc = TrainConfig(max_iters=200, learning_rate=0.05,
                     validation_interval=10, training_set_frac=0.2)
    key = np.array([1, 2], np.uint32)
    circ = [False, False, True, False]
    params, loss, t, mean, std = fit_flow_raw(key, torch.as_tensor(raw),
                                              cfg, tc, circ)
    assert 10 < t < 200
    np.testing.assert_allclose(mean.numpy()[[0, 1, 3]],
                               raw.mean(0)[[0, 1, 3]], rtol=1e-4)
    b_params, b_loss, b_t, b_mean, _ = fit_flows_batched(
        key[None], torch.as_tensor(raw[None]), cfg, tc,
        np.asarray([circ]))
    assert b_t == [t]
    np.testing.assert_allclose(b_loss[0, :t].numpy(), loss[:t].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_args_pass_the_validation_fields_through():
    args = NFiSAMArgs(training_set_frac=0.9, validation_interval=5,
                      slower_stop_rate=3.0)
    tc = args.train_config()
    assert (tc.training_set_frac, tc.validation_interval,
            tc.slower_stop_rate) == (0.9, 5, 3.0)
    assert args.host_parallel == "auto"
    assert args.data_parallel_mesh is None and args.sample_mesh is None


# -------------------------------------------- bucketing and the kernel
OPTIONS = [dict(), dict(pad_dim_multiple=4), dict(pad_dim_multiple=1),
           dict(pad_dim_multiple=8, hidden_dim=16),
           dict(dim_bucket_floor=128), dict(dim_bucket_floor=1),
           dict(dim_bucket_floor=0), dict(scale_hidden_with_dim=False),
           dict(hidden_dim=16), dict(hidden_dim=4,
                                     scale_hidden_with_dim=False)]


@pytest.mark.parametrize("opts", OPTIONS, ids=[
    ",".join(f"{k}={v}" for k, v in o.items()) or "defaults"
    for o in OPTIONS])
def test_dim_bucket_and_hidden_width_match_jax(opts, monkeypatch):
    """Every aug dim 1-130 under each option: the padded dim and the
    conditioner width the port's solver gives a clique are the JAX
    package's."""
    monkeypatch.setenv("NFISAM_PREWARM", "0")
    ours = NFiSAM(NFiSAMArgs(**opts), device="cpu")
    theirs = JNFiSAM(JNFiSAMArgs(**opts))
    for aug in range(1, 131):
        assert ours._dim_bucket(aug) == theirs._dim_bucket(aug), aug
        padded = ours._dim_bucket(aug)
        assert effective_hidden_dim(ours._args, padded) == \
            j_effective_hidden_dim(theirs._args, padded)
        assert repr(ours._flow_config(padded, [False] * padded)) == \
            repr(theirs._flow_config(padded, [False] * padded))


def test_kernel_variant_routes_every_shape_to_one_kernel():
    """The solver's dim buckets at the default width and the JAX
    package's knot counts go to the specialised kernel, every other
    shape to the generic one; a shape neither takes raises."""
    for d in range(1, 140):
        for h in (1, 4, 8, 16, 32, 64, 100):
            for K in (2, 5, 6, 7, 8, 9, 10, 11, 12, 20):
                want = "specialized" if (d, h) in SUPPORTED_DIM_HIDDEN and \
                    K in SUPPORTED_KNOTS else "generic"
                assert kernel_variant(d, h, K) == want
    assert kernel_variant(128, 64, 9) == "specialized"
    assert kernel_variant(16, 16, 9) == "generic"
    for bad in ((0, 8, 9), (16, 0, 9), (16, 8, 1)):
        with pytest.raises(ValueError, match="no kernel"):
            kernel_variant(*bad)


# ------------------------------------------------- a solve with them all
OPTION_ARGS = dict(posterior_sample_num=1000, local_sample_num=600,
                   flow_iterations=400, num_knots=6, learning_rate=0.03,
                   elimination_method="natural", seed=7, mode_repair=False,
                   pad_dim_multiple=4, hidden_dim=4,
                   scale_hidden_with_dim=False, training_set_frac=0.8)
# the loop graph's exact posterior: X0 and X1 means, every variance 1/6
LOOP_MEANS = {"X0": (1 / 15, 0.0), "X1": (17 / 15, 1.0)}
LOOP_VAR = 1 / 6


def _solve_loop(core, factors, solver):
    """The loop graph of ``test_solver_e2e.test_nested_clique_training_path``
    (an extra prior on X1 closes a loop; here by direct simulation with
    the prior as an observation column) through ``solver``."""
    xs = [core.R2Variable(f"X{i}") for i in range(2)]
    cov = np.eye(2) * 0.25
    for x in xs:
        solver.add_node(x)
    solver.add_factor(factors.UnaryR2GaussianPriorFactor(
        xs[0], np.zeros(2), covariance=cov))
    solver.add_factor(factors.R2RelativeGaussianLikelihoodFactor(
        xs[0], xs[1], np.array([1.0, 1.0]), covariance=cov))
    solver.add_factor(factors.UnaryR2GaussianPriorFactor(
        xs[1], np.array([1.2, 1.0]), covariance=cov))
    solver.update_physical_and_working_graphs()
    samples = solver.incremental_inference()
    return {str(v.name): np.asarray(x.cpu() if torch.is_tensor(x) else x)
            for v, x in samples.items()}


def test_solve_with_every_option_matches_jax_in_distribution(monkeypatch):
    """``pad_dim_multiple=4``, ``hidden_dim=4`` with
    ``scale_hidden_with_dim=False`` and ``training_set_frac=0.8``: the
    clique's flow is (dim 8, hidden 4) in both packages, trained with the
    validation stop, and the posterior means agree within 0.15 m and sit
    within 0.2 m of the exact ones, the variances within 40% of the exact
    1/6 (1000 draws of a flow fitted to 480 samples)."""
    import nfisam_tpu.core as jcore
    import nfisam_tpu.factors as jfactors
    import nfisam_tpu_torch.core as tcore
    import nfisam_tpu_torch.factors as tfactors

    monkeypatch.setenv("NFISAM_PREWARM", "0")
    ours = NFiSAM(NFiSAMArgs(**OPTION_ARGS), device="cpu")
    theirs = JNFiSAM(JNFiSAMArgs(**OPTION_ARGS))
    got = _solve_loop(tcore, tfactors, ours)
    want = _solve_loop(jcore, jfactors, theirs)
    for solver in (ours, theirs):
        (adapter,) = solver._clique_density_model.values()
        assert (adapter.model.cfg.dim, adapter.model.cfg.hidden_dim) == \
            (8, 4)
    (n_iters,) = [int(t) for _, t in ours._temp_training_loss.values()]
    assert n_iters < OPTION_ARGS["flow_iterations"]
    for name, exact in LOOP_MEANS.items():
        np.testing.assert_allclose(got[name].mean(0), want[name].mean(0),
                                   atol=0.15)
        np.testing.assert_allclose(got[name].mean(0), exact, atol=0.2)
        np.testing.assert_allclose(got[name].var(0), LOOP_VAR, rtol=0.4)



def test_chip_smoke_options_path_runs_on_cpu(tmp_path):
    """Phase 23's command-line path on the CPU at a small size: the
    validation stop ends every clique's training early, and the run's
    per-step samples read back for the MMD gate."""
    import chip_smoke

    _, per_step, iters, _ = chip_smoke.solve_case1_options(
        1, "cpu", str(tmp_path), ["--iters", "200", "--train-samples",
                                  "300", "--posterior-samples", "200"])
    assert len(per_step) == 6
    assert all(t < 200 for step in iters for t in step)
    nodes = {n for step in per_step for n in step}
    assert all(np.isfinite(s[n]).all() for s in per_step for n in s)
    assert {"X0", "L1"} <= nodes


def jax_options_reference():
    """The JAX package's case1 solves on the CPU behind phase 23's gates:
    its command line with ``chip_smoke.OPTIONS_ARGV`` for seeds 1-3, and
    its ``ParallelNFiSAM`` with each of ``chip_smoke.OPTION_SOLVES``, seed
    1, at the bench configuration; each one's mean joint MMD over steps
    0-5 (``chip_smoke.accuracy_gate``)."""
    import tempfile

    import chip_smoke
    from nfisam_tpu import cli as j_cli
    from nfisam_tpu.io import graph_file_parser as j_parse
    from nfisam_tpu.io import group_nodes_factors_incrementally as j_group
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel

    nodes, _, factors = j_parse(chip_smoke.CASE1_FG, "fg")
    name2dim = {str(v.name): v.dim for v in nodes}
    label = " ".join(chip_smoke.OPTIONS_ARGV)
    mmds = []
    for seed in chip_smoke.OPTIONS_SEEDS:
        with tempfile.TemporaryDirectory() as d:
            argv = chip_smoke.case1_options_argv(seed, d) + \
                ["--platform", "cpu", "--compile-cache", ""]
            assert j_cli.main(argv) == 0
            per_step, iters = chip_smoke.run_per_step(
                os.path.join(d, "run1"), name2dim)
        ours, ref, per = chip_smoke.accuracy_gate(per_step, name2dim)
        mmds.append(ours)
        print(f"JAX CLI case1 {label} seed {seed}: joint MMD {ours!r} "
              f"(reference run1 {ref!r}), per step "
              f"{[round(x, 4) for x in per]}, Adam iterations {iters}",
              flush=True)
    print(f"worst over seeds {chip_smoke.OPTIONS_SEEDS}: {max(mmds)!r}",
          flush=True)
    for label, overrides in chip_smoke.OPTION_SOLVES.items():
        solver = JParallel(JNFiSAMArgs(**{**chip_smoke.BENCH_ARGS,
                                          **overrides, "seed": 1}))
        per_step = []
        for ns, fs in j_group(nodes, factors, incremental_step=1):
            for n in ns:
                solver.add_node(n)
            for f in fs:
                solver.add_factor(f)
            solver.update_physical_and_working_graphs()
            samples = solver.incremental_inference()
            per_step.append({str(v.name): np.asarray(x)
                             for v, x in samples.items()})
        ours, ref, per = chip_smoke.accuracy_gate(per_step, name2dim)
        print(f"JAX ParallelNFiSAM case1 {label} seed 1: joint MMD "
              f"{ours!r}, per step {[round(x, 4) for x in per]}, buckets "
              f"{sorted(set((d, n) for d, n, _ in solver.bucket_log))}",
              flush=True)


if __name__ == "__main__":
    jax_options_reference()
