"""Clique checkpoints in the port against the JAX package's: the store
round trip, a warm start that trains nothing, the clique signatures of
every case1 clique at every step (the two packages' stores hold the same
signatures with the same metadata), and a store the JAX package wrote
restored in the port with no clique trained, its flows drawing what the
JAX package's draw from the same base z (``DRAW_TOL``).

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py``,
it writes ``tests/torch_data/case1_jax_ckpt/``: the JAX package's
``ParallelNFiSAM`` store of case1 at ``chip_smoke.BENCH_ARGS`` (the
bench.py configuration, mode repair off), seed 1, which
``chip_smoke.py`` restores on the card."""
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from nfisam_tpu.flows import CliqueFlowModel as JModel  # noqa: E402
from nfisam_tpu.flows import NSFConfig as JConfig  # noqa: E402
from nfisam_tpu.flows import init_flow_params  # noqa: E402
from nfisam_tpu.flows.base_dist import BaseDistribution as JBase  # noqa: E402
from nfisam_tpu.flows.model import conditional_draw_core as j_draw  # noqa: E402
from nfisam_tpu.flows.nsf import stack_inverse_masked as j_inverse  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.solver import NFiSAM as JNFiSAM  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JArgs  # noqa: E402
from nfisam_tpu.solver.checkpoint import CliqueModelStore as JStore  # noqa: E402
import nfisam_tpu_torch.core as core  # noqa: E402
import nfisam_tpu_torch.factors as factors  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.parallel import ParallelNFiSAM  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.solver.checkpoint import CliqueModelStore  # noqa: E402

torch.set_num_threads(1)
# a restored model's draws against the JAX package's, in units of each
# column's normalizer std: the float32 spline inverses of the two packages
# part by up to 2.4e-4 of a std on 0-7 of a model's 4800 draws (the 99.9th
# percentile at most 3.7e-5), so 99.9% of the draws must agree within
# 1e-4 and every one within 1e-3
DRAW_TOL_999 = 1e-4
DRAW_TOL = 1e-3
JAX_CKPT = os.path.join(REPO, "tests", "torch_data", "case1_jax_ckpt")
SMALL = dict(posterior_sample_num=200, local_sample_num=300,
             flow_iterations=40, num_knots=9, learning_rate=0.025,
             hidden_dim=8, average_window=20, loss_delta_tol=0.04,
             elimination_method="pose_first", mode_repair=False, seed=1)


def _solve(solver, batches):
    """Per step: the cliques trained; the solver."""
    trained = []
    for ns, fs in batches:
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        solver.incremental_inference()
        trained.append(sorted(solver._temp_training_loss))
    return trained, solver


def _jax_case1(args, ckpt, parallel=True):
    nodes, _, fs = j_parse(chip_smoke.CASE1_FG, "fg")
    return _solve((JParallel if parallel else JNFiSAM)(
        JArgs(**args, checkpoint_dir=ckpt)),
        j_group(nodes, fs, incremental_step=1))


def _port_case1(args, ckpt, parallel=True):
    nodes, _, fs = graph_file_parser(chip_smoke.CASE1_FG)
    return _solve((ParallelNFiSAM if parallel else NFiSAM)(
        NFiSAMArgs(**args, checkpoint_dir=ckpt), device="cpu"),
        group_nodes_factors_incrementally(nodes, fs, 1))


# the flow options: another bucketing and width, and the validation split
OPTIONS = dict(pad_dim_multiple=4, hidden_dim=12,
               scale_hidden_with_dim=False, training_set_frac=0.8)


@pytest.fixture(scope="module",
                params=["parallel", "sequential", "parallel, flow options"])
def stores(request, tmp_path_factory):
    """case1 at SMALL (with ``OPTIONS`` where named) by both packages'
    ``ParallelNFiSAM`` or ``NFiSAM``, each into its own store."""
    parallel = request.param.startswith("parallel")
    args = {**SMALL, **OPTIONS} if "options" in request.param else SMALL
    jdir = str(tmp_path_factory.mktemp("jax_store"))
    tdir = str(tmp_path_factory.mktemp("port_store"))
    j_trained, j_solver = _jax_case1(args, jdir, parallel)
    t_trained, _ = _port_case1(args, tdir, parallel)
    return jdir, tdir, j_trained, t_trained, parallel, args


def test_store_round_trip(tmp_path):
    from nfisam_tpu_torch.flows import CliqueFlowModel, NSFConfig
    from nfisam_tpu_torch.flows.nsf import init_flow_params as t_init
    cfg = NSFConfig(dim=5, num_knots=6, hidden_dim=4)
    params = t_init(torch.Generator().manual_seed(3), cfg, "cpu")
    model = CliqueFlowModel(cfg, params, torch.zeros(5), torch.ones(5),
                            [False] * 5, 2, pad_dims=1, content_tag="t1")
    store = CliqueModelStore(str(tmp_path), "cpu")
    store.save("abc123", model)
    assert "abc123" in store
    loaded = CliqueModelStore(str(tmp_path), "cpu").load("abc123")
    assert loaded.cfg == cfg and loaded.aug_sep_dim == 2
    assert loaded.pad_dims == 1 and loaded.content_tag == "t1"
    for a, b in zip(model.flow_params, loaded.flow_params):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert store.load("missing") is None


def test_store_reads_the_jax_package_store(tmp_path):
    cfg = JConfig(dim=6, num_knots=9, hidden_dim=8, circular=(
        False, False, True, False, False, False))
    params = init_flow_params(jax.random.PRNGKey(0), cfg)
    model = JModel(cfg, params, np.arange(6, dtype=np.float32),
                   np.ones(6, dtype=np.float32), list(cfg.circular), 3,
                   pad_dims=0, content_tag="abc")
    JStore(str(tmp_path)).save("sig", model)
    ours = CliqueModelStore(str(tmp_path), "cpu").load("sig")
    assert repr(ours.cfg) == repr(cfg)
    assert ours.content_tag == "abc" and ours.aug_sep_dim == 3
    for a, b in zip(params, ours.flow_params):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


def test_warm_start_trains_no_clique(tmp_path):
    """The JAX package's warm-start test in the port: the second solve
    loads every clique (and trains none), and its posterior means lie
    within 1.0 m of the first's (``tests/test_checkpoint.py``'s bound)."""
    xs = [core.SE2Variable(f"X{i}") for i in range(3)]
    lm = core.R2Variable("L1", core.VariableType.Landmark)
    cov3 = np.diag([0.01, 0.01, 0.001])
    fs = [factors.UnarySE2ApproximateGaussianPriorFactor(xs[0], np.zeros(3),
                                                         cov3)]
    fs += [factors.SE2RelativeGaussianLikelihoodFactor(
        a, b, np.array([5.0, 0, 0]), cov3) for a, b in zip(xs, xs[1:])]
    fs.append(factors.SE2R2RangeGaussianLikelihoodFactor(xs[2], lm, 4.0,
                                                         0.3))

    def run(seed):
        s = NFiSAM(NFiSAMArgs(posterior_sample_num=200, local_sample_num=400,
                              flow_iterations=200, num_knots=6,
                              learning_rate=0.03,
                              elimination_method="pose_first", seed=seed,
                              checkpoint_dir=str(tmp_path)), device="cpu")
        trained, _ = _solve(s, [(xs + [lm], fs)])
        return trained[0], {v: x.mean(0) for v, x in s._samples.items()}

    cold, s1 = run(0)
    warm, s2 = run(1)
    assert cold and warm == []
    for v in s1:
        assert float((s1[v] - s2[v]).abs().max()) < 1.0


def test_clique_signatures_match_jax(stores):
    """Both packages trained the same cliques at every step and stored
    them under the same signatures, with the same configuration, column
    flags, dims and content tags: with the flow options too, so the
    padded dim and the width reach both the same way."""
    jdir, tdir, j_trained, t_trained, _, _ = stores
    assert t_trained == j_trained
    with open(os.path.join(jdir, "manifest.json")) as f:
        theirs = json.load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        ours = json.load(f)
    assert len(ours) == sum(len(t) for t in t_trained)
    assert ours == theirs


def test_jax_store_restores_with_no_training(stores, tmp_path):
    jdir, _, _, _, parallel, args = stores
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(jdir, ckpt)
    trained, solver = _port_case1(args, ckpt, parallel)
    assert trained == [[]] * 6
    assert all(np.isfinite(x.numpy()).all()
               for x in solver._samples.values())


def test_restored_models_draw_what_jax_draws():
    """Each model of the committed JAX store, restored by the port,
    against the JAX package's ``conditional_draw_core`` on the same base z
    and prefix."""
    jstore, tstore = JStore(JAX_CKPT), CliqueModelStore(JAX_CKPT, "cpu")
    for i, sig in enumerate(sorted(jstore.manifest)):
        jm, tm = jstore.load(sig), tstore.load(sig)
        cfg, sep = jm.cfg, jm.aug_sep_dim
        rng = np.random.default_rng(i)
        n = 300
        prefix = np.zeros((n, cfg.dim), np.float32)
        mean, std = np.asarray(jm.mean), np.asarray(jm.std)
        prefix[:, :sep] = mean[:sep] + 0.5 * std[:sep] * rng.normal(
            size=(n, sep))
        key = jax.random.PRNGKey(20 + i)
        circ = jnp.asarray(np.asarray(list(jm.circular_dim_list) +
                                      [False] * jm.pad_dims, dtype=bool))
        ref = j_draw(jm.flow_params, jm.mean, jm.std, circ, key,
                     jnp.asarray(prefix), jnp.asarray(
                         np.arange(cfg.dim) >= sep), cfg,
                     JBase(cfg.circular_mask), j_inverse)
        z = np.array(JBase(cfg.circular_mask).sample(key, n))
        got = tm.conditional_draw(torch.as_tensor(z), torch.as_tensor(
            prefix[:, :sep]) if sep else None).numpy()
        err = np.abs(got - np.asarray(ref)[:, sep:]) / std[sep:]
        assert np.quantile(err, 0.999) <= DRAW_TOL_999 and \
            err.max() <= DRAW_TOL, (sig, np.quantile(err, 0.999), err.max())


def test_committed_jax_store_restores_case1_with_no_training(tmp_path):
    """The committed store (``__main__``) restores every clique of case1
    at the bench configuration in the port, at every step."""
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(JAX_CKPT, ckpt)
    args = {**chip_smoke.BENCH_ARGS, "posterior_sample_num": 200,
            "seed": 1}
    trained, _ = _port_case1(args, ckpt)
    assert trained == [[]] * 6


if __name__ == "__main__":
    shutil.rmtree(JAX_CKPT, ignore_errors=True)
    trained, _ = _jax_case1({**chip_smoke.BENCH_ARGS, "seed": 1}, JAX_CKPT)
    print(f"wrote {JAX_CKPT}: cliques trained per step {trained}")
