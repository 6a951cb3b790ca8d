"""The port's (clique, data) mesh (``parallel/mesh.py``) and the sharded
fits and passes on it, on the CPU: the counterparts of the JAX package's
``tests/test_mesh.py``.  Ranks are spawned processes in a gloo group
(``torch_rank_cases.py``; they import no JAX); the JAX side runs here, on
its virtual 8-device mesh.

Tolerances: one sharded train step equals the world-1 step within 1e-6
(the sharded loss sums its rows in another order), 30 more steps within
1e-3 relative (Adam grows that gap), and the world-1 step
equals the JAX package's within 1e-5; the sharded conditional sampler and
the sharded fused posterior pass equal their unsharded runs exactly (each
rank draws the whole base sample and inverts its rows, row by row), and
the sampler equals the JAX package's within 1e-5 + 1e-5|x|; a sharded
fit's iteration count equals the unsharded one's, its normalizer within
1e-6, its loss curve over 40 iterations within 5e-3 + 5e-3|x| and its
parameters within 5e-2 (the JAX package's ``test_mesh.py`` bounds: Adam
grows the reduction order's drift); a ``ParallelNFiSAM`` solve on a
(2, 2) mesh has moments within 0.15 of the world-1 solve and of the JAX
package's mesh solve at the same arguments."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nfisam_tpu.flows import init_flow_params as j_init  # noqa: E402
from nfisam_tpu.parallel import (  # noqa: E402
    build_sharded_conditional_sampler as j_sampler,
    build_sharded_train_step as j_train_step, make_mesh as j_make_mesh)
from nfisam_tpu_torch.flows import flow_params_from_numpy  # noqa: E402
from nfisam_tpu_torch.parallel import (  # noqa: E402
    build_sharded_conditional_sampler, data_parallel_mesh, make_mesh,
    shard_samples)
from nfisam_tpu_torch.train import (TrainConfig, fit_flow_raw,  # noqa: E402
                                    fit_flows_batched)
from torch_rank_cases import (inputs, keys, r2_graph_solve,  # noqa: E402
                              run_ranks, sampler_params, step_run)

STEP_TOL = 1e-6
JAX_TOL = dict(atol=1e-5, rtol=1e-5)
# Adam turns the reduction order's float drift into larger gaps over the
# iterations: the JAX package's own test_mesh.py bounds
LOSS_TOL = dict(rtol=5e-3, atol=5e-3)
PARAM_ATOL = 5e-2
MOMENT_TOL = 0.15
# the losses after 30 more sharded steps against world 1's: Adam grows
# the first step's ~1e-7 reduction-order gap, by init key [s, 7], s =
# 0-15, to 6e-7 ... 4.016e-4 relative (``python tests/test_torch_mesh.py
# step-scatter``); the next decade above that spread
STEPS_RTOL = 1e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank case this file reads, each run once."""
    tmp = tmp_path_factory.mktemp("mesh")
    return {name: run_ranks(name, 4, tmp)
            for name in ("step", "sampler", "fits", "fused", "solve")}


def test_make_mesh_shapes(ranks):
    """Without a group the mesh is one rank; a (2, 2) mesh of 4 ranks
    places rank r at (r // 2, r % 2); a shape that is not the world size
    fails with the JAX package's message."""
    assert make_mesh().shape == data_parallel_mesh().shape == \
        {"clique": 1, "data": 1}
    with pytest.raises(AssertionError, match="2 x 2 != 1 devices"):
        make_mesh(n_clique=2, n_data=2)
    assert [r["shape"] for r in ranks["step"]] == \
        [{"clique": 2, "data": 2}] * 4
    assert [r["index"] for r in ranks["step"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(shard_samples(make_mesh(), x), x)


def test_sharded_train_step_matches_world_one_and_descends(ranks):
    """One step on the (2, 2) mesh (each rank 2 cliques, 32 rows of 64)
    equals the world-1 step within 1e-6: the ranks' parameter blocks and
    every clique's loss; 30 more steps lower every clique's loss, to
    world 1's within ``STEPS_RTOL``."""
    (params, loss1), last = step_run(make_mesh(), "cpu")
    for rank in ranks["step"]:
        (p, l1), l_last = rank["first"], rank["last"]
        np.testing.assert_allclose(l1.numpy(), loss1.numpy(), atol=STEP_TOL,
                                   rtol=STEP_TOL)
        for mine, ref in zip(p, params):
            for k in ref:
                np.testing.assert_allclose(
                    mine[k].numpy(), ref[k][rank["cliques"]].numpy(),
                    atol=STEP_TOL, rtol=0)
        assert np.all(l_last.numpy() < l1.numpy())
        np.testing.assert_allclose(l_last.numpy(), last.numpy(),
                                   rtol=STEPS_RTOL)


def test_world_one_train_step_matches_jax():
    """The step on the JAX package's parameters and data: the losses and
    parameters after one step within 1e-5 of the JAX package's sharded
    step on its (2, 4) mesh."""
    cfg, data = inputs("step")
    jp = jax.vmap(lambda k: j_init(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    jstep, jinit, sharding = j_train_step(cfg, j_make_mesh(n_clique=2,
                                                           n_data=4), 0.05)
    _, opt_state = jinit(jax.random.PRNGKey(0), 4)
    jparams, _, jloss = jstep(jp, opt_state, jax.device_put(
        data.numpy(), sharding))
    from nfisam_tpu_torch.parallel import build_sharded_train_step
    step, init, shard = build_sharded_train_step(cfg, make_mesh(), 0.05)
    params = [{k: torch.tensor(np.asarray(v)) for k, v in f.items()}
              for f in jp]
    _, state = init(np.array([0, 7], np.uint32), 4, device="cpu")
    params, _, loss = step(params, state, shard(data))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **JAX_TOL)
    for mine, ref in zip(params, jparams):
        for k in ref:
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]),
                                       **JAX_TOL)


def test_train_step_init_without_a_device_wants_the_card():
    """``init`` names no device by default: it follows the package's rule
    (``resolve_device``), so on a host without a card it raises instead
    of putting the stack on the CPU, and on the CPU when asked."""
    from nfisam_tpu_torch.parallel import build_sharded_train_step
    cfg, _ = inputs("step")
    _, init, _ = build_sharded_train_step(cfg, make_mesh(), 0.05)
    key = np.array([0, 7], np.uint32)
    params, (mu, _, step) = init(key, 4, device="cpu")
    assert params[0]["W1"].device.type == "cpu" and step == 0
    if torch.cuda.is_available():
        assert init(key, 4)[0][0]["W1"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(key, 4)


def test_sharded_conditional_sampler_is_exact(ranks):
    """Each rank's gathered draw equals the world-1 draw bit for bit, and
    the JAX package's sharded draw within 1e-5 + 1e-5|x| on the same
    parameters."""
    cfg, xp, z = inputs("sampler")
    ref = build_sharded_conditional_sampler(cfg, make_mesh(), 2)(
        sampler_params(cfg), xp, z)
    assert ref.shape == (64, 3) and torch.isfinite(ref).all()
    for rank in ranks["sampler"]:
        assert torch.equal(rank["out"], ref)
    jp = j_init(jax.random.PRNGKey(2), cfg)
    draw = j_sampler(cfg, j_make_mesh(n_clique=2, n_data=4), sep_dim=2)
    theirs = np.asarray(draw(jp, xp.numpy(), z.numpy()))
    ours = build_sharded_conditional_sampler(cfg, make_mesh(), 2)(
        flow_params_from_numpy(jp, "cpu"), xp, z)
    np.testing.assert_allclose(ours.numpy(), theirs, **JAX_TOL)


def _raw_fit(name: str, keep: int):
    data = inputs("fits")[name][:keep]
    cfg_dim = data.shape[1]
    from nfisam_tpu_torch.flows import NSFConfig
    r = fit_flow_raw(np.array([0, 1], np.uint32), torch.as_tensor(data),
                     NSFConfig(dim=cfg_dim, num_knots=5, hidden_dim=4),
                     TrainConfig(max_iters=40, learning_rate=0.05),
                     [False] * cfg_dim)
    return r[1], r[2], r[3], r[4]


def _same_fit(mine, ref) -> None:
    (il, t, mean, std), (il_r, t_r, mean_r, std_r) = mine, ref
    assert t == t_r
    np.testing.assert_allclose(mean.numpy(), mean_r.numpy(), atol=1e-6)
    np.testing.assert_allclose(std.numpy(), std_r.numpy(), atol=1e-6)
    np.testing.assert_allclose(il[:t].numpy(), il_r[:t].numpy(),
                               **LOSS_TOL)
    assert torch.isfinite(il[:t]).all()


def test_fit_flow_raw_with_data_mesh(ranks):
    """256 rows over a (1, 4) data mesh: the fit of every rank follows
    the unsharded one."""
    for rank in ranks["fits"]:
        _same_fit(rank["raw256"], _raw_fit("raw256", 256))


def test_fit_flows_batched_clique_sharding_matches_unsharded(ranks):
    """3 cliques of 160 rows on a (2, 2) mesh (padded to 4 on the clique
    axis): the gathered results of every rank follow the unsharded
    batched fit, the padding dropped."""
    from nfisam_tpu_torch.flows import NSFConfig
    stack = inputs("fits")["stack160"]
    p_u, il_u, t_u, m_u, s_u = fit_flows_batched(
        keys(3), torch.as_tensor(stack),
        NSFConfig(dim=4, num_knots=5, hidden_dim=4),
        TrainConfig(max_iters=40, learning_rate=0.05),
        np.zeros((3, 4), bool))
    for rank in ranks["fits"]:
        p, il, t, m, s = rank["stack160"]
        assert il.shape[0] == 3 and m.shape == (3, 4)
        for b in range(3):
            _same_fit((il[b], t[b], m[b], s[b]),
                      (il_u[b], t_u[b], m_u[b], s_u[b]))
        for mine, ref in zip(p, p_u):
            for k in ref:
                np.testing.assert_allclose(mine[k].numpy(), ref[k].numpy(),
                                           atol=PARAM_ATOL)


def test_fit_flows_batched_non_divisible_sample_axis(ranks):
    """150 rows over 4 data ranks: the remainder is dropped (148 rows a
    clique, as the JAX package drops it), not a crash."""
    from nfisam_tpu_torch.flows import NSFConfig
    stack = inputs("fits")["stack150"][:, :148]
    _, il_u, t_u, m_u, s_u = fit_flows_batched(
        keys(3), torch.as_tensor(stack),
        NSFConfig(dim=4, num_knots=5, hidden_dim=4),
        TrainConfig(max_iters=40, learning_rate=0.05),
        np.zeros((3, 4), bool))
    for rank in ranks["fits"]:
        _, il, t, m, s = rank["stack150"]
        for b in range(3):
            _same_fit((il[b], t[b], m[b], s[b]),
                      (il_u[b], t_u[b], m_u[b], s_u[b]))


@pytest.mark.parametrize("name, keep", [("raw150", 148), ("raw3", 3)])
def test_fit_flow_raw_cut_or_replicated(ranks, name, keep):
    """150 rows over 4 ranks train on 148 (the JAX package's
    drop-remainder); 3 rows, fewer than 4 ranks, are kept whole in every
    rank rather than cut to an empty batch."""
    for rank in ranks["fits"]:
        _same_fit(rank[name], _raw_fit(name, keep))


def test_sharded_fused_pass_is_bit_exact(ranks):
    """With ``sample_mesh`` on a (2, 2) mesh the fused pass computes 256
    of 512 rows a rank and gathers them: every rank's posterior equals the
    world-1 solve's bit for bit (the fits are not sharded, so the flows
    are the same)."""
    ref, rows = r2_graph_solve("cpu")
    assert rows == 512
    for rank in ranks["fused"]:
        assert rank["shard_rows"] == 256
        assert set(rank["samples"]) == set(ref)
        for name, x in ref.items():
            assert torch.equal(rank["samples"][name], x), name


def test_parallel_solver_end_to_end_on_mesh(ranks):
    """``ParallelNFiSAM`` with ``data_parallel_mesh`` and ``sample_mesh``
    on a (2, 2) mesh: every rank's moments within 0.15 of the world-1
    solve and of the JAX package's solve on its (2, 4) mesh at the same
    arguments."""
    from nfisam_tpu.core.variables import R2Variable, VariableType
    from nfisam_tpu.factors import (GaussianPriorFactor,
                                    R2RelativeGaussianLikelihoodFactor)
    from nfisam_tpu.parallel.scheduler import ParallelNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs

    mesh = j_make_mesh(n_clique=2, n_data=4)
    a, b = R2Variable("x0"), R2Variable("x1")
    c = R2Variable("l1", variable_type=VariableType.Landmark)
    s = ParallelNFiSAM(NFiSAMArgs(
        posterior_sample_num=512, local_sample_num=512, flow_iterations=150,
        num_knots=5, hidden_dim=4, learning_rate=0.05,
        elimination_method="pose_first", seed=3, data_parallel_mesh=mesh,
        sample_mesh=mesh))
    for v in (a, b, c):
        s.add_node(v)
    s.add_factor(GaussianPriorFactor(a, np.zeros(2), np.eye(2) * 0.04))
    s.add_factor(R2RelativeGaussianLikelihoodFactor(
        a, b, np.array([1.0, 0.0]), np.eye(2) * 0.01))
    s.add_factor(R2RelativeGaussianLikelihoodFactor(
        b, c, np.array([0.0, 1.0]), np.eye(2) * 0.01))
    s.update_physical_and_working_graphs()
    theirs = {str(v.name): np.asarray(x)
              for v, x in s.incremental_inference().items()}
    world1, _ = r2_graph_solve("cpu")
    for rank in ranks["solve"]:
        assert rank["shard_rows"] == 256
        for name, x in rank["samples"].items():
            x = x.numpy()
            for ref in (world1[name].numpy(), theirs[name]):
                np.testing.assert_allclose(x.mean(0), ref.mean(0),
                                           atol=MOMENT_TOL)
                np.testing.assert_allclose(x.std(0), ref.std(0),
                                           atol=MOMENT_TOL)


def step_scatter() -> None:
    """The sharded step's losses on the (2, 2) mesh against world 1 for
    each init key of ``STEP_KEYS``: the largest gap relative to the
    world-1 loss after the first step and after 30 more, by key and over
    all keys."""
    import tempfile

    from torch_rank_cases import STEP_KEYS

    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks("step_keys", 4, tmp)
    worst = [0.0, 0.0]
    for key in STEP_KEYS:
        (_, first), last = step_run(make_mesh(), "cpu", key=key)
        gaps = [0.0, 0.0]
        for rank in ranks:
            for i, (mine, ref) in enumerate(zip(rank[key], (first, last))):
                rel = np.abs(mine.numpy() - ref.numpy()) / np.abs(ref.numpy())
                gaps[i] = max(gaps[i], float(rel.max()))
        worst = [max(w, g) for w, g in zip(worst, gaps)]
        print(f"init key {list(key)}: mesh vs world 1, largest relative "
              f"loss gap after 1 step {gaps[0]!r}, after 31 {gaps[1]!r}",
              flush=True)
    print(f"keys {[list(k) for k in STEP_KEYS]}: worst after 1 step "
          f"{worst[0]!r}, after 31 {worst[1]!r}", flush=True)


if __name__ == "__main__" and sys.argv[1:] == ["step-scatter"]:
    step_scatter()
