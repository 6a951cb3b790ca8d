"""The port's fused root-to-leaf posterior pass on the CPU: against the
port's own per-clique walk on a branching tree (bit for bit, from the
same key stream), and against the JAX package's fused pass on the same
trained flows, carried across as numpy (moments at 4000 draws, atol
0.05)."""
import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import nfisam_tpu.core as jcore  # noqa: E402
import nfisam_tpu.factors as jfactors  # noqa: E402
import nfisam_tpu_torch.core as tcore  # noqa: E402
import nfisam_tpu_torch.factors as tfactors  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu.solver.posterior_pass import \
    fused_sample_posterior as j_fused  # noqa: E402
from nfisam_tpu_torch.flows import CliqueFlowModel  # noqa: E402
from nfisam_tpu_torch.parallel import ParallelNFiSAM  # noqa: E402
from nfisam_tpu_torch.solver import (FlowModelAdapter, LazySamples,  # noqa: E402
                                     NFiSAMArgs, fused_sample_posterior)
from test_torch_scheduler import _multi_robot_graph, _one_step  # noqa: E402
from test_torch_solver import SMALL  # noqa: E402

torch.set_num_threads(1)
DRAWS = 4000


@pytest.fixture(scope="module")
def branching():
    """Three disjoint robots of three poses, each with a ranged landmark,
    solved by the port: the root clique has children, and every clique
    a flow."""
    solver = ParallelNFiSAM(NFiSAMArgs(**{**SMALL, "flow_iterations": 30}),
                            device="cpu")
    return _one_step(solver, *_multi_robot_graph(tcore, tfactors, 3, 3))


def test_tree_branches(branching):
    root = branching.physical_bayes_tree.root
    assert len(root.children) >= 2
    assert len(branching.physical_bayes_tree.clique_nodes) >= 6


def test_fused_pass_equals_per_clique_walk_bit_for_bit(branching):
    n = SMALL["posterior_sample_num"]
    keys = copy.deepcopy(branching._keys)
    fused = fused_sample_posterior(branching, n)
    after_fused = copy.deepcopy(branching._keys)
    branching._keys = keys
    walk = branching.sample_posterior_per_clique()
    assert set(fused) == set(walk) == set(branching.physical_vars)
    for v in walk:
        assert fused[v].shape == (n, v.dim)
        assert torch.equal(fused[v], walk[v]), v
    # both took one key a clique
    assert branching._keys().tolist() == after_fused().tolist()


def test_sample_posterior_returns_lazy_samples(branching):
    out = branching.sample_posterior()
    assert isinstance(out, LazySamples)
    assert len(out) == len(branching.physical_vars)


def test_materialize_returns_every_variable(branching):
    out = branching.sample_posterior()
    host = out.materialize()
    assert set(host) == set(branching.physical_vars)
    for v, x in host.items():
        assert isinstance(x, np.ndarray)
        np.testing.assert_array_equal(x, out[v].numpy())
        assert np.isfinite(x).all()


def test_walk_takes_over_when_a_model_is_not_a_flow(branching):
    """A clique model the pass cannot read (no ``CliqueFlowModel``)
    sends ``sample_posterior`` to the per-clique walk."""

    class Opaque:
        def __init__(self, inner):
            self._inner = inner

        def conditional_sample_given_observation(self, *args, **kwargs):
            return self._inner.conditional_sample_given_observation(
                *args, **kwargs)

    models = branching._clique_density_model
    clique = next(iter(models))
    original = models[clique]
    models[clique] = Opaque(original)
    try:
        assert fused_sample_posterior(branching, 10) is None
        out = branching.sample_posterior()
        assert not isinstance(out, LazySamples)
        assert set(out) == set(branching.physical_vars)
    finally:
        models[clique] = original


def _clique_id(clique):
    return (tuple(sorted(str(v.name) for v in clique.frontal)),
            tuple(sorted(str(v.name) for v in clique.separator)))


@pytest.fixture(scope="module")
def carried():
    """The robots graph (2 robots of 3 poses, tight landmark priors)
    solved by both packages; the port's solver then takes JAX's trained
    flows, clique by clique, so both passes sample the same densities."""
    args = dict(posterior_sample_num=DRAWS, local_sample_num=500,
                flow_iterations=150, num_knots=7, hidden_dim=8,
                learning_rate=0.03, elimination_method="pose_first", seed=3,
                mode_repair=False)
    theirs = _one_step(JParallel(JNFiSAMArgs(**args)),
                       *chip_smoke.robots_graph(jcore, jfactors, 2, 3))
    ours = _one_step(ParallelNFiSAM(NFiSAMArgs(**args), device="cpu"),
                     *chip_smoke.robots_graph(tcore, tfactors, 2, 3))
    by_id = {_clique_id(c): a for c, a in
             theirs._clique_density_model.items()}
    obs_by_id = {_clique_id(c): o for c, o in theirs._clique_true_obs.items()}
    for clique in list(ours._clique_density_model):
        jm = by_id[_clique_id(clique)].model
        np.testing.assert_allclose(
            np.asarray(ours._clique_true_obs[clique], np.float64),
            np.asarray(obs_by_id[_clique_id(clique)], np.float64))
        model = CliqueFlowModel.from_numpy(
            dataclasses.asdict(jm.cfg),
            [{k: np.asarray(v) for k, v in p.items()}
             for p in jm.flow_params], np.asarray(jm.mean),
            np.asarray(jm.std), jm.circular_dim_list, jm.aug_sep_dim,
            jm.pad_dims, "cpu")
        ours._clique_density_model[clique] = FlowModelAdapter(
            model, ours._next_key)
    return ours, theirs


def test_fused_pass_matches_jax_in_moments(carried):
    """Same flows, different base draws (torch's generator, JAX's
    threefry): every variable's mean and std per dim within 0.05 at 4000
    draws (posterior stds here are <= 0.5 m, so the Monte Carlo error of
    either estimate is ~0.01)."""
    ours, theirs = carried
    a = fused_sample_posterior(ours, DRAWS).materialize()
    b = {str(v.name): np.asarray(x)
         for v, x in j_fused(theirs, DRAWS).items()}
    assert sorted(str(v.name) for v in a) == sorted(b)
    for v, x in a.items():
        y = b[str(v.name)]
        assert x.shape == y.shape == (DRAWS, v.dim)
        np.testing.assert_allclose(x.mean(0), y.mean(0), atol=0.05)
        np.testing.assert_allclose(x.std(0), y.std(0), atol=0.05)
