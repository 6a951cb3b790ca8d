"""The port's joint sampling API, its banked joint density, the kernel
Stein discrepancy and ``utils/functions.py`` against the JAX package's on
the CPU.

Element by element on the same float32 inputs (seeded numpy), on the
case1 step-5 joint (6 SE(2) poses, 2 landmarks, 22 dims), the case1_da
joint (its ambiguous ranges are mixture likelihood factors) and the ring
graph of ``tests/test_samplers.py``:

* the tree/likelihood split names the same factors;
* ``ptform`` of the same unit-cube points: atol 1e-4 and rtol 1e-5 (the
  pose chain composes five SE(2) odometries in float32: positions of
  tens of metres carry ~1e-5 m of rounding);
* ``loglike`` and ``log_prior_tree``: atol and rtol 1e-4 (sums of terms
  of ~1e3 in float32);
* ``JointFactor.grad_x_log_pdf`` at 1e-3 of the gradient's scale (prior
  draws put the SE(2) densities' gradients at ~1e3, and their
  1/h - cot h term at small residual angles loses float32 digits, see
  ``test_torch_factor_grads.py``); the banked joint density that NUTS
  evaluates against ``log_pdf`` at rtol 1e-6 (the same terms, summed by
  bank) and its gradient at 1e-3 of the gradient's scale;
* ``gaussian_kernel_stein_discrepancy`` on the same samples: the U and V
  statistics at rtol 1e-4, the Stein matrix at atol 1e-3 of its scale
  (at prior draws an entry sums score products of ~1e6 that cancel in
  float32), the bootstrap p-value equal; the float64 products agree
  with float32 at rtol 1e-4;
* every helper of ``utils/functions.py`` gives the JAX package's value.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfisam_tpu.core as jcore
import nfisam_tpu.factors as jfactors
import nfisam_tpu.utils.functions as jfun
import nfisam_tpu_torch.core as tcore
import nfisam_tpu_torch.factors as tfactors
import nfisam_tpu_torch.utils.functions as tfun
from nfisam_tpu.eval.metrics import \
    gaussian_kernel_stein_discrepancy as j_ksd
from nfisam_tpu.io import graph_file_parser as j_parse
from nfisam_tpu.samplers import StructuredJointFactor as JJoint
from nfisam_tpu_torch.eval import gaussian_kernel_stein_discrepancy
from nfisam_tpu_torch.io import graph_file_parser
from nfisam_tpu_torch.samplers import GlobalMCMCSampler, StructuredJointFactor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import ring_graph  # noqa: E402

torch.set_num_threads(1)
DATA = os.path.join(REPO, "data")
N = 200


def _joints(name):
    """(port joint, JAX joint) of a graph."""
    if name == "ring":
        ours = StructuredJointFactor(*reversed(ring_graph(tcore, tfactors)))
        theirs = JJoint(*reversed(ring_graph(jcore, jfactors)))
        return ours, theirs
    path = os.path.join(DATA, name)
    nodes, _, factors = graph_file_parser(path)
    jnodes, _, jfactors_ = j_parse(path, "fg")
    return StructuredJointFactor(factors, nodes), JJoint(jfactors_, jnodes)


GRAPHS = ["case1_factor_graph.fg", "case1_da_factor_graph.fg", "ring"]


@pytest.fixture(scope="module", params=GRAPHS)
def joints(request):
    return _joints(request.param)


def _names(fs):
    return [str(f) for f in fs]


def test_split_matches_jax(joints):
    ours, theirs = joints
    assert _names(ours.tree_priors) == _names(theirs.tree_priors)
    assert [(str(f), s) for f, s in ours.tree_binaries] == \
        [(str(f), s) for f, s in theirs.tree_binaries]
    assert _names(ours.likelihood_factors) == \
        _names(theirs.likelihood_factors)
    assert ours.dim == theirs.dim


def _x_and_u(ours, seed=0):
    u = np.random.default_rng(seed).uniform(
        0.01, 0.99, (N, ours.dim)).astype(np.float32)
    return u, ours.ptform(torch.as_tensor(u)).numpy()


def test_ptform_loglike_and_log_prior_tree_match_jax(joints):
    ours, theirs = joints
    u, x = _x_and_u(ours)
    np.testing.assert_allclose(x, np.asarray(theirs.ptform(u)), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(ours.loglike(torch.as_tensor(x)).numpy(),
                               np.asarray(theirs.loglike(x)), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        ours.log_prior_tree(torch.as_tensor(x)).numpy(),
        np.asarray(theirs.log_prior_tree(x)), atol=1e-4, rtol=1e-4)


def test_ptform_is_differentiable(joints):
    """The ``grad`` proposal differentiates ``loglike(ptform(u))`` in u."""
    ours, _ = joints
    u = torch.full((4, ours.dim), 0.4, requires_grad=True)
    (g,) = torch.autograd.grad(ours.loglike(ours.ptform(u)).sum(), u)
    assert g.shape == u.shape and bool(torch.isfinite(g).all())


def test_joint_gradient_and_banked_density_match(joints):
    ours, theirs = joints
    _, x = _x_and_u(ours, seed=1)
    got = ours.grad_x_log_pdf(torch.as_tensor(x)).numpy()
    want = np.asarray(theirs.grad_x_log_pdf(x))
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    # NUTS's density (by banks where every factor has one) is log_pdf
    sampler = GlobalMCMCSampler(ours.vars, ours.factors, device="cpu")
    density = sampler.log_density()
    xt = torch.as_tensor(x)
    lp = ours.log_pdf(xt).numpy()
    np.testing.assert_allclose(density(xt).numpy(), lp, rtol=1e-6,
                               atol=1e-6 * np.abs(lp).max())
    with torch.enable_grad():
        xg = xt.clone().requires_grad_(True)
        (gb,) = torch.autograd.grad(density(xg).sum(), xg)
    np.testing.assert_allclose(gb.numpy(), got,
                               atol=1e-3 * np.abs(got).max())


def test_kernel_stein_discrepancy_matches_jax():
    ours, theirs = _joints("case1_factor_graph.fg")
    # the tree prior's draws
    x = ours.sample(np.array([0, 4], np.uint32), 300, "cpu").numpy()
    P = np.eye(ours.dim) / 4.0
    u, p, off, v = gaussian_kernel_stein_discrepancy(ours, P, x, nboot=10)
    ju, jp, joff, jv = j_ksd(theirs, P, x, nboot=10)
    assert np.isfinite([u, v]).all()
    np.testing.assert_allclose([u, v], [ju, jv], rtol=1e-4)
    np.testing.assert_allclose(off, np.asarray(joff),
                               atol=1e-3 * np.abs(joff).max())
    assert p == jp
    u64, _, _, v64 = gaussian_kernel_stein_discrepancy(
        ours, P, x, nboot=10, dtype=torch.float64)
    np.testing.assert_allclose([u64, v64], [u, v], rtol=1e-4)


def test_functions_match_jax():
    rng = np.random.default_rng(0)
    th = rng.uniform(-10, 10, 50)
    np.testing.assert_array_equal(tfun.theta_to_pipi(th),
                                  jfun.theta_to_pipi(th))
    assert tfun.sort_pair_lists([3, 1, 2], "abc") == \
        jfun.sort_pair_lists([3, 1, 2], "abc")
    assert tfun.none_to_zero(None) == jfun.none_to_zero(None) == 0.0
    obj = {"a": np.arange(3), "b": np.float32(1.5), "c": np.int64(2)}
    assert json.dumps(obj, cls=tfun.NumpyEncoder) == \
        json.dumps(obj, cls=jfun.NumpyEncoder)
    data = np.concatenate([rng.normal(0, 1, 100), [40.0, -35.0, np.nan]])
    np.testing.assert_array_equal(tfun.reject_outliers(data),
                                  jfun.reject_outliers(data))
    spd = np.array([[2.0, 0.3], [0.3, 1.0]])
    for m in (spd, -spd, np.ones((2, 3)), spd + np.triu(np.ones((2, 2)), 1)):
        assert tfun.is_spd(m) == jfun.is_spd(m)
    arr = rng.normal(size=(40, 3))
    np.testing.assert_array_equal(
        tfun.sample_from_arr(arr, 5, np.random.default_rng(1)),
        jfun.sample_from_arr(arr, 5, np.random.default_rng(1)))
    tv = [tcore.SE2Variable("X0"), tcore.R2Variable("L1")]
    jv = [jcore.SE2Variable("X0"), jcore.R2Variable("L1")]
    x = rng.normal(size=(6, 5))
    td, jd = tfun.array_order_to_dict(x, tv), jfun.array_order_to_dict(x, jv)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(td[a], jd[b])
    np.testing.assert_array_equal(tfun.sample_dict_to_array(td, tv),
                                  jfun.sample_dict_to_array(jd, jv))
    with pytest.raises(ValueError):
        tfun.sample_dict_to_array(td, tv[:1])
