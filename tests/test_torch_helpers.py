"""The JAX package's last public helpers in the port, each held against
the JAX function on the same seeded numpy inputs, and the JAX tests that
call them ported as parametrised cases.

- Geometry (``core/geometry.py``): ``rot2_matrix``, ``se2_identity``,
  the log/exp-map Jacobians, ``se2_range_and_bearing``,
  ``se2_chordal_dist``, ``product_manifold_dist``: float32 on both
  sides, atol 1e-5 and rtol 1e-5 (the Jacobians near w = 0 carry the
  ``1/(cos w - 1)`` cancellation: rtol 1e-4 there).
- ``GaussianMixtureDistribution`` and ``gaussian_unif_to_sample``
  (``core/distributions.py``): densities and gradients to 1e-5; draws in
  distribution (mean and covariance of 40000 draws within 5 standard
  errors of the mixture's own).
- ``Variable.rotational_dim`` / ``t_dim_indices`` / ``R_dim_indices``,
  ``file2vars``, ``host_key``: equal.
- ``inc_var_factor_to_dead_reckoning`` on case1: to 1e-5 of the JAX
  path.
- ``fit_flow`` from ``init_params``: the JAX package's full-batch Adam
  from the same parameters on the same samples, loss curve and parameters
  (tolerances at the test); the JAX flow tests' cases on the port.
- ``normal_sample``, ``BaseDistribution.slice``,
  ``CliqueFlowModel.separator_base``, ``CliqueNode.detach_child`` /
  ``is_leaf`` / ``is_root``, ``BayesTree.leaves``,
  ``FactorGraph.factors_of``, ``FactorGraphSolver.working_factors``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import nfisam_tpu.core as jcore  # noqa: E402
from nfisam_tpu.core import distributions as jdist  # noqa: E402
from nfisam_tpu.core import geometry as jgeom  # noqa: E402
from nfisam_tpu.flows import base_dist as jbase  # noqa: E402
from nfisam_tpu.flows import model as jmodel  # noqa: E402
from nfisam_tpu.flows import nsf as jnsf  # noqa: E402
from nfisam_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from nfisam_tpu.train import fit_flow as j_fit_flow  # noqa: E402
import nfisam_tpu_torch.core as tcore  # noqa: E402
from nfisam_tpu_torch.core import distributions as tdist  # noqa: E402
from nfisam_tpu_torch.core import geometry as geom  # noqa: E402
from nfisam_tpu_torch.flows import (BaseDistribution, CliqueFlowModel,  # noqa: E402
                                    compute_normalizer, normal_sample,
                                    normalize)
from nfisam_tpu_torch.flows import nsf  # noqa: E402
from nfisam_tpu_torch.train import TrainConfig, fit_flow  # noqa: E402
from nfisam_tpu_torch.utils import host_key  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
CASE1 = os.path.join(REPO, "data", "case1_factor_graph.fg")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _poses(seed, n=128, small=False):
    rng = np.random.default_rng(seed)
    p = np.empty((n, 3), np.float32)
    p[:, :2] = rng.normal(size=(n, 2)) * 5.0
    p[:, 2] = rng.uniform(-2.5, 2.5, n)
    if small:     # inside and around the small-rotation switches
        p[:8, 2] = [0.0, 1e-7, -3e-6, 9e-6, 2e-5, -5e-5, 1e-3, -1e-2]
    return p


# --------------------------------------------------------------- geometry
@pytest.mark.parametrize("name,small", [
    ("rot2_matrix", False), ("se2_grad_det_grad_logmap", False),
    ("se2_grad_det_grad_logmap", True), ("se2_grad_x_logmap", False),
    ("se2_grad_x_logmap", True), ("se2_grad_xi_expmap", False),
    ("se2_grad_xi_expmap", True)])
def test_unary_geometry_helpers_match_jax(name, small):
    p = _poses(0, small=small)
    arg = p[:, 2] if name == "rot2_matrix" else p
    got = getattr(geom, name)(_t(arg)).numpy()
    ref = np.asarray(getattr(jgeom, name)(jnp.asarray(arg)))
    np.testing.assert_allclose(got, ref, atol=1e-5,
                               rtol=1e-4 if small else 1e-5)


@pytest.mark.parametrize("name", ["se2_chordal_dist", "se2_range_and_bearing",
                                  "product_manifold_dist"])
def test_binary_geometry_helpers_match_jax(name):
    a, b = _poses(1), _poses(2)
    if name == "se2_range_and_bearing":
        b = b[:, :2]
    extra = ((np.array([False, False, True]),)
             if name == "product_manifold_dist" else ())
    got = getattr(geom, name)(_t(a), _t(b), *extra)
    ref = getattr(jgeom, name)(jnp.asarray(a), jnp.asarray(b), *extra)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_se2_identity_matches_jax():
    for shape in [(), (4,), (2, 3)]:
        got = geom.se2_identity(shape)
        assert got.shape == tuple(np.asarray(jgeom.se2_identity(shape)).shape)
        assert not got.any()


def _case_grad_x_logmap_matches_autodiff():
    rng = np.random.default_rng(4)
    for _ in range(5):
        T = torch.tensor([rng.normal(), rng.normal(), rng.uniform(-2, 2)],
                         dtype=torch.float32)
        J_ad = torch.func.jacfwd(geom.se2_log)(T)
        np.testing.assert_allclose(geom.se2_grad_x_logmap(T).numpy(),
                                   J_ad.numpy(), atol=1e-3)


def _case_grad_xi_expmap_is_inverse_of_grad_x_logmap():
    T = torch.tensor([1.0, -0.5, 0.8])
    A = geom.se2_grad_x_logmap(T).numpy()
    B = geom.se2_grad_xi_expmap(T).numpy()
    np.testing.assert_allclose(A @ B, np.eye(3), atol=1e-4)


def _case_range_and_bearing():
    rng_, brg = geom.se2_range_and_bearing(
        torch.tensor([[0.0, 0.0, np.pi / 2]]), torch.tensor([[0.0, 2.0]]))
    assert np.isclose(float(rng_[0]), 2.0, atol=1e-6)
    assert np.isclose(float(brg[0]), 0.0, atol=1e-6)


JAX_GEOMETRY_CASES = {
    "grad_x_logmap_matches_autodiff": _case_grad_x_logmap_matches_autodiff,
    "grad_xi_expmap_is_inverse_of_grad_x_logmap":
        _case_grad_xi_expmap_is_inverse_of_grad_x_logmap,
    "range_and_bearing": _case_range_and_bearing}


@pytest.mark.parametrize("case", sorted(JAX_GEOMETRY_CASES))
def test_jax_geometry_cases_on_the_port(case):
    """``tests/test_geometry.py``'s cases of these helpers, on the port."""
    JAX_GEOMETRY_CASES[case]()


# ----------------------------------------------------------- distributions
def _mixture(pkg):
    rng = np.random.default_rng(5)
    means = [rng.normal(size=3) * 3.0 for _ in range(3)]
    covs = []
    for _ in range(3):
        A = rng.normal(size=(3, 3))
        covs.append(A @ A.T + 0.5 * np.eye(3))
    return pkg.GaussianMixtureDistribution([0.2, 0.5, 0.3], means, covs)


@pytest.mark.parametrize("method", ["component_log_pdfs", "log_pdf", "pdf",
                                    "grad_x_log_pdf"])
def test_mixture_densities_match_jax(method):
    x = np.random.default_rng(6).normal(size=(400, 3)).astype(np.float32) * 3
    got = getattr(_mixture(tdist), method)(_t(x)).numpy()
    ref = np.asarray(getattr(_mixture(jdist), method)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_mixture_from_precisions_matches_jax():
    rng = np.random.default_rng(7)
    precs = [np.diag(rng.uniform(0.5, 2.0, 2)) for _ in range(2)]
    means = [rng.normal(size=2) for _ in range(2)]
    x = rng.normal(size=(50, 2)).astype(np.float32)
    got = tdist.GaussianMixtureDistribution([0.4, 0.6], means,
                                            precisions=precs)
    ref = jdist.GaussianMixtureDistribution([0.4, 0.6], means,
                                            precisions=precs)
    assert (got.dim, got.num_components) == (ref.dim, ref.num_components)
    np.testing.assert_allclose(got.log_pdf(_t(x)).numpy(),
                               np.asarray(ref.log_pdf(jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError):
        tdist.GaussianMixtureDistribution([0.4, 0.4], means, precisions=precs)


def test_mixture_draws_match_in_distribution():
    """40000 draws from a ``torch.Generator`` keyed by the raw key: each
    coordinate's mean within 5 standard errors of the mixture's, and the
    covariance within 5% of its largest entry, as the JAX package's draws
    on its own key."""
    n = 40000
    port, ref = _mixture(tdist), _mixture(jdist)
    w = port.weights[:, None]
    mean = (w * port.means).sum(0)
    cov = sum(port.weights[k] * (port.covs[k] + np.outer(
        port.means[k] - mean, port.means[k] - mean)) for k in range(3))
    draws = {"port": port.rvs(host_key(3), n, "cpu").numpy(),
             "JAX": np.asarray(ref.rvs(jax.random.PRNGKey(3), n))}
    a = port.rvs(host_key(3), n, "cpu")
    assert torch.equal(a, torch.as_tensor(draws["port"]))
    for x in draws.values():
        assert x.shape == (n, 3)
        se = np.sqrt(np.diag(cov) / n)
        assert np.all(np.abs(x.mean(0) - mean) < 5 * se), x.mean(0) - mean
        assert np.abs(np.cov(x.T) - cov).max() < 0.05 * np.abs(cov).max()


def test_gaussian_unif_to_sample_matches_jax():
    rng = np.random.default_rng(8)
    u = rng.uniform(0.001, 0.999, size=(300, 2)).astype(np.float32)
    mu = np.array([1.0, -2.0], np.float32)
    A = rng.normal(size=(2, 2))
    cov_sqrt = tdist.spd_sqrt(A @ A.T + np.eye(2)).astype(np.float32)
    got = tdist.gaussian_unif_to_sample(_t(u), _t(mu), _t(cov_sqrt))
    ref = jdist.gaussian_unif_to_sample(jnp.asarray(u), jnp.asarray(mu),
                                        jnp.asarray(cov_sqrt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------- variables
@pytest.mark.parametrize("cls", ["R1Variable", "R2Variable",
                                 "Bearing2DVariable", "SE2Variable"])
def test_variable_dim_helpers_match_jax(cls):
    got, ref = getattr(tcore, cls)("v"), getattr(jcore, cls)("v")
    for attr in ("rotational_dim", "translational_dim", "t_dim_indices",
                 "R_dim_indices", "circular_dim_list"):
        assert getattr(got, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("pose_space", ["SE2", "R2"])
@pytest.mark.parametrize("text", ["X0 X1 L1 X2\tL2 X3", "X0\nL1\nX2\n",
                                  "case1_ref/ns_step5_ordering"])
def test_file2vars_matches_jax(tmp_path, pose_space, text):
    """One line of names, as the reference's ordering files, or one name a
    line."""
    path = os.path.join(REPO, "data", text) if "/" in text else \
        tmp_path / "ordering"
    if "/" not in text:
        path.write_text(text)
    got = tcore.file2vars(str(path), pose_space)
    ref = jcore.file2vars(str(path), pose_space)
    assert [(str(v.name), v.dim, v.type.value, type(v).__name__)
            for v in got] == [(str(v.name), v.dim, v.type.value,
                               type(v).__name__) for v in ref]
    with pytest.raises(ValueError):
        tcore.file2vars(str(path), "SE3")


def test_host_key_matches_jax():
    from nfisam_tpu.utils import host_key as j_host_key
    for seed, counter in [(0, 0), (7, 3), (2 ** 33 + 5, 11)]:
        got, ref = host_key(seed, counter), j_host_key(seed, counter)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


# -------------------------------------------------------------------- io
def test_dead_reckoning_matches_jax():
    from nfisam_tpu.io import graph_file_parser as j_parse
    from nfisam_tpu.io import group_nodes_factors_incrementally as j_group
    from nfisam_tpu.io import inc_var_factor_to_dead_reckoning as j_dr
    from nfisam_tpu_torch.io import (graph_file_parser,
                                     group_nodes_factors_incrementally,
                                     inc_var_factor_to_dead_reckoning)
    nodes, truth, factors = graph_file_parser(CASE1, "fg")
    xy = inc_var_factor_to_dead_reckoning(
        group_nodes_factors_incrementally(nodes, factors, 1))
    jn, _, jf = j_parse(CASE1, "fg")
    ref = j_dr(j_group(jn, jf, incremental_step=1))
    assert xy.dtype == np.float64 and xy.shape == ref.shape
    np.testing.assert_allclose(xy, ref, **TOL)
    # ``tests/test_sim_io.py``'s case: the noiseless path tracks the truth
    poses = sorted((str(v.name), truth[v]) for v in nodes
                   if str(v.name).startswith("X"))
    assert xy.shape == (len(poses), 2)
    gt = np.stack([p[1][:2] for p in poses])
    assert np.linalg.norm(xy - gt, axis=1).max() < 1.0


# ------------------------------------------------------------------ flows
def _normalized(data, cfg, scale_circular=True):
    circ = torch.as_tensor(cfg.circular_mask)
    mean, std = compute_normalizer(_t(data), circ,
                                   scale_circular=scale_circular)
    return normalize(_t(data), mean, std, circ), mean, std


def test_fit_flow_from_init_params_matches_jax():
    """The same start (the JAX package's ``init_flow_params``) and the same
    normalized samples: the full-batch loss does not depend on the
    shuffle, so both packages take the same Adam steps up to float32
    rounding; loss curves to rtol 1e-4 over 40 iterations, parameters to
    atol 2e-4 (each Adam step moves a weight by up to the learning rate,
    and rounding in a tiny second moment can flip one step)."""
    rng = np.random.default_rng(9)
    data = rng.normal(size=(300, 3)).astype(np.float32) * [1.0, 2.0, 0.5]
    jcfg = jnsf.NSFConfig(dim=3, num_knots=6, hidden_dim=8)
    cfg = nsf.NSFConfig(dim=3, num_knots=6, hidden_dim=8)
    xn, _, _ = _normalized(data, cfg)
    init = jnsf.init_flow_params(jax.random.PRNGKey(1), jcfg)
    start = nsf.flow_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in init], "cpu")
    kept = [{k: v.clone() for k, v in p.items()} for p in start]
    iters = 40
    params, loss, t = fit_flow(host_key(0), xn, cfg,
                               TrainConfig(max_iters=iters,
                                           learning_rate=0.01),
                               init_params=start)
    jparams, jloss, jt = j_fit_flow(
        jax.random.PRNGKey(0), jnp.asarray(xn.numpy()), jcfg,
        JTrainConfig(max_iters=iters, learning_rate=0.01), init_params=init)
    assert t == int(jt) == iters
    assert all(torch.equal(a[k], b[k]) for a, b in zip(start, kept)
               for k in a)                   # the start is not written to
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4)
    for p, jp in zip(params, jparams):
        for k in nsf.PARAM_NAMES:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       atol=2e-4, rtol=0)


def test_fit_flow_holds_out_a_validation_split():
    """``training_set_frac`` < 1: the validation stop ends the fit, as
    in the JAX package, and the key alone fixes the result."""
    data = np.random.default_rng(10).normal(size=(400, 2)).astype(np.float32)
    cfg = nsf.NSFConfig(dim=2, num_knots=5)
    xn, _, _ = _normalized(data, cfg)
    tc = TrainConfig(max_iters=3000, learning_rate=0.05,
                     training_set_frac=0.8)
    a = fit_flow(host_key(2), xn, cfg, tc)
    b = fit_flow(host_key(2), xn, cfg, tc)
    assert a[2] == b[2] < 3000
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a[0], b[0]) for k in p)


def _case_learns_correlated_gaussian():
    rng = np.random.default_rng(0)
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    data = rng.multivariate_normal([0, 0], cov, size=2000).astype(np.float32)
    cfg = nsf.NSFConfig(dim=2, num_knots=8, hidden_dim=8)
    xn, mean, std = _normalized(data, cfg)
    params, iter_loss, t = fit_flow(host_key(0), xn, cfg, TrainConfig(
        max_iters=600, learning_rate=0.03))
    losses = iter_loss.numpy()[:t]
    assert losses[-1] < losses[0] - 0.3
    s = CliqueFlowModel(cfg, params, mean, std, [False, False], 0).sample(
        host_key(8), 4000).numpy()
    c = np.cov(s.T)
    assert abs(c[0, 1] / np.sqrt(c[0, 0] * c[1, 1]) - 0.8) < 0.1


def _case_early_stop_plateau():
    data = np.random.default_rng(1).normal(size=(500, 2)).astype(np.float32)
    cfg = nsf.NSFConfig(dim=2, num_knots=5)
    xn, _, _ = _normalized(data, cfg)
    _, _, t = fit_flow(host_key(0), xn, cfg, TrainConfig(
        max_iters=2000, learning_rate=0.05, average_window=25,
        loss_delta_tol=5e-2))
    assert t < 2000


def _case_conditional_sample_matches_conditional_gaussian():
    rng = np.random.default_rng(2)
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]])
    data = rng.multivariate_normal([0, 0], cov, size=3000).astype(np.float32)
    cfg = nsf.NSFConfig(dim=2, num_knots=8)
    xn, mean, std = _normalized(data, cfg)
    params, _, _ = fit_flow(host_key(0), xn, cfg, TrainConfig(
        max_iters=800, learning_rate=0.03))
    model = CliqueFlowModel(cfg, params, mean, std, [False, False], 1)
    x0 = 1.0
    s = model.conditional_sample(host_key(9), 0, obs_samples=torch.full(
        (4000, 1), x0)).numpy()
    assert abs(s.mean() - rho * x0) < 0.12
    assert abs(s.std() - np.sqrt(1 - rho ** 2)) < 0.12


def _case_separator_forward_marginal_density():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2000, 3)).astype(np.float32) * \
        np.array([1.0, 2.0, 0.5], dtype=np.float32)
    cfg = nsf.NSFConfig(dim=3, num_knots=6)
    xn, mean, std = _normalized(data, cfg)
    params, _, _ = fit_flow(host_key(0), xn, cfg, TrainConfig(
        max_iters=400, learning_rate=0.03))
    model = CliqueFlowModel(cfg, params, mean, std, [False] * 3, 2)
    x_sep = torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, -2.0]])
    _, prior_lp, log_det = model.separator_forward(x_sep)
    lp = (prior_lp + log_det).numpy()
    assert lp[0] > lp[2]


def _case_cs_flow_learns_wrapped_distribution():
    rng = np.random.default_rng(0)
    th = np.concatenate([rng.normal(np.pi - 0.15, 0.1, 1500),
                         rng.normal(-np.pi + 0.15, 0.1, 1500)])
    th = (th + np.pi) % (2 * np.pi) - np.pi
    data = np.stack([rng.normal(size=3000), th], axis=1).astype(np.float32)
    cfg = nsf.NSFConfig(dim=2, num_knots=10, circular=(False, True))
    xn, mean, std = _normalized(data, cfg, scale_circular=False)
    params, _, _ = fit_flow(host_key(0), xn, cfg, TrainConfig(
        max_iters=600, learning_rate=0.03))
    s = CliqueFlowModel(cfg, params, mean, std, [False, True], 0).sample(
        host_key(1), 4000).numpy()
    assert np.all(np.abs(s[:, 1]) <= np.pi + 1e-4)
    near_pi = np.abs(np.abs(s[:, 1]) - np.pi) < 0.5
    assert near_pi.mean() > 0.7
    assert ((s[:, 1] > 0) & near_pi).sum() > 400
    assert ((s[:, 1] < 0) & near_pi).sum() > 400


JAX_FIT_FLOW_CASES = {
    "learns_correlated_gaussian": _case_learns_correlated_gaussian,
    "early_stop_plateau": _case_early_stop_plateau,
    "conditional_sample_matches_conditional_gaussian":
        _case_conditional_sample_matches_conditional_gaussian,
    "separator_forward_marginal_density":
        _case_separator_forward_marginal_density,
    "cs_flow_learns_wrapped_distribution":
        _case_cs_flow_learns_wrapped_distribution}


@pytest.mark.parametrize("case", sorted(JAX_FIT_FLOW_CASES))
def test_jax_fit_flow_cases_on_the_port(case):
    """``tests/test_flows.py``'s training cases and
    ``tests/test_circular_flow_e2e.py``'s wrapped density, on the port's
    ``fit_flow`` with the same data, settings and bounds."""
    JAX_FIT_FLOW_CASES[case]()


def test_normal_sample_moments():
    gen = torch.Generator().manual_seed(4)
    x = normal_sample(gen, (20000, 3), "cpu").numpy()
    y = np.asarray(jbase.normal_sample(jax.random.PRNGKey(4), (20000, 3)))
    assert x.shape == y.shape == (20000, 3)
    for z in (x, y):
        assert np.abs(z.mean(0)).max() < 5 / np.sqrt(20000)
        assert np.abs(z.std(0) - 1.0).max() < 0.02


@pytest.mark.parametrize("start,stop", [(0, 2), (1, 4), (3, 3)])
def test_base_slice_matches_jax(start, stop):
    mask = [False, True, False, True]
    got = BaseDistribution(mask).slice(start, stop)
    ref = jbase.BaseDistribution(mask).slice(start, stop)
    assert got.dim == ref.dim
    assert np.array_equal(got.circular_mask, ref.circular_mask)
    if got.dim:
        z = np.random.default_rng(11).normal(size=(64, got.dim))
        np.testing.assert_allclose(got.log_prob(_t(z)).numpy(),
                                   np.asarray(ref.log_prob(
                                       jnp.asarray(z, jnp.float32))), **TOL)


@pytest.mark.parametrize("sep", [0, 2, 3])
def test_separator_base_matches_jax(sep):
    circ = (False, False, True, False)
    jcfg = jnsf.NSFConfig(dim=4, num_knots=5, circular=circ)
    cfg = nsf.NSFConfig(dim=4, num_knots=5, circular=circ)
    got = CliqueFlowModel(cfg, [], torch.zeros(4), torch.ones(4),
                          list(circ), sep).separator_base
    ref = jmodel.CliqueFlowModel(jcfg, [], np.zeros(4), np.ones(4),
                                 list(circ), sep).separator_base
    if sep == 0:
        assert got is None and ref is None
    else:
        assert np.array_equal(got.circular_mask, ref.circular_mask)


# ---------------------------------------------------- graph and solver
@pytest.fixture(scope="module")
def case1_solvers():
    """Both packages' solvers on case1's whole graph, graph surgery only
    (no training)."""
    from nfisam_tpu.io import graph_file_parser as j_parse
    from nfisam_tpu.solver import NFiSAM as JNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs
    saved = os.environ.get("NFISAM_PREWARM")
    os.environ["NFISAM_PREWARM"] = "0"
    try:
        out = {}
        for label, parse, solver in (
                ("port", graph_file_parser,
                 lambda: NFiSAM(NFiSAMArgs(), device="cpu")),
                ("JAX", j_parse, lambda: JNFiSAM(JNFiSAMArgs()))):
            nodes, _, factors = parse(CASE1)
            s = solver()
            for v in nodes:
                s.add_node(v)
            for f in factors:
                s.add_factor(f)
            s.update_physical_and_working_graphs()
            out[label] = s
    finally:
        if saved is None:
            os.environ.pop("NFISAM_PREWARM", None)
        else:
            os.environ["NFISAM_PREWARM"] = saved
    return out


def _names(vs):
    return sorted(str(v.name) for v in vs)


def test_working_factors_and_factors_of_match_jax(case1_solvers):
    port, ref = case1_solvers["port"], case1_solvers["JAX"]
    assert [str(f) for f in port.working_factors] == \
        [str(f) for f in ref.working_factors]
    pg, jg = port._working_graph, ref._working_graph
    for v, jv in zip(pg.vars, jg.vars):
        assert sorted(map(str, pg.factors_of(v))) == \
            sorted(map(str, jg.factors_of(jv)))
        assert _names(pg.neighbors(v)) == _names(jg.neighbors(jv))
    with pytest.raises(KeyError):
        pg.factors_of(tcore.R2Variable("not_in_graph"))


def test_tree_leaves_and_detach_match_jax(case1_solvers):
    trees = {k: s.physical_bayes_tree for k, s in case1_solvers.items()}

    def shape(tree):
        return (_names(tree.root.frontal), tree.root.is_root,
                sorted(_names(c.frontal) for c in tree.leaves),
                all(c.is_leaf for c in tree.leaves),
                sum(not c.is_root for c in tree.clique_nodes))
    assert shape(trees["port"]) == shape(trees["JAX"])
    for tree in trees.values():
        root = tree.root
        child = next(iter(root.children))
        assert root.detach_child(child) is root
        assert child.is_root and child not in root.children
        assert child not in tree.clique_nodes
        root.attach_child(child)
        assert child.parent is root and not child.is_root
