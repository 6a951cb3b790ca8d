"""The port's factor gradients, batched log-likelihoods, ancestral densities
and flow-prior transforms against the JAX package's on the CPU.

Element by element on the same float32 inputs (seeded numpy):

* ``grad_x_log_pdf`` of every factor class that has one in the JAX
  package, of the mixtures (case1_da's ambiguous associations and a
  null-hypothesis range) and of ``FlowsPriorFactor`` on a flow carried
  across from the JAX package: atol and rtol 1e-4 (the gradients sum
  terms of a precision's size that cancel, so 1e-5 is not met), and 1e-3
  for two: the SE(2) exp-map densities, whose log-det-Jacobian
  log((h / sin h)^2) of the residual half-angle h has the gradient
  1/h - cot h, a float32 difference of two ~1/h terms (each package lies
  up to 6e-4 from the float64 gradient of the JAX package), and the
  flow's density, whose gradient runs back through 16 dims of float32
  spline derivatives;
* ``loglike_rows`` against ``vmap(evaluate_loglike)`` of the JAX package,
  row for row, for every factor class, both branches of the uncertain
  range factors and both sides of the mixtures' 5-nat rule: 1e-5;
* ``log_ancestral_density`` of the range factors for either known end:
  1e-5;
* ``FlowsPriorFactor.unif_to_sample`` (the masked AR inverse with the
  observation prefix pinned) against the JAX package's ``stack_inverse``:
  atol 1e-4 and rtol 1e-4 (the rational-quadratic spline's inverse in
  float32 rounds differently in the two packages, as the flow tests
  found), with and without observation columns, and its gradient in the
  unit-cube coordinates against ``jax.grad`` of the JAX factor's: rtol
  1e-4 and atol 1e-4 of the largest entry.

The slip/grip and bearing factors have no gradient in either package."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfisam_tpu.core as jcore
import nfisam_tpu.factors as jfactors
import nfisam_tpu_torch.core as tcore
import nfisam_tpu_torch.factors as tfactors
from nfisam_tpu.flows.model import CliqueFlowModel as JModel
from nfisam_tpu.flows.nsf import NSFConfig as JConfig
from nfisam_tpu.flows.nsf import init_flow_params
from nfisam_tpu.io import graph_file_parser as j_parse
from nfisam_tpu.solver.nfisam import FlowsPriorFactor as JFlowsPrior
from nfisam_tpu_torch.flows import CliqueFlowModel
from nfisam_tpu_torch.io import graph_file_parser
from nfisam_tpu_torch.solver.nfisam import FlowsPriorFactor

torch.set_num_threads(1)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# SE(2) exp-map densities and flows: see the module docstring
LOOSE_GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
LOOSE_GRAD = ("SE2 prior", "SE2 mixture prior", "SE2 odometry")
TOL = dict(atol=1e-5, rtol=1e-5)
DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
N = 64


def _pair(make):
    """(port factor, JAX factor) from ``make(core, factors)``."""
    return make(tcore, tfactors), make(jcore, jfactors)


def _se2_pose(rng, n):
    return np.concatenate([rng.normal(0, 1, (n, 2)),
                           rng.uniform(-2.5, 2.5, (n, 1))], axis=1)


def _inputs(kind, rng):
    """(N, d) float32 inputs of a factor of ``kind``."""
    if kind == "r2":
        return rng.normal(0, 2, (N, 2))
    if kind == "se2":
        return _se2_pose(rng, N)
    if kind == "r2r2":
        a = rng.normal(0, 3, (N, 2))
        return np.concatenate([a, a + rng.normal(2, 2, (N, 2))], 1)
    if kind == "se2se2":
        a = _se2_pose(rng, N)
        b = a + np.concatenate([rng.normal(1, 0.3, (N, 2)),
                                rng.normal(0.2, 0.2, (N, 1))], 1)
        return np.concatenate([a, b], 1)
    if kind == "se2r2":
        a = _se2_pose(rng, N)
        return np.concatenate([a, a[:, :2] + rng.normal(3, 2, (N, 2))], 1)
    raise ValueError(kind)


COV2 = np.array([[0.5, 0.1], [0.1, 0.3]])
COV3 = np.array([[0.2, 0.05, 0.0], [0.05, 0.3, 0.01], [0.0, 0.01, 0.05]])

# (name, input kind, make(core, factors))
CASES = [
    ("R2 prior", "r2", lambda c, f: f.UnaryR2GaussianPriorFactor(
        c.R2Variable("L1"), np.array([0.5, -1.0]), covariance=COV2)),
    ("Gaussian prior SE2", "se2", lambda c, f: f.GaussianPriorFactor(
        c.SE2Variable("X0"), np.array([0.5, -1.0, 0.3]), covariance=COV3)),
    ("ring prior", "r2", lambda c, f: f.UnaryR2RangeGaussianPriorFactor(
        c.R2Variable("L1"), np.array([0.5, -1.0]), 2.0, 0.4)),
    ("uncertain ring prior", "r2",
     lambda c, f: f.UncertainUnaryR2RangeGaussianPriorFactor(
         c.R2Variable("L1"), np.array([0.5, -1.0]), 2.0, 0.4)),
    ("SE2 prior", "se2", lambda c, f: f.UnarySE2ApproximateGaussianPriorFactor(
        c.SE2Variable("X0"), np.array([0.5, -1.0, 0.3]), COV3)),
    ("SE2 mixture prior", "se2",
     lambda c, f: f.UnarySE2ApproximateGaussianMixturePriorFactor(
         c.SE2Variable("X0"), [np.array([0.5, -1.0, 0.3]),
                               np.array([-1.0, 2.0, -1.2])],
         [0.3, 0.7], [COV3, 2 * COV3])),
    ("R2 odometry", "r2r2", lambda c, f: f.R2RelativeGaussianLikelihoodFactor(
        c.R2Variable("X0"), c.R2Variable("X1"), np.array([2.0, 1.5]),
        covariance=COV2)),
    ("SE2 odometry", "se2se2",
     lambda c, f: f.SE2RelativeGaussianLikelihoodFactor(
         c.SE2Variable("X0"), c.SE2Variable("X1"),
         np.array([1.0, 0.2, 0.2]), COV3)),
    ("SE2-R2 range", "se2r2",
     lambda c, f: f.SE2R2RangeGaussianLikelihoodFactor(
         c.SE2Variable("X0"), c.R2Variable("L1"), 4.0, 0.5)),
    ("R2 range", "r2r2", lambda c, f: f.R2RangeGaussianLikelihoodFactor(
        c.R2Variable("X0"), c.R2Variable("L1"), 3.0, 0.3)),
    ("SE2-SE2 range", "se2se2",
     lambda c, f: f.SE2SE2RangeGaussianLikelihoodFactor(
         c.SE2Variable("X0"), c.SE2Variable("X1"), 1.2, 0.2)),
    ("uncertain range", "r2r2",
     lambda c, f: f.UncertainR2RangeGaussianLikelihoodFactor(
         c.R2Variable("X0"), c.R2Variable("L1"), 3.0, 0.3,
         observed_flag=True)),
    ("null-hypothesis range", "se2r2",
     lambda c, f: f.BinaryFactorWithNullHypo(
         c.SE2Variable("X0"), c.R2Variable("L1"), [0.8, 0.2],
         f.SE2R2RangeGaussianLikelihoodFactor, 4.0, 0.5)),
]
# classes whose loglike differs from log_pdf, or with no gradient
LOGLIKE_ONLY = [
    ("unobserved uncertain range", "r2r2",
     lambda c, f: f.UncertainR2RangeGaussianLikelihoodFactor(
         c.R2Variable("X0"), c.R2Variable("L1"), 3.0, 0.3,
         observed_flag=False)),
    ("unobserved uncertain ring prior", "r2",
     lambda c, f: f.UncertainUnaryR2RangeGaussianPriorFactor(
         c.R2Variable("L1"), np.array([0.5, -1.0]), 2.0, 0.4,
         observed_flag=False)),
    ("bearing", "se2se2", lambda c, f: f.SE2BearingLikelihoodFactor(
        c.SE2Variable("X0"), c.SE2Variable("X1"), 0.3, 0.1)),
    ("slip/grip", "se2se2",
     lambda c, f: f.RelativeGaussianSlipGripSE2Factor(
         c.SE2Variable("X0"), c.SE2Variable("X1"),
         np.array([1.0, 0.2, 0.2]), COV3, prob_slip=0.3)),
]


def _ours(factor, method, x, **kw):
    return getattr(factor, method)(torch.as_tensor(x), **kw).numpy()


def _theirs(factor, method, x, **kw):
    return np.asarray(getattr(factor, method)(jnp.asarray(x), **kw))


@pytest.mark.parametrize("name,kind,make", CASES, ids=[c[0] for c in CASES])
def test_grad_x_log_pdf_matches_jax(name, kind, make):
    ours, theirs = _pair(make)
    x = _inputs(kind, np.random.default_rng(1)).astype(np.float32)
    got = _ours(ours, "grad_x_log_pdf", x)
    want = _theirs(theirs, "grad_x_log_pdf", x)
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, **(LOOSE_GRAD_TOL if name in LOOSE_GRAD else GRAD_TOL))


@pytest.mark.parametrize("name,kind,make", CASES + LOGLIKE_ONLY,
                         ids=[c[0] for c in CASES + LOGLIKE_ONLY])
def test_loglike_rows_match_jax_evaluate_loglike(name, kind, make):
    ours, theirs = _pair(make)
    x = _inputs(kind, np.random.default_rng(2)).astype(np.float32)
    got = _ours(ours, "loglike_rows", x)
    want = np.asarray(jax.vmap(theirs.evaluate_loglike)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    # the single-row form is the batched form's row
    np.testing.assert_allclose(
        float(ours.evaluate_loglike(torch.as_tensor(x[3]))), got[3],
        **TOL)


@pytest.mark.parametrize("name,kind,make", LOGLIKE_ONLY[2:],
                         ids=[c[0] for c in LOGLIKE_ONLY[2:]])
def test_no_gradient_in_either_package(name, kind, make):
    ours, theirs = _pair(make)
    x = _inputs(kind, np.random.default_rng(3)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        _ours(ours, "grad_x_log_pdf", x)
    with pytest.raises(NotImplementedError):
        _theirs(theirs, "grad_x_log_pdf", x)


@pytest.mark.parametrize("var1_sampled", [True, False])
@pytest.mark.parametrize("name,kind,make", [CASES[8], CASES[9], CASES[10]],
                         ids=["SE2-R2", "R2", "SE2-SE2"])
def test_range_log_ancestral_density_matches_jax(name, kind, make,
                                                 var1_sampled):
    ours, theirs = _pair(make)
    x = _inputs(kind, np.random.default_rng(4)).astype(np.float32)
    np.testing.assert_allclose(
        _ours(ours, "log_ancestral_density", x, var1_sampled=var1_sampled),
        _theirs(theirs, "log_ancestral_density", x,
                var1_sampled=var1_sampled), **TOL)


def test_mixture_loglike_takes_both_sides_of_the_5_nat_rule():
    """case1_da's ambiguous ranges on rows near one candidate (dominated:
    the max) and between both (the logsumexp): row for row as the JAX
    package's per-row rule, and both branches taken."""
    path = os.path.join(DATA, "case1_da_factor_graph.fg")
    _, truth, ours_all = graph_file_parser(path)
    _, _, theirs_all = j_parse(path, "fg")
    truth = {str(v.name): np.asarray(t) for v, t in truth.items()}
    rng = np.random.default_rng(5)
    pairs = [(o, t) for o, t in zip(ours_all, theirs_all)
             if type(o).__name__ == "AmbiguousDataAssociationFactor"]
    assert pairs
    branches = set()
    for ours, theirs in pairs:
        base = np.concatenate([truth[str(v.name)] for v in ours.vars])
        x = (base + rng.normal(0, 3.0, (4 * N, base.shape[0]))).astype(
            np.float32)
        got = _ours(ours, "loglike_rows", x)
        want = np.asarray(jax.vmap(theirs.evaluate_loglike)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, **TOL)
        lps = ours.component_log_pdfs(torch.as_tensor(x)).numpy()
        top = np.sort(lps, axis=1)
        branches |= set((top[:, -1] - top[:, -2] > 5.0).tolist())
        np.testing.assert_allclose(_ours(ours, "grad_x_log_pdf", x),
                                   _theirs(theirs, "grad_x_log_pdf", x),
                                   **GRAD_TOL)
    assert branches == {True, False}


def _flow_prior_pair(obs_dim: int, seed: int = 0, num_flows: int = 1):
    """A random 16-dim NSF-AR flow stack (K=9, h=8, ``num_flows`` flows)
    carried from the JAX package to the port, behind each package's
    ``FlowsPriorFactor`` over [X1 (SE2), L1 (R2)] with ``obs_dim``
    observation columns before them."""
    cfg = JConfig(dim=16, num_knots=9, hidden_dim=8, num_flows=num_flows)
    rng = np.random.default_rng(seed)
    params = [{k: np.asarray(v) + rng.normal(0, 0.3, np.shape(v)).astype(
        np.float32) for k, v in p.items()}
        for p in init_flow_params(jax.random.PRNGKey(seed), cfg)]
    mean = rng.normal(0, 1, 16).astype(np.float32)
    std = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    circ = [False] * 16
    circ[obs_dim + 2] = True
    true_obs = rng.normal(0, 1, obs_dim)
    jm = JModel(cfg, [{k: jnp.asarray(v) for k, v in p.items()}
                      for p in params], jnp.asarray(mean), jnp.asarray(std),
                circ, obs_dim + 5, pad_dims=4)
    tm = CliqueFlowModel.from_numpy(dataclasses.asdict(cfg), params, mean,
                                    std, circ, obs_dim + 5, 4, "cpu")
    out = []
    for core, cls, model in ((tcore, FlowsPriorFactor, tm),
                             (jcore, JFlowsPrior, jm)):
        vars_ = [core.SE2Variable("X1"), core.R2Variable("L1")]
        out.append(cls(vars_, model, true_obs, [False, False, True, False,
                                                 False], lambda: None))
    return out


@pytest.mark.parametrize("obs_dim", [0, 2])
def test_flows_prior_unif_to_sample_and_grad_match_jax(obs_dim):
    ours, theirs = _flow_prior_pair(obs_dim)
    rng = np.random.default_rng(6)
    u = rng.uniform(0.02, 0.98, (N, 5)).astype(np.float32)
    got = _ours(ours, "unif_to_sample", u)
    want = _theirs(theirs, "unif_to_sample", u)
    assert got.shape == (N, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # a single (d,) draw is the batch's row
    np.testing.assert_allclose(
        ours.unif_to_sample(torch.as_tensor(u[7])).numpy(), got[7], **TOL)
    np.testing.assert_allclose(_ours(ours, "grad_x_log_pdf", got),
                               _theirs(theirs, "grad_x_log_pdf", got),
                               **LOOSE_GRAD_TOL)
    # the JAX package's flow evaluate_loglike reads the host, so no vmap:
    # its log_pdf is the same function
    np.testing.assert_allclose(_ours(ours, "loglike_rows", got),
                               _theirs(theirs, "log_pdf", got), **GRAD_TOL)


@pytest.mark.parametrize("obs_dim,num_flows", [(0, 1), (2, 1), (3, 2)],
                         ids=["0", "2", "3-2flows"])
def test_flows_prior_unif_to_sample_gradient_matches_jax(obs_dim, num_flows):
    """``unif_to_sample`` is differentiable (the masked inverse's
    implicit-function VJP): the gradient of a weighted sum of its output
    in ``u`` against ``jax.grad`` of the JAX factor's (its plain
    ``stack_inverse`` differentiated): rtol 1e-4 and atol 1e-4 of the
    largest entry (the two forwards agree to 1e-4 only, and the gradient
    at a point moved by that much moves by a few times it).  The 2-flow
    stack checks that the backward walks the flows in reverse."""
    ours, theirs = _flow_prior_pair(obs_dim, num_flows=num_flows)
    rng = np.random.default_rng(6)
    u = rng.uniform(0.02, 0.98, (N, 5)).astype(np.float32)
    w = rng.normal(size=(N, 5)).astype(np.float32)
    ut = torch.as_tensor(u).requires_grad_(True)
    (torch.as_tensor(w) * ours.unif_to_sample(ut)).sum().backward()
    want = jax.grad(lambda uu: jnp.sum(w * theirs.unif_to_sample(uu)))(
        jnp.asarray(u))
    assert np.isfinite(ut.grad.numpy()).all()
    want = np.asarray(want)
    np.testing.assert_allclose(ut.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())

def test_grad_proposal_over_a_flow_prior_matches_jax_in_distribution():
    """``GlobalNestedSampler(proposal="grad")`` over a clique whose tree
    prior is a flow (``_flow_prior_pair``'s, over X1 and L1) and whose
    likelihood is a range between them: the proposal differentiates
    ``loglike(ptform(u))`` through ``unif_to_sample``.  Against the JAX
    package's sampler on the same factors (100 live points, dlogz 0.5):
    logz within max(3.5 of the two errors combined, 0.35), and the MMD of
    the two sample sets within 1.5x the MMD between the JAX package's own
    runs from two keys (the sampling noise at this size)."""
    from nfisam_tpu.samplers.nested import GlobalNestedSampler as JNS
    from nfisam_tpu_torch.eval import mmd
    from nfisam_tpu_torch.samplers.nested import GlobalNestedSampler

    ours, theirs = _flow_prior_pair(2)
    runs = []
    for f, fac, new, key in (
            (ours, tfactors, lambda n, fs: GlobalNestedSampler(
                n, fs, device="cpu"), 3), (theirs, jfactors, JNS, 3),
            (theirs, jfactors, JNS, 4)):
        x1, l1 = f.vars
        summary = {}
        samples = new([x1, l1], [f, fac.SE2R2RangeGaussianLikelihoodFactor(
            x1, l1, 4.0, 0.5)]).sample(
                key=np.array([0, key], np.uint32), live_points=100,
                proposal="grad", dlogz=0.5, res_summary=summary)
        assert np.isfinite(samples).all()
        runs.append((np.asarray(samples), summary))
    (a, sa), (b, sb), (c, _) = runs
    assert abs(sa["logz"] - sb["logz"]) <= max(
        3.5 * np.hypot(sa["logzerr"], sb["logzerr"]), 0.35)
    assert mmd(a, b) <= 1.5 * mmd(b, c)
