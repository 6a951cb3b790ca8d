"""The port's case1 factors against the JAX package's: ``log_pdf`` and
``unif_to_sample(u)`` element by element on the same float32 inputs and
the same uniform draws ``u`` (seeded numpy).

Tolerance: atol 1e-5, rtol 1e-5 (float32 on both sides), except the SE(2)
odometry ``log_pdf``: its residual is the difference of two ~30 m
relative poses, so one float32 rounding of a coordinate (30 m * 2^-24 =
2e-6 m) in either implementation, whitened by the 0.04 m noise and
multiplied by the O(1) residual, moves the log density by ~1e-4; that
case uses atol 2e-4."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfisam_tpu.io import graph_file_parser as j_parse
from nfisam_tpu_torch.io import graph_file_parser

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
ODOMETRY_LOG_PDF_TOL = dict(atol=2e-4, rtol=1e-5)
CASE1 = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                     "case1_factor_graph.fg")


@pytest.fixture(scope="module")
def factors():
    nodes, truth, ours = graph_file_parser(CASE1)
    _, _, theirs = j_parse(CASE1, "fg")
    truth = {str(v.name): t for v, t in truth.items()}
    return list(zip(ours, theirs)), truth


def _of_type(pairs, name):
    out = [p for p in pairs if type(p[0]).__name__ == name]
    assert out
    return out


def _near_mode(f, truth, rng, n=200):
    """Samples within a few noise sigmas of the factor's mode.  An SE(2)
    factor is invariant to a common rigid motion of its poses, so binary
    SE(2) samples start near the origin and the second pose follows the
    measured odometry: far-out tails and 90 m coordinates would lose
    float32 digits to cancellation on both sides alike."""
    if type(f).__name__ == "SE2RelativeGaussianLikelihoodFactor":
        x1 = rng.normal(size=(n, 3)) * np.array([0.05, 0.05, 0.3])
        c, s = np.cos(x1[:, 2]), np.sin(x1[:, 2])
        o = f.obs
        x2 = np.stack([x1[:, 0] + c * o[0] - s * o[1],
                       x1[:, 1] + s * o[0] + c * o[1],
                       x1[:, 2] + o[2]], axis=1)
        x2 += rng.normal(size=(n, 3)) * np.sqrt(np.diag(f.covariance))
        return np.hstack([x1, x2]).astype(np.float32)
    cols = []
    for v in f.vars:
        t = np.asarray(truth[str(v.name)], np.float64)
        x = t + rng.normal(size=(n, v.dim)) * 0.02
        if v.dim == 3:
            x[:, 2] = (x[:, 2] + np.pi) % (2 * np.pi) - np.pi
        cols.append(x)
    return np.hstack(cols).astype(np.float32)


FACTOR_TYPES = ["UnarySE2ApproximateGaussianPriorFactor",
                "SE2RelativeGaussianLikelihoodFactor",
                "SE2R2RangeGaussianLikelihoodFactor"]


@pytest.mark.parametrize("name", FACTOR_TYPES)
def test_log_pdf_matches_jax(factors, name):
    pairs, truth = factors
    rng = np.random.default_rng(0)
    for ours, theirs in _of_type(pairs, name):
        x = _near_mode(ours, truth, rng)
        got = ours.log_pdf(torch.as_tensor(x)).numpy()
        ref = np.asarray(theirs.log_pdf(jnp.asarray(x)))
        tol = ODOMETRY_LOG_PDF_TOL if "Relative" in name else TOL
        np.testing.assert_allclose(got, ref, **tol)


def _uniform(rng, n, d):
    return rng.uniform(0.02, 0.98, size=(n, d)).astype(np.float32)


def test_prior_unif_to_sample_matches_jax(factors):
    pairs, _ = factors
    rng = np.random.default_rng(1)
    for ours, theirs in _of_type(pairs,
                                 "UnarySE2ApproximateGaussianPriorFactor"):
        u = _uniform(rng, 300, 3)
        got = ours.unif_to_sample(torch.as_tensor(u)).numpy()
        ref = np.asarray(theirs.unif_to_sample(jnp.asarray(u)))
        np.testing.assert_allclose(got, ref, **TOL)
        single = ours.unif_to_sample(torch.as_tensor(u[0])).numpy()
        np.testing.assert_allclose(single, ref[0], **TOL)


@pytest.mark.parametrize("name,du", [
    ("SE2RelativeGaussianLikelihoodFactor", 3),
    ("SE2R2RangeGaussianLikelihoodFactor", 3)])
@pytest.mark.parametrize("given", ["var1", "var2"])
def test_binary_unif_to_sample_matches_jax(factors, name, du, given):
    pairs, truth = factors
    rng = np.random.default_rng(2)
    for ours, theirs in _of_type(pairs, name):
        known = ours.vars[0] if given == "var1" else ours.vars[1]
        t = np.asarray(truth[str(known.name)], np.float32)
        src = (t + rng.normal(size=(300, known.dim)) * 0.3).astype(
            np.float32)
        u = _uniform(rng, 300, du)
        got = ours.unif_to_sample(torch.as_tensor(u),
                                  **{given: torch.as_tensor(src)}).numpy()
        ref = np.asarray(theirs.unif_to_sample(jnp.asarray(u),
                                               **{given: jnp.asarray(src)}))
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", FACTOR_TYPES[1:])
def test_directional_samples_are_consistent(factors, name):
    """Forward draws given var1 (and observation draws given both) land
    where the factor puts its mass: the factor's own log_pdf is finite
    and, for a tight factor, near its mode."""
    pairs, truth = factors
    for ours, _ in _of_type(pairs, name):
        t1 = torch.as_tensor(np.asarray(truth[str(ours.vars[0].name)],
                                        np.float32)).expand(500, -1)
        x2 = ours.sample(np.array([3, 4], np.uint32), var1=t1.contiguous())
        assert x2.shape == (500, ours.vars[1].dim)
        lp = ours.log_pdf(torch.cat([t1, x2], dim=1))
        assert torch.isfinite(lp).all()
        obs = ours.sample(np.array([5, 6], np.uint32), var1=t1.contiguous(),
                          var2=x2)
        assert obs.shape == (500, ours.measurement_dim)
        if name.startswith("SE2R2Range"):
            rng_ = torch.linalg.vector_norm(x2 - t1[:, :2], dim=1)
            assert abs(float(rng_.mean()) - float(ours.obs[0])) < 0.5


R2_PRIOR_LINE = ("UnaryR2GaussianPriorFactor L1 25.0 -10.0 covariance "
                 "0.25 0.05 0.05 0.4")


def _r2_priors():
    """The R^2 landmark prior in both packages, from one ``.fg`` line."""
    import nfisam_tpu.core as jcore
    import nfisam_tpu.factors as jfactors
    import nfisam_tpu_torch.core as tcore
    import nfisam_tpu_torch.factors as tfactors
    ours = tfactors.Factor.construct_from_text(
        R2_PRIOR_LINE, [tcore.R2Variable("L1", tcore.VariableType.Landmark)])
    theirs = jfactors.UnaryR2GaussianPriorFactor.construct_from_text(
        R2_PRIOR_LINE, [jcore.R2Variable("L1", jcore.VariableType.Landmark)])
    return ours, theirs


def test_r2_prior_matches_jax():
    """``log_pdf`` and ``unif_to_sample`` of the landmark prior that the
    robots graph uses, element by element; its ``.fg`` text round-trips;
    draws have its moments."""
    ours, theirs = _r2_priors()
    rng = np.random.default_rng(3)
    x = (np.array([25.0, -10.0]) + rng.normal(size=(300, 2))).astype(
        np.float32)
    np.testing.assert_allclose(ours.log_pdf(torch.as_tensor(x)).numpy(),
                               np.asarray(theirs.log_pdf(jnp.asarray(x))),
                               **TOL)
    u = _uniform(rng, 300, 2)
    np.testing.assert_allclose(
        ours.unif_to_sample(torch.as_tensor(u)).numpy(),
        np.asarray(theirs.unif_to_sample(jnp.asarray(u))), **TOL)
    assert str(ours) == "Factor " + R2_PRIOR_LINE
    draws = ours.sample(np.array([1, 2], np.uint32), 20000, "cpu").numpy()
    np.testing.assert_allclose(draws.mean(0), [25.0, -10.0], atol=0.02)
    np.testing.assert_allclose(np.cov(draws.T), ours.covariance, atol=0.02)
