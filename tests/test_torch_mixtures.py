"""The port's mixture factors against the JAX package's on the CPU.

Element by element on the same float32 inputs and the same uniform draws
``u`` (seeded numpy): ``component_log_pdfs``, ``log_pdf``,
``evaluate_loglike`` (a dominated and a non-dominated point),
``posterior_weights`` and the null-hypothesis ``unif_to_sample``, at atol
1e-5 and rtol 1e-5.  The ``.fg`` text of every ambiguous-data-association
line of case1_da and plaza1_ada0.2 reads back to the same string.

In distribution (the two packages turn a key into different random
numbers): 20000 draws of ``sample_observations``, ``sample_observer`` and
the null-hypothesis ``sample``, each draw's component read from the
factor's own assignment for that key.  Each component's share lies within
4 binomial sigma of its weight, and its ring radius has JAX's mean and
std within 3 standard errors of the difference."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfisam_tpu.core as jcore
import nfisam_tpu.factors as jfactors
import nfisam_tpu_torch.core as tcore
import nfisam_tpu_torch.factors as tfactors
from nfisam_tpu.io import graph_file_parser as j_parse
from nfisam_tpu.utils.keys import split_host as j_split
from nfisam_tpu_torch.io import graph_file_parser
from nfisam_tpu_torch.utils.keys import split_host

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
N_DRAWS = 20000


def _ada_pairs(name):
    """(port factor, JAX factor) for every DA line of a ``.fg``, and the
    ground truth by variable name."""
    path = os.path.join(DATA, name)
    _, truth, ours = graph_file_parser(path)
    _, _, theirs = j_parse(path, "fg")
    pairs = [(o, t) for o, t in zip(ours, theirs)
             if type(o).__name__ == "AmbiguousDataAssociationFactor"]
    assert pairs and all(type(t).__name__ == type(o).__name__
                         for o, t in pairs)
    return pairs, {str(v.name): np.asarray(x) for v, x in truth.items()}


@pytest.fixture(scope="module")
def case1_da():
    return _ada_pairs("case1_da_factor_graph.fg")


@pytest.mark.parametrize("name", ["case1_da_factor_graph.fg",
                                  "plaza1_ada0.2_factor_graph.fg"])
def test_text_matches_jax_and_round_trips(name):
    pairs, _ = _ada_pairs(name)
    for ours, theirs in pairs:
        assert str(ours) == str(theirs)
        again = tfactors.Factor.construct_from_text(str(ours), ours.vars)
        assert type(again) is type(ours) and str(again) == str(ours)


def _near_truth(f, truth, rng, n=300, spread=0.5):
    """(n, f.dim) float32 points around the ground truth of f's vars."""
    cols = []
    for v in f.vars:
        x = truth[str(v.name)] + rng.normal(size=(n, v.dim)) * spread
        if v.dim == 3:
            x[:, 2] = (x[:, 2] + np.pi) % (2 * np.pi) - np.pi
        cols.append(x)
    return np.hstack(cols).astype(np.float32)


def test_log_densities_match_jax(case1_da):
    pairs, truth = case1_da
    rng = np.random.default_rng(0)
    for ours, theirs in pairs:
        x = _near_truth(ours, truth, rng)
        np.testing.assert_allclose(
            ours.component_log_pdfs(torch.as_tensor(x)).numpy(),
            np.asarray(theirs.component_log_pdfs(jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(
            ours.log_pdf(torch.as_tensor(x)).numpy(),
            np.asarray(theirs.log_pdf(jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(
            ours.pdf(torch.as_tensor(x)).numpy(),
            np.asarray(theirs.pdf(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("dominated", [True, False])
def test_evaluate_loglike_matches_jax(case1_da, dominated):
    """At the ground truth one hypothesis dominates (> 5 nats); with L2
    moved onto L1 both hypotheses tie and the mixture sums them."""
    pairs, truth = case1_da
    ours, theirs = pairs[0]
    x = _near_truth(ours, truth, np.random.default_rng(1), n=1,
                    spread=0.0)[0]
    if not dominated:
        x[5:7] = x[3:5]
    lps = ours.component_log_pdfs(torch.as_tensor(x[None]))[0]
    assert bool(abs(lps[0] - lps[1]) > 5.0) == dominated
    got = float(ours.evaluate_loglike(torch.as_tensor(x)))
    ref = float(theirs.evaluate_loglike(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **TOL)
    expect = float(lps.max()) if dominated else float(torch.logsumexp(lps, 0))
    np.testing.assert_allclose(got, expect, **TOL)


def test_posterior_weights_match_jax(case1_da):
    pairs, truth = case1_da
    rng = np.random.default_rng(2)
    for ours, theirs in pairs:
        x = _near_truth(ours, truth, rng, n=500, spread=2.0)
        cols, start = {}, 0
        for v in ours.vars:
            cols[str(v.name)] = x[:, start:start + v.dim]
            start += v.dim
        got = ours.posterior_weights(
            {v: torch.as_tensor(cols[str(v.name)]) for v in ours.vars})
        ref = theirs.posterior_weights(
            {v: cols[str(v.name)] for v in theirs.vars})
        np.testing.assert_allclose(got, ref, **TOL)
        assert abs(got.sum() - 1.0) < 1e-12


NULL_LINE = ("BinaryFactorWithNullHypo Observer X1 Observed L1 Weights 0.8 "
             "0.2 Binary SE2R2RangeGaussianLikelihoodFactor Observation 5.0 "
             "Sigma 0.5 NullSigmaScale 10.0")


def _null_hypo():
    """The null-hypothesis factor in both packages, from one line."""
    ours = tfactors.Factor.construct_from_text(
        NULL_LINE, [tcore.SE2Variable("X1"),
                    tcore.R2Variable("L1", tcore.VariableType.Landmark)])
    theirs = jfactors.Factor.construct_from_text(
        NULL_LINE, [jcore.SE2Variable("X1"),
                    jcore.R2Variable("L1", jcore.VariableType.Landmark)])
    return ours, theirs


def test_null_hypo_matches_jax():
    """Text, densities and the CDF inversion through the mixture (the
    first uniform coordinate picks the component), batched and single,
    from either endpoint."""
    ours, theirs = _null_hypo()
    assert str(ours) == str(theirs) == "Factor " + NULL_LINE
    rng = np.random.default_rng(3)
    x = np.hstack([rng.normal(size=(300, 3)),
                   rng.normal(size=(300, 2)) * 4 + [3.0, 4.0]]).astype(
        np.float32)
    np.testing.assert_allclose(
        ours.component_log_pdfs(torch.as_tensor(x)).numpy(),
        np.asarray(theirs.component_log_pdfs(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(ours.log_pdf(torch.as_tensor(x)).numpy(),
                               np.asarray(theirs.log_pdf(jnp.asarray(x))),
                               **TOL)
    for given, du in (("var1", 2), ("var2", 3)):
        src = x[:, :3] if given == "var1" else x[:, 3:]
        u = rng.uniform(0.02, 0.98, size=(300, du)).astype(np.float32)
        got = ours.unif_to_sample(torch.as_tensor(u),
                                  **{given: torch.as_tensor(src)}).numpy()
        ref = np.asarray(theirs.unif_to_sample(jnp.asarray(u),
                                               **{given: jnp.asarray(src)}))
        np.testing.assert_allclose(got, ref, **TOL)
        single = ours.unif_to_sample(torch.as_tensor(u[0]),
                                     **{given: torch.as_tensor(src[0])})
        np.testing.assert_allclose(single.numpy(), ref[0], **TOL)


def test_mixture_gradient_raises():
    """The mixture gradient no longer raises: it is the JAX package's
    responsibility-weighted sum of the components' gradients, at 1e-4
    (the components' gradients sum terms of the precision's size)."""
    ours, theirs = _null_hypo()
    x = np.random.default_rng(7).normal(0, 3, (16, 5)).astype(np.float32)
    np.testing.assert_allclose(
        ours.grad_x_log_pdf(torch.as_tensor(x)).numpy(),
        np.asarray(theirs.grad_x_log_pdf(jnp.asarray(x))),
        atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- draws
# an observer at (5, 0) and three far-apart candidates: the observed
# ranges (5, 95, ~100) and the rings of radius 10 around each candidate
# are many sigma apart
DRAW_LINE = ("AmbiguousDataAssociationFactor Observer X1 Observed L1 L2 L3 "
             "Weights 0.2 0.3 0.5 Binary SE2R2RangeGaussianLikelihoodFactor "
             "Observation 10.0 Sigma 0.5")
POSITIONS = {"X1": [5.0, 0.0, 0.3], "L1": [0.0, 0.0], "L2": [100.0, 0.0],
             "L3": [0.0, 100.0]}


def _draw_factors():
    def build(core, factors):
        vs = [core.SE2Variable("X1")] + [
            core.R2Variable(n, core.VariableType.Landmark)
            for n in ("L1", "L2", "L3")]
        return factors.Factor.construct_from_text(DRAW_LINE, vs)
    return build(tcore, tfactors), build(jcore, jfactors)


def _given(f, names, to):
    return {v: to(np.tile(np.asarray(POSITIONS[str(v.name)], np.float32),
                          (N_DRAWS, 1)))
            for v in f.vars if str(v.name) in names}


def _radius(f, kind, draws, comp):
    """The ring radius of each draw under component ``comp``."""
    if kind == "sample_observations":
        return draws[:, 0]
    if kind == "sample_observer":
        lmk = np.asarray(POSITIONS[str(f.observed_vars[comp].name)])
        return np.linalg.norm(draws[:, :2] - lmk, axis=1)
    return np.linalg.norm(draws[:, :2] - np.asarray(POSITIONS["X1"][:2]),
                          axis=1)


def _draw(f, kind, key, pkg):
    """(draws (N, dim), component of each draw) of one package's factor."""
    to = torch.as_tensor if pkg == "torch" else jnp.asarray
    if kind == "sample_observations":
        out = f.sample_observations(key, _given(f, POSITIONS, to))
    elif kind == "sample_observer":
        out = f.sample_observer(key, _given(f, ("L1", "L2", "L3"), to))
    else:
        out = f.sample(key, var1=_given(f, ("X1",), to)[f.vars[0]])
    if pkg == "torch":
        comps = f._component_assignment(split_host(key)[0], N_DRAWS, "cpu")
        return out.numpy(), comps.numpy()
    comps = f._component_assignment(j_split(key)[0], N_DRAWS)
    return np.asarray(out), np.asarray(comps)


@pytest.mark.parametrize("kind", ["sample_observations", "sample_observer",
                                  "null_hypo_sample"])
def test_draws_match_jax_in_distribution(kind):
    ours, theirs = (_null_hypo() if kind == "null_hypo_sample"
                    else _draw_factors())
    key = np.array([7, 11], np.uint32)
    ours_x, ours_c = _draw(ours, kind, key, "torch")
    theirs_x, theirs_c = _draw(theirs, kind, key, "jax")
    assert ours_x.shape == theirs_x.shape and np.isfinite(ours_x).all()
    for i, w in enumerate(ours.weights):
        share = float(np.mean(ours_c == i))
        assert abs(share - w) <= 4 * np.sqrt(w * (1 - w) / N_DRAWS), (i,
                                                                      share)
        r1 = _radius(ours, kind, ours_x[ours_c == i], i)
        r2 = _radius(theirs, kind, theirs_x[theirs_c == i], i)
        se_mean = np.sqrt(r1.var() / len(r1) + r2.var() / len(r2))
        se_std = np.sqrt(r1.var() / (2 * len(r1)) +
                         r2.var() / (2 * len(r2)))
        assert abs(r1.mean() - r2.mean()) <= 3 * se_mean, (i, r1.mean(),
                                                           r2.mean())
        assert abs(r1.std() - r2.std()) <= 3 * se_std, (i, r1.std(),
                                                        r2.std())
