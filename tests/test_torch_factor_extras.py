"""The port's less common factor types against the JAX package's: the
Gaussian, ring and uncertain-ring priors, the SE(2) mixture prior, R^2
odometry, slip/grip odometry, bearing, and the R^2-R^2, SE(2)-SE(2) and
uncertain ranges.  For each: the text form (the port's ``str`` equals
the JAX package's, and a parse of the JAX package's string gives the
string the JAX package's own parse gives), ``log_pdf`` and
``unif_to_sample(u)`` element by element on the same seeded numpy
inputs, ``evaluate_loglike`` where it differs from ``log_pdf``, and the
draws in distribution (the two packages draw from different generators).

Tolerance: atol 1e-5, rtol 1e-5 (float32 on both sides); draws: sample
means within 4 standard errors, shares within 0.03."""
import jax
import numpy as np
import pytest
import torch

import nfisam_tpu.factors.factors as J
from nfisam_tpu.core import variables as JV
from nfisam_tpu.factors import Factor as JFactor
from nfisam_tpu_torch.core import variables as TV
from nfisam_tpu_torch.factors import factors as T

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
KEY = np.array([0, 7], dtype=np.uint32)


def _vars(mod):
    return {"X0": mod.SE2Variable("X0"), "X1": mod.SE2Variable("X1"),
            "P0": mod.R2Variable("P0"), "P1": mod.R2Variable("P1"),
            "L1": mod.R2Variable("L1", mod.VariableType.Landmark)}


COV3 = np.diag([0.01, 0.02, 0.003])
COV2 = np.array([[0.04, 0.01], [0.01, 0.09]])

# name -> (class name, constructor of (variables) -> args, kwargs)
CASES = {
    "gaussian prior": ("GaussianPriorFactor", lambda v: (
        (v["X0"], np.array([1.0, -2.0, 0.3])), {"covariance": COV3})),
    "ring prior": ("UnaryR2RangeGaussianPriorFactor", lambda v: (
        (v["L1"], np.array([3.0, 4.0]), 5.0, 0.7), {})),
    "uncertain ring prior": ("UncertainUnaryR2RangeGaussianPriorFactor",
                             lambda v: ((v["L1"], np.array([3.0, 4.0]),
                                         5.0, 0.7), {})),
    "SE2 mixture prior": ("UnarySE2ApproximateGaussianMixturePriorFactor",
                          lambda v: ((v["X0"], [np.zeros(3),
                                                np.array([10.0, 0.0, 1.5])],
                                      [0.3, 0.7], [COV3, 2 * COV3]), {})),
    "R2 odometry": ("R2RelativeGaussianLikelihoodFactor", lambda v: (
        (v["P0"], v["P1"], np.array([3.0, -1.0])), {"covariance": COV2})),
    "slip/grip odometry": ("RelativeGaussianSlipGripSE2Factor", lambda v: (
        (v["X0"], v["X1"], np.array([5.0, 0.5, 0.2]), COV3), {
            "prob_slip": 0.3})),
    "bearing": ("SE2BearingLikelihoodFactor", lambda v: (
        (v["X0"], v["X1"], np.pi / 4, 0.02, 1.0, 3.0), {})),
    "R2 range": ("R2RangeGaussianLikelihoodFactor", lambda v: (
        (v["P0"], v["L1"], 6.0, 0.4), {})),
    "SE2-SE2 range": ("SE2SE2RangeGaussianLikelihoodFactor", lambda v: (
        (v["X0"], v["X1"], 4.0, 0.1), {})),
    "uncertain range": ("UncertainR2RangeGaussianLikelihoodFactor",
                        lambda v: ((v["X0"], v["L1"], 10.0, 1.0, True,
                                    0.5), {})),
}


def _pair(case):
    name, make = CASES[case]
    jv, tv = _vars(JV), _vars(TV)
    jargs, kw = make(jv)
    targs, _ = make(tv)
    return getattr(J, name)(*jargs, **kw), getattr(T, name)(*targs, **kw)


def _points(f, rng, n=64):
    cols = []
    for v in f.vars:
        x = rng.normal(size=(n, v.dim)) * 2.0
        if v.dim == 3:
            x[:, 2] = rng.uniform(-3.0, 3.0, n)
        cols.append(x)
    return np.hstack(cols).astype(np.float32)


def test_every_factor_class_of_the_jax_package_is_registered():
    concrete = set(J.FACTOR_REGISTRY)
    assert set(J.FACTOR_REGISTRY) == set(T.FACTOR_REGISTRY)
    assert {CASES[c][0] for c in CASES} <= concrete


@pytest.mark.parametrize("case", list(CASES))
def test_text_form_matches_jax(case):
    jf, tf = _pair(case)
    jv, tv = _vars(JV), _vars(TV)
    try:
        line = str(jf)
    except NotImplementedError:
        # the JAX package's slip/grip factor has no text form
        with pytest.raises(NotImplementedError):
            str(tf)
        with pytest.raises(ValueError):
            T.Factor.construct_from_text(
                "Factor RelativeGaussianSlipGripSE2Factor X0 X1",
                tv.values())
        return
    assert str(tf) == line
    if case == "SE2 mixture prior":
        # its string carries no weights; neither package parses it
        with pytest.raises(ValueError):
            T.Factor.construct_from_text(line, tv.values())
        return
    ours = str(T.Factor.construct_from_text(line, tv.values()))
    if case == "gaussian prior":
        # the JAX package registers the class without a parser
        assert ours == line
        return
    assert ours == str(JFactor.construct_from_text(line, jv.values()))


@pytest.mark.parametrize("case", list(CASES))
def test_log_pdf_matches_jax(case):
    jf, tf = _pair(case)
    x = _points(jf, np.random.default_rng(3))
    np.testing.assert_allclose(tf.log_pdf(torch.as_tensor(x)).numpy(),
                               np.asarray(jf.log_pdf(x)), **TOL)


@pytest.mark.parametrize("case", ["gaussian prior", "ring prior",
                                  "uncertain ring prior"])
def test_prior_unif_to_sample_matches_jax(case):
    jf, tf = _pair(case)
    d = 3 if case == "gaussian prior" else 2
    u = np.random.default_rng(4).uniform(0.01, 0.99, (50, d)).astype(
        np.float32)
    np.testing.assert_allclose(tf.unif_to_sample(torch.as_tensor(u)).numpy(),
                               np.asarray(jf.unif_to_sample(u)), **TOL)


def test_mixture_prior_unif_to_sample_matches_jax():
    jf, tf = _pair("SE2 mixture prior")
    for u in np.random.default_rng(5).uniform(0.01, 0.99, (20, 3)):
        u = u.astype(np.float32)
        np.testing.assert_allclose(
            tf.unif_to_sample(torch.as_tensor(u)).numpy(),
            np.asarray(jf.unif_to_sample(u)), **TOL)


@pytest.mark.parametrize("case", ["R2 odometry", "R2 range",
                                  "SE2-SE2 range", "uncertain range"])
@pytest.mark.parametrize("given", ["var1", "var2"])
def test_binary_unif_to_sample_matches_jax(case, given):
    jf, tf = _pair(case)
    rng = np.random.default_rng(6)
    src, target = jf.vars if given == "var1" else jf.vars[::-1]
    u = rng.uniform(0.01, 0.99, (40, target.dim)).astype(np.float32)
    known = rng.normal(size=(40, src.dim)).astype(np.float32)
    want = np.asarray(jf.unif_to_sample(u, **{given: known}))
    got = tf.unif_to_sample(torch.as_tensor(u),
                            **{given: torch.as_tensor(known)}).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("given", ["var1", "var2"])
def test_bearing_unif_to_sample_matches_jax(given):
    jf, tf = _pair("bearing")
    rng = np.random.default_rng(7)
    for _ in range(10):
        u = rng.uniform(0.01, 0.99, 2).astype(np.float32)
        known = rng.normal(size=3).astype(np.float32)
        want = np.asarray(jf.unif_to_sample(u, **{given: known}))
        got = tf.unif_to_sample(torch.as_tensor(u),
                                **{given: torch.as_tensor(known)}).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case,observed", [
    ("uncertain ring prior", True), ("uncertain ring prior", False),
    ("uncertain range", True), ("uncertain range", False),
    ("bearing", None), ("SE2-SE2 range", None)])
def test_evaluate_loglike_matches_jax(case, observed):
    jf, tf = _pair(case)
    if observed is not None:
        jf.observed_flag = tf.observed_flag = observed
    for x in _points(jf, np.random.default_rng(8), n=8):
        np.testing.assert_allclose(
            float(tf.evaluate_loglike(torch.as_tensor(x))),
            float(jf.evaluate_loglike(x)), **TOL)


def _moments_close(ours, theirs, what):
    se = np.sqrt(ours.var(0) / len(ours) + theirs.var(0) / len(theirs))
    gap = np.abs(ours.mean(0) - theirs.mean(0))
    assert np.all(gap <= 4 * se + 1e-6), (what, gap, se)


@pytest.mark.parametrize("case", ["gaussian prior", "ring prior",
                                  "SE2 mixture prior"])
def test_prior_draws_match_jax_in_distribution(case):
    jf, tf = _pair(case)
    n = 6000
    theirs = np.asarray(jf.sample(jax.random.PRNGKey(0), n))
    ours = tf.sample(KEY, n, "cpu").numpy()
    assert ours.shape == theirs.shape
    if case == "SE2 mixture prior":
        first = np.linalg.norm(ours[:, :2], axis=1) < 1.0
        assert abs(first.mean() - (np.linalg.norm(
            theirs[:, :2], axis=1) < 1.0).mean()) < 0.03
        ours, theirs = ours[:, :2], theirs[:, :2]
    _moments_close(ours, theirs, case)


@pytest.mark.parametrize("case", ["R2 odometry", "slip/grip odometry",
                                  "bearing", "R2 range", "SE2-SE2 range",
                                  "uncertain range"])
@pytest.mark.parametrize("given", ["var1", "var2", "both"])
def test_binary_draws_match_jax_in_distribution(case, given):
    jf, tf = _pair(case)
    n = 6000
    rng = np.random.default_rng(9)
    v1 = np.tile(rng.normal(size=(1, jf.vars[0].dim)), (n, 1))
    v2 = np.tile(rng.normal(size=(1, jf.vars[1].dim)), (n, 1))
    kw = {"var1": v1} if given == "var1" else \
        {"var2": v2} if given == "var2" else {"var1": v1, "var2": v2}
    theirs = np.asarray(jf.sample(jax.random.PRNGKey(1), **kw))
    ours = tf.sample(KEY, **{k: torch.as_tensor(v, dtype=torch.float32)
                             for k, v in kw.items()}).numpy()
    assert ours.shape == theirs.shape
    if given != "both" and (case.endswith("range") or case == "bearing"):
        # a ring or a uniform distance: compare the distance to the known
        # endpoint (and the heading) instead of the coordinates
        src = (v1 if given == "var1" else v2)[:, :2]
        ours = np.c_[np.linalg.norm(ours[:, :2] - src, axis=1),
                     ours[:, 2:]]
        theirs = np.c_[np.linalg.norm(theirs[:, :2] - src, axis=1),
                       theirs[:, 2:]]
        if case == "SE2-SE2 range":
            ours, theirs = ours[:, :1], theirs[:, :1]
    if case == "slip/grip odometry" and given != "both":
        moved = np.linalg.norm(ours[:, :2] - (v1 if given == "var1"
                                              else v2)[:, :2], axis=1) > 2.5
        moved_j = np.linalg.norm(theirs[:, :2] - (v1 if given == "var1"
                                                  else v2)[:, :2],
                                 axis=1) > 2.5
        assert abs(moved.mean() - moved_j.mean()) < 0.03
        ours, theirs = ours[moved, :2], theirs[moved_j, :2]
    if case == "slip/grip odometry" and given == "both":
        ours, theirs = ours[:, :2], theirs[:, :2]
    _moments_close(ours, theirs, (case, given))


def test_uncertain_draws_need_an_observation():
    _, tf = _pair("uncertain range")
    tf.observed_flag = False
    with pytest.raises(ValueError):
        tf.sample(KEY, var1=torch.zeros(4, 3))


def test_mixed_fg_parses_to_the_same_factor_strings(tmp_path):
    """A file with every class that has a text form, parsed by both
    packages' readers."""
    from nfisam_tpu.io import read_factor_graph_from_file as j_read
    from nfisam_tpu_torch.io import read_factor_graph_from_file as t_read
    jv = _vars(JV)
    lines = [str(v) for v in jv.values()]
    for case in CASES:
        if case in ("gaussian prior", "SE2 mixture prior",
                    "slip/grip odometry"):
            continue
        lines.append(str(_pair(case)[0]))
    path = tmp_path / "mixed.fg"
    path.write_text("\n".join(lines) + "\n")
    _, _, ours = t_read(str(path))
    _, _, theirs = j_read(str(path))
    assert [str(f) for f in ours] == [str(f) for f in theirs]
    assert len(ours) == len(CASES) - 3
