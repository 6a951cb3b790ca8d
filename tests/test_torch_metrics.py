"""The port's evaluation metrics against the JAX package's
(``nfisam_tpu/eval/metrics.py``) on seeded numpy inputs: rtol 1e-6 on
float64 host arithmetic, 1e-5 where the JAX function computes in float32
(``geodesic_distance``)."""
import numpy as np
import pytest

import nfisam_tpu.core as jcore
import nfisam_tpu.eval.metrics as jm
import nfisam_tpu_torch.core as tcore
import nfisam_tpu_torch.eval.metrics as tm


def _vars(core):
    return [core.SE2Variable("X0"), core.SE2Variable("X1"),
            core.R2Variable("L0", core.VariableType.Landmark),
            core.SE2Variable("X2")]


def _samples(seed, n=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 11)) * 3.0 + rng.normal(size=11) * 40.0
    for c in (2, 5, 10):
        x[:, c] = np.mod(x[:, c] + np.pi, 2 * np.pi) - np.pi
    return x


def _by_var(core, x):
    out, cur = {}, 0
    for v in _vars(core):
        out[v] = x[:, cur:cur + v.dim]
        cur += v.dim
    return out


@pytest.mark.parametrize("seed", range(3))
def test_sample_mean_rmse_and_array_maps_match_jax(seed):
    x = _samples(seed)
    y = _samples(seed + 10)
    assert tm.rmse(x, y) == pytest.approx(jm.rmse(x, y), rel=1e-12)
    ours, ours_v = tm.sample_mean(x, _vars(tcore))
    theirs, theirs_v = jm.sample_mean(x, _vars(jcore))
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)
    assert [str(v.name) for v in ours_v] == [str(v.name) for v in theirs_v]
    d = tm.array_order_to_dict(x, _vars(tcore))
    np.testing.assert_array_equal(tm.sample_dict_to_array(d), x)
    dj = jm.array_order_to_dict(x, _vars(jcore))
    for (v, a), (w, b) in zip(d.items(), dj.items()):
        assert str(v.name) == str(w.name)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tm.rmse(x, y[:, :3])


@pytest.mark.parametrize("seed", range(3))
def test_point_distances_match_jax(seed):
    x = _samples(seed, n=2)
    p1 = {v: a[0] for v, a in _by_var(tcore, x).items()}
    p2 = {v: a[1] for v, a in _by_var(tcore, x).items()}
    j1 = {v: a[0] for v, a in _by_var(jcore, x).items()}
    j2 = {v: a[1] for v, a in _by_var(jcore, x).items()}
    assert tm.geodesic_distance(p1, p2) == pytest.approx(
        jm.geodesic_distance(j1, j2), rel=1e-5)
    assert tm.translation_distance(p1, p2) == pytest.approx(
        jm.translation_distance(j1, j2), rel=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_alignments_match_jax(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(40, 2)) * 30.0
    th = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    B = (A @ R.T) * 1.1 + rng.normal(size=2) * 5 + rng.normal(
        size=A.shape) * 0.3
    for ours, theirs in zip(tm.kabsch_umeyama(A, B),
                            jm.kabsch_umeyama(A, B)):
        np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9)
    for ours, theirs in zip(tm.rigid_gauge_transform(A, B),
                            jm.rigid_gauge_transform(A, B)):
        np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9)
    Rg, t = tm.rigid_gauge_transform(A, B)
    np.testing.assert_allclose(Rg @ Rg.T, np.eye(2), atol=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_anchor_samples_matches_jax(seed):
    x = _samples(seed)
    rng = np.random.default_rng(seed + 20)
    ref_t = {v: a.mean(0) + rng.normal(size=v.dim)
             for v, a in _by_var(tcore, x).items()}
    ref_j = {w: ref_t[v] for v, w in zip(ref_t, _vars(jcore))}
    ours, ang = tm.anchor_samples(_by_var(tcore, x), ref_t)
    theirs, ang_j = jm.anchor_samples(_by_var(jcore, x), ref_j)
    assert ang == pytest.approx(ang_j, rel=1e-9, abs=1e-12)
    for (v, a), (w, b) in zip(ours.items(), theirs.items()):
        assert str(v.name) == str(w.name)
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_anchor_samples_rejects_variables_without_a_planar_position():
    """A 1-D variable (the JAX function crashes on it) and one whose first
    two columns include a circular dim raise a clear ValueError."""
    x = _samples(0)
    samples = _by_var(tcore, x)
    ref = {v: a.mean(0) for v, a in samples.items()}
    bearing = tcore.R1Variable("B0")
    with pytest.raises(ValueError, match="planar position"):
        tm.anchor_samples({**samples, bearing: x[:, :1]}, ref)
    heading_first = tcore.Variable("H0", 3, rotational_dims={0})
    with pytest.raises(ValueError, match="planar position"):
        tm.anchor_samples({**samples, heading_first: x[:, :3]}, ref)
