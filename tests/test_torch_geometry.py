"""The port's SE(2) geometry against the JAX package's, element by element
on the same float32 inputs (seeded numpy), angles at +-pi and the
small-rotation branches included.  Tolerance: atol 1e-5, rtol 1e-5
(float32 on both sides, different op fusion)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfisam_tpu.core import geometry as jgeom
from nfisam_tpu_torch.core import geometry as geom

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _poses(seed, n=256):
    rng = np.random.default_rng(seed)
    p = np.empty((n, 3), np.float32)
    p[:, :2] = rng.normal(size=(n, 2)) * 20.0
    p[:, 2] = rng.uniform(-np.pi, np.pi, n)
    # angles at and around +-pi, and inside the small-rotation switches
    special = np.array([np.pi, -np.pi, np.pi - 1e-6, -np.pi + 1e-6, 0.0,
                        1e-8, -5e-8, 3e-6, -2e-6, 2.5 * np.pi, -3.5 * np.pi],
                       np.float32)
    p[:special.size, 2] = special
    return p


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*[torch.as_tensor(a) for a in arrays]).numpy()
    ref = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    return got, ref


@pytest.mark.parametrize("name", ["se2_compose", "se2_between"])
def test_binary_ops_match_jax(name):
    a, b = _poses(0), _poses(1)
    got, ref = _both(getattr(geom, name), getattr(jgeom, name), a, b)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", ["se2_inverse", "se2_exp", "se2_log",
                                  "se2_det_grad_logmap"])
def test_unary_ops_match_jax(name):
    p = _poses(2)
    if name == "se2_exp":
        p[:, :2] *= 0.05      # tangent vectors of odometry-noise size
    got, ref = _both(getattr(geom, name), getattr(jgeom, name), p)
    np.testing.assert_allclose(got, ref, **TOL)


def test_wrap_angle_matches_jax():
    th = np.concatenate([_poses(3)[:, 2],
                         np.linspace(-10, 10, 257).astype(np.float32)])
    got, ref = _both(geom.wrap_angle, jgeom.wrap_angle, th)
    np.testing.assert_allclose(got, ref, **TOL)
    assert got.min() >= -np.pi and got.max() < np.pi + 1e-6


def test_rot2_apply_matches_jax():
    p = _poses(4)
    got, ref = _both(geom.rot2_apply, jgeom.rot2_apply, p[:, 2], p[:, :2])
    np.testing.assert_allclose(got, ref, **TOL)


def test_exp_log_round_trip():
    v = _poses(5)
    v[:, 2] = np.clip(v[:, 2], -3.0, 3.0)
    back = geom.se2_log(geom.se2_exp(torch.as_tensor(v))).numpy()
    np.testing.assert_allclose(back, v, atol=2e-3, rtol=1e-4)
