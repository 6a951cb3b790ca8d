"""The masked AR inverse: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its XLA path
(``nsf.flow_inverse_masked``), on the same inputs and carried-across
parameters; tolerance atol 1e-5, rtol 1e-5, as
``tests/test_ar_inverse_pallas.py``.  The CUDA kernel itself is held
against the plain version in ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfisam_tpu.flows.ar_inverse_pallas import (flow_inverse_masked_pallas,
                                                stack_inverse_masked_pallas)
from nfisam_tpu.flows.nsf import NSFConfig as JNSFConfig
from nfisam_tpu.flows.nsf import flow_inverse_masked as j_flow_inverse_masked
from nfisam_tpu.flows.nsf import init_flow_params as j_init_flow_params
from nfisam_tpu.flows.nsf import stack_forward as j_stack_forward
from nfisam_tpu_torch.flows import (NSFConfig, ar_inverse_kernel,
                                    flow_inverse_masked_plain,
                                    flow_params_from_numpy,
                                    stack_inverse_masked_cuda,
                                    stack_inverse_masked_plain)
from nfisam_tpu_torch.flows.ar_inverse import kernel_variant
from nfisam_tpu_torch.flows.model import _select_inverse_fn

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _setup(dim, circular=(), num_flows=1, n=64, seed=0, K=7, h=8,
           sep_dim=0):
    circ = tuple(i in circular for i in range(dim)) if circular else ()
    jcfg = JNSFConfig(dim=dim, num_knots=K, hidden_dim=h,
                      num_flows=num_flows, circular=circ)
    cfg = NSFConfig(dim=dim, num_knots=K, hidden_dim=h,
                    num_flows=num_flows, circular=circ)
    jparams = j_init_flow_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    z = (rng.normal(size=(n, dim)) * 1.5).astype(np.float32)
    mask = np.arange(dim) >= sep_dim
    xp = (rng.normal(size=(n, dim)) * 0.8).astype(np.float32)
    xp[:, mask] = 0.0
    params = flow_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")
    return jcfg, cfg, jparams, params, z, xp, mask


def _plain(params, z, xp, mask, cfg):
    return stack_inverse_masked_plain(params, torch.as_tensor(z),
                                      torch.as_tensor(xp),
                                      torch.as_tensor(mask), cfg).numpy()


@pytest.mark.parametrize("sep_dim", [0, 2, 5])
def test_single_flow_matches_pallas_and_xla(sep_dim):
    jcfg, cfg, jparams, params, z, xp, mask = _setup(6, sep_dim=sep_dim)
    args = (jnp.asarray(z), jnp.asarray(xp), jnp.asarray(mask), jcfg)
    pallas = flow_inverse_masked_pallas(jparams[0], *args, interpret=True)
    xla = j_flow_inverse_masked(jparams[0], *args)
    got = flow_inverse_masked_plain(params[0], torch.as_tensor(z),
                                    torch.as_tensor(xp),
                                    torch.as_tensor(mask), cfg).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    np.testing.assert_array_equal(got[:, ~mask], xp[:, ~mask])


def test_circular_dims_match_pallas():
    jcfg, cfg, jparams, params, z, xp, mask = _setup(
        5, circular=(2, 4), sep_dim=2)
    ref = flow_inverse_masked_pallas(jparams[0], jnp.asarray(z),
                                     jnp.asarray(xp), jnp.asarray(mask),
                                     jcfg, interpret=True)
    np.testing.assert_allclose(_plain(params, z, xp, mask, cfg),
                               np.asarray(ref), **TOL)


def test_stack_of_flows_matches_pallas():
    jcfg, cfg, jparams, params, z, xp, mask = _setup(4, num_flows=2,
                                                     sep_dim=1)
    ref = stack_inverse_masked_pallas(jparams, jnp.asarray(z),
                                      jnp.asarray(xp), jnp.asarray(mask),
                                      jcfg, interpret=True)
    np.testing.assert_allclose(_plain(params, z, xp, mask, cfg),
                               np.asarray(ref), **TOL)


def test_inverse_round_trips_forward():
    """forward(inverse(z)) == z on the inverted columns (inside bounds),
    with the JAX forward: atol 1e-4 as the JAX package's own test."""
    jcfg, cfg, jparams, params, z, xp, mask = _setup(5, n=128, seed=3)
    xp[:] = 0.0
    x = _plain(params, z, xp, mask, cfg)
    z_back, _ = j_stack_forward(jparams, jnp.asarray(x), jcfg)
    inside = np.abs(z) <= cfg.tail_bound
    np.testing.assert_allclose(np.asarray(z_back)[inside], z[inside],
                               rtol=1e-4, atol=1e-4)


def test_non_multiple_shapes_match_pallas():
    jcfg, cfg, jparams, params, z, xp, mask = _setup(9, n=37, seed=5,
                                                     sep_dim=4)
    ref = flow_inverse_masked_pallas(jparams[0], jnp.asarray(z),
                                     jnp.asarray(xp), jnp.asarray(mask),
                                     jcfg, interpret=True)
    np.testing.assert_allclose(_plain(params, z, xp, mask, cfg),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("sep_dim", [2, 8])
def test_main_path_shape_matches_pallas(sep_dim):
    """The solver's shape: d=16 bucket, hidden 8, K=9, one flow, n=1000."""
    jcfg, cfg, jparams, params, z, xp, mask = _setup(
        16, n=1000, K=9, seed=7, sep_dim=sep_dim)
    ref = flow_inverse_masked_pallas(jparams[0], jnp.asarray(z),
                                     jnp.asarray(xp), jnp.asarray(mask),
                                     jcfg, interpret=True)
    np.testing.assert_allclose(_plain(params, z, xp, mask, cfg),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("n, sep_dim, z_scale", [(1, 2, 1.0), (50, 9, 1.0),
                                                  (50, 8, 1.0), (200, 3, 6.0)],
                         ids=["n=1", "all pinned", "sep=d-1",
                              "z beyond the tail bound"])
def test_edge_cases_match_pallas(n, sep_dim, z_scale):
    """One sample; every column pinned (the output is the prefix); only
    the last column inverted; z beyond the tail bound (the identity
    branch)."""
    jcfg, cfg, jparams, params, z, xp, mask = _setup(
        9, n=n, K=9, seed=11, sep_dim=sep_dim)
    z = z * np.float32(z_scale)
    ref = flow_inverse_masked_pallas(jparams[0], jnp.asarray(z),
                                     jnp.asarray(xp), jnp.asarray(mask),
                                     jcfg, interpret=True)
    got = _plain(params, z, xp, mask, cfg)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got[:, ~mask], xp[:, ~mask])
    if z_scale > 1.0:
        outside = np.abs(z) > cfg.tail_bound
        assert outside[:, mask].any()
        np.testing.assert_array_equal(got[outside & mask], z[outside & mask])


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    assert _select_inverse_fn(torch.device("cpu")) is \
        stack_inverse_masked_plain
    assert _select_inverse_fn(torch.device("cuda")) is \
        stack_inverse_masked_cuda
    _, cfg, _, params, z, xp, mask = _setup(16, n=8, K=9)
    before = ar_inverse_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ar_inverse_kernel(params[0], torch.as_tensor(z), torch.as_tensor(xp),
                          torch.as_tensor(mask), cfg)
    assert ar_inverse_kernel.launches == before


def test_kernel_refuses_shapes_it_has_no_instantiation_for():
    """Every shape goes to one of the two kernels (``kernel_variant``): a
    d/h/K of the specialised kernel's instantiations to it, any other d >=
    1, h >= 1, K >= 2 to the generic one; a shape outside that range
    raises before anything launches, as a CPU tensor does."""
    assert kernel_variant(16, 8, 9) == "specialized"
    assert kernel_variant(128, 64, 12) == "specialized"
    assert kernel_variant(6, 8, 7) == "generic"
    assert kernel_variant(16, 8, 11) == "generic"
    before = dict(ar_inverse_kernel.variant_launches)
    _, cfg, _, params, z, xp, mask = _setup(6, n=8, K=7)
    with pytest.raises(ValueError, match="CUDA"):
        ar_inverse_kernel(params[0], torch.as_tensor(z), torch.as_tensor(xp),
                          torch.as_tensor(mask), cfg)
    bad = NSFConfig(dim=6, num_knots=1, hidden_dim=8)
    with pytest.raises(ValueError, match="no kernel"):
        ar_inverse_kernel(params[0], torch.as_tensor(z), torch.as_tensor(xp),
                          torch.as_tensor(mask), bad)
    assert ar_inverse_kernel.variant_launches == before
