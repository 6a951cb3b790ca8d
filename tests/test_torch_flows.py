"""The port's flow layer against the JAX package's, on the same float32
inputs (seeded numpy) and the same flow parameters (carried across from
JAX ``init_flow_params`` as numpy), in NSF_AR and NSF_AR_CS configs:
the RQS in both directions, stack log-dets, the masked inverse, the base
log-prob and the normalizer.  Tolerance: atol 1e-5, rtol 1e-5 on values
(float32 on both sides); log-dets, ``log(numerator) - 2 log(denominator)``
of O(1-10) terms each rounded at ~1e-6 relative by the two frameworks'
own ``exp``/``log``, get atol 5e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfisam_tpu.flows import base_dist as jbase
from nfisam_tpu.flows import model as jmodel
from nfisam_tpu.flows import nsf as jnsf
from nfisam_tpu.flows.rqs import unconstrained_rqs as j_unconstrained_rqs
from nfisam_tpu_torch.flows import base_dist, model, nsf
from nfisam_tpu_torch.flows.rqs import softplus, unconstrained_rqs

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGDET_TOL = dict(atol=5e-5, rtol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("circular", [False, True])
def test_unconstrained_rqs_matches_jax(inverse, circular):
    rng = np.random.default_rng(0)
    n, K = 500, 9
    B = np.pi if circular else 5.0
    x = (rng.normal(size=n) * 2.5).astype(np.float32)   # some outside +-5
    x[:4] = [B, -B, 0.0, B - 1e-6]
    W = rng.normal(size=(n, K)).astype(np.float32)
    H = rng.normal(size=(n, K)).astype(np.float32)
    D = rng.normal(size=(n, K if circular else K - 1)).astype(np.float32)
    got = unconstrained_rqs(_t(x), _t(W), _t(H), _t(D), inverse=inverse,
                            tail_bound=B, circular=circular)
    ref = j_unconstrained_rqs(jnp.asarray(x), jnp.asarray(W),
                              jnp.asarray(H), jnp.asarray(D),
                              inverse=inverse, tail_bound=B,
                              circular=circular)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               **LOGDET_TOL)


def test_softplus_has_no_threshold_switch():
    x = np.linspace(-40, 40, 161).astype(np.float32)
    np.testing.assert_allclose(softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               **TOL)


def _config(dim, circular, num_flows=1, K=9, h=8):
    circ = tuple(i in circular for i in range(dim)) if circular else ()
    return jnsf.NSFConfig(dim=dim, num_knots=K, hidden_dim=h,
                          num_flows=num_flows, circular=circ), \
        nsf.NSFConfig(dim=dim, num_knots=K, hidden_dim=h,
                      num_flows=num_flows, circular=circ)


def carried(jparams):
    """JAX flow parameters as the port's tensors (CPU)."""
    return nsf.flow_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")


CONFIGS = [("NSF_AR", 6, (), 1), ("NSF_AR_CS", 6, (2, 5), 1),
           ("NSF_AR 2 flows", 5, (), 2), ("NSF_AR_CS all", 3, (0, 1, 2), 1)]


@pytest.mark.parametrize("name,dim,circ,flows", CONFIGS)
def test_stack_forward_matches_jax(name, dim, circ, flows):
    jcfg, cfg = _config(dim, circ, flows)
    jparams = jnsf.init_flow_params(jax.random.PRNGKey(3), jcfg)
    x = (np.random.default_rng(1).normal(size=(400, dim)) * 1.3).astype(
        np.float32)
    z, ld = nsf.stack_forward(carried(jparams), _t(x), cfg)
    jz, jld = jnsf.stack_forward(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), **LOGDET_TOL)
    zp, ldp = nsf.stack_forward_perdim(carried(jparams), _t(x), cfg)
    jzp, jldp = jnsf.stack_forward_perdim(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(zp.numpy(), np.asarray(jzp), **TOL)
    np.testing.assert_allclose(ldp.numpy(), np.asarray(jldp), **LOGDET_TOL)


@pytest.mark.parametrize("name,dim,circ,flows", CONFIGS)
@pytest.mark.parametrize("sep_dim", [0, 2])
def test_stack_inverse_masked_matches_jax(name, dim, circ, flows, sep_dim):
    jcfg, cfg = _config(dim, circ, flows)
    jparams = jnsf.init_flow_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(2)
    z = rng.normal(size=(300, dim)).astype(np.float32)
    mask = np.arange(dim) >= sep_dim
    xp = (rng.normal(size=(300, dim)) * 0.7).astype(np.float32)
    xp[:, mask] = 0.0
    got = nsf.stack_inverse_masked(carried(jparams), _t(z), _t(xp),
                                   torch.as_tensor(mask), cfg)
    ref = jnsf.stack_inverse_masked(jparams, jnp.asarray(z), jnp.asarray(xp),
                                    jnp.asarray(mask), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_stack_inverse_with_prefix_matches_jax():
    jcfg, cfg = _config(5, ())
    jparams = jnsf.init_flow_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(200, 3)).astype(np.float32)
    xp = rng.normal(size=(200, 2)).astype(np.float32)
    got = nsf.stack_inverse(carried(jparams), _t(z), cfg, _t(xp), 2)
    ref = jnsf.stack_inverse(jparams, jnp.asarray(z), jcfg, jnp.asarray(xp),
                             2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("circ", [(), (1, 3)])
def test_base_log_prob_matches_jax(circ):
    mask = np.array([i in circ for i in range(4)])
    z = np.random.default_rng(4).normal(size=(300, 4)).astype(np.float32)
    got = base_dist.BaseDistribution(mask).log_prob(_t(z)).numpy()
    ref = np.asarray(jbase.BaseDistribution(mask).log_prob(jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_von_mises_sampler_matches_its_density():
    """Moments of the rejection sampler against the von Mises(0, 1)
    density by quadrature: E[cos] = I1(1)/I0(1) = 0.4464, E[sin] = 0;
    bound 0.02 is > 6 standard errors at n = 20000."""
    g = torch.Generator().manual_seed(0)
    th = base_dist.von_mises_sample(g, (20000,), "cpu").numpy()
    assert th.min() >= -np.pi and th.max() <= np.pi
    grid = np.linspace(-np.pi, np.pi, 20001)
    dens = np.exp(np.asarray(jbase.von_mises_log_prob(jnp.asarray(grid))))
    mean_cos = np.trapezoid(np.cos(grid) * dens, grid)
    assert abs(np.cos(th).mean() - mean_cos) < 0.02
    assert abs(np.sin(th).mean()) < 0.02


@pytest.mark.parametrize("scale_circular", [True, False])
def test_normalizer_matches_jax(scale_circular):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(500, 5)).astype(np.float32) * [3, 1, 0.5, 2, 1]
    x[:, 2] = ((x[:, 2] + 3.0 + np.pi) % (2 * np.pi) - np.pi)   # near +-pi
    x = x.astype(np.float32)
    circ = np.array([False, False, True, False, False])
    mean, std = model.compute_normalizer(_t(x), torch.as_tensor(circ),
                                         scale_circular)
    jmean, jstd = jmodel.compute_normalizer(jnp.asarray(x), circ,
                                            scale_circular)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), **TOL)
    xn = model.normalize(_t(x), mean, std, torch.as_tensor(circ))
    jxn = jmodel.normalize(jnp.asarray(x), jmean, jstd, circ)
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), **TOL)
    back = model.unnormalize(xn[:, 1:], mean, std, torch.as_tensor(circ), 1)
    jback = jmodel.unnormalize(jxn[:, 1:], jmean, jstd, circ, 1)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), **TOL)


def test_negative_log_likelihood_matches_jax():
    jcfg, cfg = _config(6, (3,))
    jparams = jnsf.init_flow_params(jax.random.PRNGKey(6), jcfg)
    x = np.random.default_rng(6).normal(size=(400, 6)).astype(np.float32)
    got = model.negative_log_likelihood(
        carried(jparams), _t(x), cfg,
        base_dist.BaseDistribution(cfg.circular_mask))
    ref = jmodel.negative_log_likelihood(
        jparams, jnp.asarray(x), jcfg,
        jbase.BaseDistribution(jcfg.circular_mask))
    np.testing.assert_allclose(float(got), float(ref), **TOL)
