"""The port's NUTS and SMC samplers against the JAX package's on the CPU.

Element by element (float32, seeded numpy inputs), atol and rtol 1e-6:
``_find_next_beta`` (the tempering increment's bisection; no random
draws) on likelihood vectors that take each of its branches, and one
``_leapfrog`` step on the closed-form Gaussian graph's joint gradient.

In distribution (the port draws from ``torch.Generator``s), at the
settings and tolerances of ``tests/test_samplers.py``: all three global
samplers against the closed-form posterior of a linear-Gaussian graph
(means atol 0.1, variances rtol 0.15), nested sampling (400 live) and
SMC (4000 particles) on the ring graph's analytic arc, and the NUTS
transition's direction symmetry on a 1-D Gaussian.  The long NUTS ring
oracle (12000 draws of 8 chains) runs on the card (``chip_smoke.py``).

Run as a script, this file prints the JAX package's figures behind the
card's gates for ``reference --sampler nuts|smc`` on case1: the MMD of
the translation columns against ``data/case1_ref/ns_step5.sample`` for
seeds 0-2 (``python tests/test_torch_nuts_smc.py``, a few minutes)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from chip_smoke import gaussian_graph, ring_graph  # noqa: E402

import nfisam_tpu.core as jcore
import nfisam_tpu.factors as jfactors
import nfisam_tpu_torch.core as tcore
import nfisam_tpu_torch.factors as tfactors
from nfisam_tpu.samplers import JointFactor as JJoint
from nfisam_tpu.samplers.nuts import _leapfrog as j_leapfrog
from nfisam_tpu.samplers.smc import _find_next_beta as j_find_next_beta
from nfisam_tpu_torch.eval import mmd
from nfisam_tpu_torch.samplers import (GlobalMCMCSampler,
                                       GlobalNestedSampler, GlobalSMCSampler,
                                       JointFactor)
from nfisam_tpu_torch.samplers.nuts import (NUTSConfig, _leapfrog,
                                            build_nuts_kernel)
from nfisam_tpu_torch.samplers.smc import _find_next_beta
from nfisam_tpu_torch.utils.keys import torch_generator


torch.set_num_threads(1)
EXACT = dict(atol=1e-6, rtol=1e-6)
KEY = np.array([0, 3], dtype=np.uint32)


@pytest.mark.parametrize("beta,scale", [(0.0, 1.0), (0.0, 50.0),
                                        (0.4, 300.0), (0.9, 0.01)])
def test_find_next_beta_matches_jax(beta, scale):
    L = (np.random.default_rng(0).normal(size=2000) * scale).astype(
        np.float32)
    got = float(_find_next_beta(torch.as_tensor(L), beta, 1000.0))
    want = float(j_find_next_beta(jnp.asarray(L), beta, 1000.0))
    np.testing.assert_allclose(got, want, **EXACT)


def test_one_leapfrog_matches_jax():
    vars_, fs, _ = gaussian_graph(tcore, tfactors)
    jvars, jfs, _ = gaussian_graph(jcore, jfactors)
    ours, theirs = JointFactor(fs, vars_), JJoint(jfs, jvars)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(4, 4)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    got = _leapfrog(ours.grad_x_log_pdf, torch.as_tensor(q),
                    torch.as_tensor(p), 0.1, torch.as_tensor(inv_mass))
    want = j_leapfrog(theirs.grad_x_log_pdf, jnp.asarray(q), jnp.asarray(p),
                      jnp.float32(0.1), jnp.asarray(inv_mass))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **EXACT)


@pytest.mark.parametrize("sampler_cls,kwargs", [
    (GlobalNestedSampler, {"live_points": 600, "max_iters": 2500}),
    (GlobalSMCSampler, {"num_samples": 4000}),
    (GlobalMCMCSampler, {"num_samples": 3000, "num_warmup": 500}),
])
def test_global_samplers_match_closed_form(sampler_cls, kwargs):
    vars_, fs, (mu, Sigma) = gaussian_graph(tcore, tfactors)
    s = sampler_cls(nodes=vars_, factors=fs, device="cpu").sample(**kwargs)
    np.testing.assert_allclose(s.mean(0), mu, atol=0.1)
    np.testing.assert_allclose(np.diag(np.cov(s.T)), np.diag(Sigma),
                               rtol=0.15)


def check_ring(s):
    for name, (err, bound) in chip_smoke.ring_errors(s).items():
        assert err < bound, name


def test_nested_and_smc_ring_posterior():
    vars_, fs = ring_graph(tcore, tfactors)
    s_ns = GlobalNestedSampler(nodes=vars_, factors=fs, device="cpu").sample(
        live_points=400, max_iters=1500)
    check_ring(s_ns)
    s = GlobalSMCSampler(nodes=vars_, factors=fs, device="cpu").sample(
        num_samples=4000)
    check_ring(s)
    rng = np.random.default_rng(0)
    a = s[rng.choice(len(s), 500, replace=False)][:, 2:]
    b = s_ns[rng.choice(len(s_ns), min(500, len(s_ns)), replace=False)][:, 2:]
    assert mmd(a, b) < 0.12


# the share of the 512 chains that move right, and that move left: the
# JAX package's right share over its seeds 0-15 (``python
# tests/test_torch_nuts_smc.py symmetry``) has mean 0.4229 and std 0.0244,
# below 1/2 because ~15% of its chains stay at 0; within 3 of its std
SHARE_BAND = (0.4229 - 3 * 0.0244, 0.4229 + 3 * 0.0244)


def test_nuts_transition_direction_symmetric():
    """A NUTS transition on a symmetric target from a symmetric start
    gives a symmetric displacement (a leftward subtree's U-turn check
    reads the displacement flipped): the chains that move right and
    those that move left each make a share within ``SHARE_BAND``."""
    kernel = build_nuts_kernel(lambda q: -0.5 * torch.sum(q * q, dim=1), 1,
                               NUTSConfig(max_treedepth=6))
    q1, _ = kernel(torch_generator(np.array([0, 7], np.uint32), "cpu"),
                   torch.zeros(512, 1), 0.25, torch.ones(1))
    d = q1[:, 0].numpy()
    assert abs(d.mean()) < 0.15, d.mean()
    for share in ((d > 0).mean(), (d < 0).mean()):
        assert SHARE_BAND[0] < share < SHARE_BAND[1], share
    assert d.std() > 0.3


def jax_reference_figures():
    """The JAX package's ``reference --sampler nuts|smc`` on case1 (CPU),
    seeds 0-2: MMD of the translation columns against ns_step5.sample,
    the protocol of ``chip_smoke.ns_step5_mmd``."""
    import time

    from nfisam_tpu.io import graph_file_parser as j_parse
    from nfisam_tpu.samplers import GlobalMCMCSampler as JMCMC
    from nfisam_tpu.samplers import GlobalSMCSampler as JSMC

    nodes, _, factors = j_parse(chip_smoke.CASE1_FG, "fg")
    dims = [(str(v.name), v.dim) for v in nodes]
    for name in ("nuts", "smc"):
        worst = 0.0
        for seed in (0, 1, 2):
            key = np.array([0, seed], dtype=np.uint32)
            t0 = time.time()
            if name == "nuts":
                s = JMCMC(nodes, factors).sample(key=key, num_samples=1000)
            else:
                s = JSMC(nodes, factors).sample(key=key, num_samples=1000)
            m = chip_smoke.ns_step5_mmd(np.asarray(s), dims)
            worst = max(worst, m)
            print(f"JAX {name} seed {seed}: MMD to ns_step5 {m!r} "
                  f"({time.time() - t0:.1f} s)")
        print(f"JAX {name}: worst {worst!r}")


def symmetry_scatter(seeds=range(16), arms=("JAX", "port")) -> None:
    """The direction-symmetry transition (512 chains from 0 on a 1-D
    Gaussian, max_treedepth 6, eps 0.25) by each package for each seed:
    the shares of chains that moved right, stayed at 0 (the multinomial
    pick returned the start) and moved left, the mean and the std; then
    each share's mean, std and range over the seeds.  The JAX package's
    test draws with ``PRNGKey(7)``, the port's with ``[0, 7]``; here the
    JAX package takes ``PRNGKey(s)`` and the port ``[s, 7]``."""
    from nfisam_tpu.samplers.nuts import NUTSConfig as JConfig
    from nfisam_tpu.samplers.nuts import build_nuts_kernel as j_build

    cfg = NUTSConfig(max_treedepth=6)
    t_kernel = build_nuts_kernel(lambda q: -0.5 * torch.sum(q * q, dim=1),
                                 1, cfg)
    j_kernel = jax.jit(jax.vmap(lambda k, q: j_build(
        lambda x: -0.5 * jnp.sum(x * x), 1, JConfig(max_treedepth=6))(
            k, q, jnp.float32(0.25), jnp.ones(1))))
    for arm in arms:
        rows = []
        for s in seeds:
            if arm == "JAX":
                q1, _ = j_kernel(jax.random.split(jax.random.PRNGKey(s), 512),
                                 jnp.zeros((512, 1)))
                d = np.asarray(q1)[:, 0]
            else:
                q1, _ = t_kernel(torch_generator(np.array([s, 7], np.uint32),
                                                 "cpu"),
                                 torch.zeros(512, 1), 0.25, torch.ones(1))
                d = q1[:, 0].numpy()
            rows.append(((d > 0).mean(), (d == 0).mean(), (d < 0).mean()))
            print(f"{arm} seed {s}: right {rows[-1][0]!r} stayed "
                  f"{rows[-1][1]!r} left {rows[-1][2]!r} mean "
                  f"{float(d.mean())!r} std {float(d.std())!r}", flush=True)
        for i, what in enumerate(("right", "stayed", "left")):
            x = np.array([r[i] for r in rows])
            print(f"{arm} {what} over seeds {list(seeds)}: mean "
                  f"{float(x.mean())!r} std {float(x.std(ddof=1))!r} range "
                  f"[{float(x.min())!r}, {float(x.max())!r}]", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["symmetry"]:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    symmetry_scatter(arms=tuple(sys.argv[2:]) or ("JAX", "port"))
elif __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax_reference_figures()
