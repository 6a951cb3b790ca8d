"""The closed-form oracles and the MMD variants in the port against the
JAX package's, and the eight-node R^2 chain solved by the port against
its exact posterior.

Tolerances: the moments and the evidence 1e-10 (both float64 numpy), the
MMD variants 1e-6 (the JAX package's are float32).  The eight-node chain
runs at ``REDUCED`` (600 training samples, <= 300 iterations) on the CPU;
its bounds are 2x the JAX package's worst over seeds 0-2 run the same
way (``JAX_REDUCED_WORST``).

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_oracles.py``,
it solves the chain with the JAX package on the CPU for seeds 0-2 at the
example's configuration (``chip_smoke.EIGHT_NODE_ARGS``) and at
``REDUCED``, and prints each seed's worst sample-mean error and worst
relative variance error: ``chip_smoke.JAX_EIGHT_NODE_WORST`` and
``JAX_REDUCED_WORST``."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import nfisam_tpu.core as j_core  # noqa: E402
import nfisam_tpu.factors as j_factors  # noqa: E402
from nfisam_tpu.eval import metrics as J  # noqa: E402
from nfisam_tpu.samplers.joint import StructuredJointFactor as JJoint  # noqa: E402
import nfisam_tpu_torch.core as core  # noqa: E402
import nfisam_tpu_torch.factors as factors  # noqa: E402
from nfisam_tpu_torch.eval import metrics as T  # noqa: E402
from nfisam_tpu_torch.samplers.joint import StructuredJointFactor  # noqa: E402

torch.set_num_threads(1)
REDUCED = dict(local_sample_num=600, flow_iterations=300)
JAX_REDUCED_WORST = (0.12159810545873645, 0.25805724213800363)
GATE_FACTOR = 2.0


def _chain(pkg_core, pkg_factors, rng, n=5, loops=((0, 2), (1, 4))):
    """An R^2 displacement chain with a prior on X0 and two loop
    closures, random moves and covariances from ``rng``."""
    xs = [pkg_core.R2Variable(f"X{i}") for i in range(n)]
    fs = [pkg_factors.UnaryR2GaussianPriorFactor(
        xs[0], rng.normal(size=2), covariance=np.diag(rng.uniform(
            0.1, 1.0, 2)))]
    edges = [(i, i + 1) for i in range(n - 1)] + list(loops)
    for a, b in edges:
        c = rng.uniform(0.05, 0.5, (2, 2))
        fs.append(pkg_factors.R2RelativeGaussianLikelihoodFactor(
            xs[a], xs[b], rng.normal(size=2) * 2, c @ c.T + 0.1 * np.eye(2)))
    return xs, fs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_displacement_moments_match_jax(seed):
    xs, fs = _chain(core, factors, np.random.default_rng(seed))
    jxs, jfs = _chain(j_core, j_factors, np.random.default_rng(seed))

    def args(xs, fs):
        return (xs, {(f.vars[0], f.vars[1]): (f.obs, f.covariance)
                     for f in fs[1:]},
                {xs[0]: (fs[0].mu, fs[0].covariance)})

    mean, cov = T.gaussian_displacement_graph_moments(*args(xs, fs))
    j_mean, j_cov = J.gaussian_displacement_graph_moments(*args(jxs, jfs))
    np.testing.assert_allclose(mean, j_mean, atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(cov, j_cov, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_displacement_evidence_matches_jax(seed):
    xs, fs = _chain(core, factors, np.random.default_rng(seed))
    jxs, jfs = _chain(j_core, j_factors, np.random.default_rng(seed))
    ours = T.gaussian_displacement_graph_evidence(StructuredJointFactor(
        fs, xs))
    theirs = J.gaussian_displacement_graph_evidence(JJoint(jfs, jxs))
    assert abs(ours - theirs) <= 1e-10 * max(1.0, abs(theirs))


@pytest.mark.parametrize("shift", [0.0, 0.3, 2.0])
def test_mmd_variants_match_jax(shift):
    rng = np.random.default_rng(int(10 * shift))
    X = rng.normal(size=(300, 3)).astype(np.float32)
    Y = (rng.normal(size=(250, 3)) + shift).astype(np.float32)
    for sigma in (0.5, 1.0):
        assert abs(T.mmd_unbiased_sq(X, Y, sigma) -
                   float(J.mmd_unbiased_sq(X, Y, sigma))) <= 1e-6
        assert abs(T.mmd_biased(X, Y, sigma) -
                   float(J.mmd_biased(X, Y, sigma))) <= 1e-6
    for k in (0.25, 1.0):
        assert abs(T.mmd_sq_signed(X, Y, k) - J.mmd_sq_signed(X, Y, k)) \
            <= 1e-6


def test_eight_node_chain_matches_its_closed_form():
    """The port's NFiSAM on the chain, seed 0, at ``REDUCED``: every
    variable's sample mean and sample variances within 2x the JAX
    package's worst at the same configuration."""
    steps, samples, solver, oracle = chip_smoke.solve_eight_nodes(
        0, "cpu", **REDUCED)
    assert steps[0]["trained"] == 7
    mean_err, var_err = chip_smoke.eight_node_errors(samples, oracle)
    assert max(mean_err) <= GATE_FACTOR * JAX_REDUCED_WORST[0], mean_err
    assert max(var_err) <= GATE_FACTOR * JAX_REDUCED_WORST[1], var_err
    assert chip_smoke.fused_vs_per_clique(solver)[0] == 0.0


if __name__ == "__main__":
    from nfisam_tpu.solver import NFiSAM as JNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs as JArgs

    for label, over in (("example", {}), ("REDUCED", REDUCED)):
        worst = [0.0, 0.0]
        for seed in chip_smoke.EIGHT_NODE_SEEDS:
            xs, fs, oracle = chip_smoke.eight_node_graph(j_core, j_factors)
            s = JNFiSAM(JArgs(**{**chip_smoke.EIGHT_NODE_ARGS, **over,
                                 "seed": seed}))
            for x in xs:
                s.add_node(x)
            for f in fs:
                s.add_factor(f)
            s.update_physical_and_working_graphs()
            samples = {str(v.name): np.asarray(x)
                       for v, x in s.incremental_inference().items()}
            mean_err, var_err = chip_smoke.eight_node_errors(samples, oracle)
            worst = [max(worst[0], max(mean_err)),
                     max(worst[1], max(var_err))]
            print(f"JAX {label} seed {seed}: worst sample-mean error "
                  f"{max(mean_err)!r} m, worst relative variance error "
                  f"{max(var_err)!r}", flush=True)
        print(f"JAX {label}, seeds 0-2: ({worst[0]!r}, {worst[1]!r})")
