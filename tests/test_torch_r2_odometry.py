"""R^2 relative odometry in the port's MAP solvers, against the JAX
package on the CPU and against the closed form.

- The ``rr`` bank of ``FactorBanks`` (the JAX package's
  ``_r2r`` rows: precision Cholesky factor, log normaliser): the banked
  NLL at a point off the optimum within 1e-6 relative of the JAX
  package's, its gradient within 1e-4 of the largest entry, the sparse
  Hessian's product likewise.
- ``IncrementalGaussNewtonMAP`` (step by step and in one update) and
  ``GaussNewtonMAP`` on the eight-node R^2 chain of
  ``examples/toy_examples/r2_relative_eight_nodes.py`` and on the graph
  of the JAX package's ``tests/test_map_solver.py::
  test_map_matches_closed_form_gaussian``: every estimate within 1e-4 of
  the JAX package's solve and within 1e-3 of the exact mean
  (``gaussian_displacement_graph_moments``).
- ``baseline`` on the command line on the eight-node chain written to a
  ``.fg`` by the port's writer, and the R^2 range example
  (``chip_smoke``'s phase 24) at a small size.

Run as a script, ``python tests/test_torch_r2_odometry.py``, it solves
``examples/toy_examples/r2_range_incremental.py`` with the JAX package on
the CPU at ``chip_smoke.R2_RANGE_ARGS`` for seeds 0-2 and prints L1's mean
ranges and the repair logs (``chip_smoke.JAX_R2_RANGE_REPAIR_LOGS``).
"""
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
import nfisam_tpu.core as jcore  # noqa: E402
import nfisam_tpu.factors as jfactors  # noqa: E402
import nfisam_tpu_torch.core as tcore  # noqa: E402
import nfisam_tpu_torch.factors as tfactors  # noqa: E402
from nfisam_tpu.solver import banked_joint as jb  # noqa: E402
from nfisam_tpu.solver.map_solver import GaussNewtonMAP as JGaussNewtonMAP  # noqa: E402
from nfisam_tpu_torch.eval import gaussian_displacement_graph_moments  # noqa: E402
from nfisam_tpu_torch.solver import (GaussNewtonMAP,  # noqa: E402
                                     IncrementalGaussNewtonMAP)
from nfisam_tpu_torch.solver import banked_joint as tb  # noqa: E402

torch.set_num_threads(1)


GRAPHS = {"eight-node chain": chip_smoke.eight_node_graph,
          "closed form": chip_smoke.closed_form_graph}


def _exact_mean(build):
    xs, _, oracle = build(tcore, tfactors)
    mu, _ = gaussian_displacement_graph_moments(*oracle)
    return np.asarray(mu)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_r2_odometry_bank_matches_jax(name):
    build = GRAPHS[name]
    jn, jf, _ = build(jcore, jfactors)
    tn, tf, _ = build(tcore, tfactors)
    jm = jb.IncrementalGaussNewtonMAP()
    jm.update(jn, jf)
    tm = IncrementalGaussNewtonMAP(device="cpu")
    tm.update(tn, tf)
    banks = tm.banks.to_device("cpu")
    assert "rr" in banks and banks["rr"][0].shape[0] == \
        sum(isinstance(f, tfactors.R2RelativeGaussianLikelihoodFactor)
            for f in tf)
    rng = np.random.default_rng(2)
    x = (_exact_mean(build) + rng.normal(size=tm.dim) * 0.3).astype(
        np.float32)
    v = rng.normal(size=tm.dim).astype(np.float32)
    sig, jbanks = jm._device_banks()
    pad = sig[0] - tm.dim
    xp, vp = (jnp.asarray(np.concatenate([a, np.zeros(pad, np.float32)]))
              for a in (x, v))

    def jnll(y):
        return jb._banked_nll(y, jbanks)

    jg = jax.grad(jnll)
    nll = float(jnll(xp))
    grad = np.asarray(jg(xp))[:tm.dim]
    hvp = np.asarray(jax.jvp(jg, (xp,), (vp,))[1])[:tm.dim]
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    assert abs(float(tb._banked_nll(xt, banks)) - nll) <= 1e-6 * abs(nll)
    hs = tb.SparseHessian(banks, tm.dim)
    for ours, theirs in ((hs.grad(xt), grad), (hs.mv(hs.at(xt), vt), hvp)):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4,
                                   atol=1e-4 * np.abs(theirs).max())


def _incremental(m, xs, fs, one_update):
    """Solve step by step (a node and the factors it closes) or all at
    once; returns the stacked estimate."""
    steps = [(xs, fs)] if one_update else [
        ([x], [f for f in fs if x in f.vars and
               all(v in xs[:i + 1] for v in f.vars)])
        for i, x in enumerate(xs)]
    for ns, nfs in steps:
        m.update(ns, nfs)
        m.solve()
    res = m.results()
    return np.concatenate([np.asarray(res[v])[:v.dim] for v in xs])


@pytest.mark.parametrize("one_update", [False, True],
                         ids=["step by step", "one update"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_incremental_map_solves_r2_odometry(name, one_update):
    build = GRAPHS[name]
    jn, jf, _ = build(jcore, jfactors)
    tn, tf, _ = build(tcore, tfactors)
    theirs = _incremental(jb.IncrementalGaussNewtonMAP(), jn, jf,
                          one_update)
    ours = _incremental(IncrementalGaussNewtonMAP(device="cpu"), tn, tf,
                        one_update)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    np.testing.assert_allclose(ours, _exact_mean(build), atol=1e-3)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gauss_newton_map_solves_r2_odometry(name):
    build = GRAPHS[name]
    jn, jf, _ = build(jcore, jfactors)
    tn, tf, _ = build(tcore, tfactors)
    xj, cj, _, _ = JGaussNewtonMAP(jn, jf).solve()
    xt, ct, _, _ = GaussNewtonMAP(tn, tf, device="cpu").solve()
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    np.testing.assert_allclose(xt, _exact_mean(build), atol=1e-3)
    np.testing.assert_allclose(ct, cj, rtol=1e-3,
                               atol=1e-3 * np.abs(cj).max())



def test_chip_smoke_r2_phase_runs_on_cpu(tmp_path):
    """Phase 24's paths on the CPU: every MAP estimate (``baseline`` on the
    chain written by the port's writer included) within
    ``chip_smoke.R2_MAP_TOL_M`` of the exact mean, and the R^2 range
    example's solve with mode repair on, at a small size."""
    errs = chip_smoke.r2_map_errors("cpu", str(tmp_path))
    assert len(errs) == 5
    assert all(e <= chip_smoke.R2_MAP_TOL_M for e in errs.values()), errs
    steps, samples, repair_log = chip_smoke.solve_r2_range(
        0, "cpu", flow_iterations=60, local_sample_num=300,
        posterior_sample_num=200)
    assert len(steps) == 4 and repair_log == []
    ranges = chip_smoke.r2_ranges(samples)
    assert all(np.isfinite(r) for r in ranges.values())


def jax_r2_range_reference():
    """The JAX package's solve of the R^2 range example on the CPU at
    ``chip_smoke.R2_RANGE_ARGS``, seeds 0-2: L1's mean range to each
    measured pose and the repair log (printed beside the card's)."""
    from nfisam_tpu.solver import NFiSAM as JNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs

    for seed in chip_smoke.R2_RANGE_SEEDS:
        solver = JNFiSAM(JNFiSAMArgs(**{**chip_smoke.R2_RANGE_ARGS,
                                        "seed": seed}))
        for ns, fs in chip_smoke.r2_range_graph(jcore, jfactors):
            for n in ns:
                solver.add_node(n)
            for f in fs:
                solver.add_factor(f)
            solver.update_physical_and_working_graphs()
            samples = solver.incremental_inference()
        ranges = chip_smoke.r2_ranges({str(v.name): np.asarray(x)
                                       for v, x in samples.items()})
        print(f"JAX R^2 range example seed {seed}: L1's mean range "
              f"{ranges}, repair log {solver.mode_repair_log}", flush=True)


if __name__ == "__main__":
    jax_r2_range_reference()
