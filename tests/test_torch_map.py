"""The port's MAP baselines against the JAX package's, on the CPU: the
banked negative log joint, its gradient and Hessian-vector product, the
masked conjugate gradients, ``GaussNewtonMAP`` and the joint factor (the
incremental MAP and its floor: ``test_torch_incremental_map.py``).

Tolerances: the banked NLL rtol 1e-5; its gradient and HVP rtol 1e-4 of
their largest entry (float32 on both sides; the points lie 1-5 cm and a
few mrad off the truth, where single float32 roundings of ~100 m
coordinates move small entries by more than 1e-4 of themselves); CG 1e-5;
``GaussNewtonMAP`` 1e-4 on the MAP and rtol 1e-3 on the Laplace
covariance.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_map.py``, it
prints the JAX package's figures for ``chip_smoke.py``'s gates on the CPU:
the full-size MAP floors (``chip_smoke.MAP_CASES``), the plaza prefixes'
floors, and the Manhattan-scale smoke at ``chip_smoke.py``'s
configuration with the runner's read-out."""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.samplers import joint as j_joint  # noqa: E402
from nfisam_tpu.solver import banked_joint as jb  # noqa: E402
from nfisam_tpu.solver.map_solver import GaussNewtonMAP as JGaussNewtonMAP  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.samplers import StructuredJointFactor  # noqa: E402
from nfisam_tpu_torch.solver import (GaussNewtonMAP,  # noqa: E402
                                     IncrementalGaussNewtonMAP)
from nfisam_tpu_torch.scripts import manhattan_scale_run as msr  # noqa: E402
from nfisam_tpu_torch.solver import banked_joint as tb  # noqa: E402

torch.set_num_threads(1)
CASE1 = chip_smoke.CASE1_FG
CASE1_DA = chip_smoke.CASE1_DA_FG
LAWNMOWER = os.path.join(REPO, "data", "lawnmower_4x4_factor_graph.fg")


class JaxFloat64MAP(jb.IncrementalGaussNewtonMAP):
    """The JAX package's incremental MAP with its own LM-CG program run in
    float64 on its own banks (the port's ``MAP_DTYPE``): the reference for
    the port's solves where the JAX package's float32 solve stops at its
    iteration cap, and so stops where its rounding takes it."""

    def solve(self, timer=None):
        t0 = time.time()
        warm = self._solved_once
        with self._device_ctx(), jax.enable_x64(True):
            if self._x is None:
                self._cold_start()
            sig, banks = self._device_banks()
            banks = jax.tree.map(
                lambda a: a.astype(jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, banks)
            x0 = np.zeros(sig[0], np.float64)
            x0[:self.dim] = self._x[:self.dim]
            x, f_val, it = jb._solve_program(sig, self.cfg, warm)(
                jnp.asarray(x0), banks)
            x = np.asarray(x)[:self.dim].astype(np.float32)
        self._x = x.copy()
        self._solved_once = True
        self.last_iterations = int(it)
        self.last_nll = float(f_val)
        if timer is not None:
            timer.append(time.time() - t0)
        return x


def _first_poses(path, n_poses):
    """Both packages' nodes, truth and factors of a graph cut to its first
    ``n_poses`` poses and the landmarks those see (5 poses a step, as the
    plaza runs group them)."""
    out = []
    for parse, group in ((lambda p: j_parse(p, "fg"), j_group),
                         (graph_file_parser,
                          group_nodes_factors_incrementally)):
        nodes, truth, factors = parse(path)
        batches = group(nodes, factors, incremental_step=5)[:n_poses // 5]
        out.append(([n for ns, _ in batches for n in ns], truth,
                    [f for _, fs in batches for f in fs]))
    return out


def _graphs(name):
    if name == "plaza1_10":
        return _first_poses(chip_smoke.PLAZA1_FG, 10)
    path = {"case1": CASE1, "case1_da": CASE1_DA}[name]
    return [j_parse(path, "fg"), graph_file_parser(path)]


def _near_truth(m, truth, seed):
    """The truth column moved by 1-5 cm and a few mrad (seeded)."""
    rng = np.random.default_rng(seed)
    x = np.zeros(m.dim, np.float32)
    for v in m.vars:
        t = np.asarray(truth[v], np.float64)[:v.dim]
        scale = np.array([0.03, 0.03, 0.003])[:v.dim]
        x[m.offset[v]:m.offset[v] + v.dim] = t + rng.normal(size=v.dim) * \
            scale
    return x


def _both_banked(name):
    """(JAX nll, grad, hvp functions at its padded state; the port's
    banks; the shared point x and tangent v)."""
    (jn, jt, jf), (tn, tt, tf) = _graphs(name)
    jm = jb.IncrementalGaussNewtonMAP()
    jm.update(jn, jf)
    tm = IncrementalGaussNewtonMAP(device="cpu")
    tm.update(tn, tf)
    assert [str(v.name) for v in tm.vars] == [str(v.name) for v in jm.vars]
    x = _near_truth(tm, tt, seed=3)
    v = np.random.default_rng(4).normal(size=tm.dim).astype(np.float32)
    sig, jbanks = jm._device_banks()
    pad = sig[0] - tm.dim
    xp, vp = (jnp.asarray(np.concatenate([a, np.zeros(pad, np.float32)]))
              for a in (x, v))
    def jnll(y):
        return jb._banked_nll(y, jbanks)

    jg = jax.grad(jnll)
    theirs = (float(jax.jit(jnll)(xp)), np.asarray(jax.jit(jg)(xp))[:tm.dim],
              np.asarray(jax.jit(lambda a, b: jax.jvp(jg, (a,), (b,))[1])(
                  xp, vp))[:tm.dim])
    return theirs, tm.banks.to_device("cpu"), torch.as_tensor(x), \
        torch.as_tensor(v)


GRAPHS = ["case1", "case1_da", "plaza1_10"]


@pytest.fixture(scope="module", params=GRAPHS)
def banked(request):
    return _both_banked(request.param)


def _close_to_largest(ours, theirs, rtol):
    np.testing.assert_allclose(ours, theirs, rtol=rtol,
                               atol=rtol * np.abs(theirs).max())


def test_banked_nll_matches_jax(banked):
    (nll, _, _), banks, x, _ = banked
    assert abs(float(tb._banked_nll(x, banks)) - nll) <= 1e-5 * abs(nll)


def test_banked_gradient_matches_jax(banked):
    (_, grad, _), banks, x, _ = banked
    ours = torch.func.grad(lambda y: tb._banked_nll(y, banks))(x)
    _close_to_largest(ours.numpy(), grad, 1e-4)


def test_banked_hvp_matches_jax(banked):
    """Both forms of the port's product: ``jvp`` of ``grad`` (the JAX
    package's) and the sparse Hessian the LM loop uses."""
    (_, _, hvp), banks, x, v = banked
    g = torch.func.grad(lambda y: tb._banked_nll(y, banks))
    _close_to_largest(torch.func.jvp(g, (x,), (v,))[1].numpy(), hvp, 1e-4)
    H = tb.SparseHessian(banks, x.shape[0]).at(x)
    _close_to_largest(torch.mv(H, v).numpy(), hvp, 1e-4)


def test_fixed_order_sums_match_jax(banked):
    """The gradient and product the LM loop takes (``SparseHessian.grad``
    and ``.mv``, summed in a fixed order) against the JAX package's."""
    (_, grad, hvp), banks, x, v = banked
    hs = tb.SparseHessian(banks, x.shape[0])
    _close_to_largest(hs.grad(x).numpy(), grad, 1e-4)
    _close_to_largest(hs.mv(hs.at(x), v).numpy(), hvp, 1e-4)


@pytest.mark.parametrize("maxiter", [3, 40, 300])
def test_conjugate_gradient_matches_jax_cg(maxiter):
    """A fixed SPD operator (condition ~100): after 3 and 40 iterations
    and at 300, where the residual test has frozen the iterates."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    A = (Q * np.geomspace(1.0, 100.0, 40)) @ Q.T
    b = rng.normal(size=40)
    ref, _ = jax.scipy.sparse.linalg.cg(
        lambda p: jnp.asarray(A, jnp.float32) @ p,
        jnp.asarray(b, jnp.float32), maxiter=maxiter, tol=1e-8)
    At = torch.as_tensor(A, dtype=torch.float32)
    ours = tb.conjugate_gradient(lambda p: At @ p,
                                 torch.as_tensor(b, dtype=torch.float32),
                                 maxiter)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    if maxiter == 300:
        np.testing.assert_allclose(A @ ours.numpy(), b, atol=1e-3)


def _gauss_newton_both(path, seed):
    runs = []
    for parse, new in ((lambda p: j_parse(p, "fg"), JGaussNewtonMAP),
                       (graph_file_parser,
                        lambda n, f: GaussNewtonMAP(n, f, device="cpu"))):
        nodes, truth, factors = parse(path)
        m = new(nodes, factors)
        rng = np.random.default_rng(seed)
        x0 = np.concatenate([
            np.asarray(truth[v], np.float32)[:v.dim] +
            rng.normal(size=v.dim).astype(np.float32) *
            np.array([0.05, 0.05, 0.005], np.float32)[:v.dim]
            for v in m.joint.vars])
        runs.append(m.solve(x0=x0))
    return runs


def test_gauss_newton_map_matches_jax():
    """case1 from the truth moved by a few cm and mrad: the MAP within
    1e-4, the Laplace covariance rtol 1e-3."""
    (xj, cj, fj, _), (xt, ct, ft, _) = _gauss_newton_both(CASE1, seed=5)
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    np.testing.assert_allclose(ct, cj, rtol=1e-3,
                               atol=1e-3 * np.abs(cj).max())
    assert abs(ft - fj) <= 1e-5 * abs(fj)


def _joint_pair(path):
    nodes_j, _, factors_j = j_parse(path, "fg")
    nodes_t, truth, factors_t = graph_file_parser(path)
    return (j_joint.StructuredJointFactor(factors_j, nodes_j),
            StructuredJointFactor(factors_t, nodes_t), truth)


@pytest.mark.parametrize("path", [CASE1, CASE1_DA, LAWNMOWER],
                         ids=["case1", "case1_da", "lawnmower_4x4"])
def test_structured_joint_split_and_log_pdf_match_jax(path):
    theirs, ours, truth = _joint_pair(path)

    def names(fs):
        return [str(f) for f in fs]

    assert names(ours.tree_priors) == names(theirs.tree_priors)
    assert names(ours.likelihood_factors) == names(theirs.likelihood_factors)
    assert [(str(f), s) for f, s in ours.tree_binaries] == \
        [(str(f), s) for f, s in theirs.tree_binaries]
    assert ours.dim == theirs.dim
    assert {str(v.name): i for v, i in ours.var_to_indices.items()} == \
        {str(v.name): i for v, i in theirs.var_to_indices.items()}
    rng = np.random.default_rng(6)
    x0 = np.concatenate([np.asarray(truth[v], np.float32)[:v.dim]
                         for v in ours.vars])
    x = (x0 + rng.normal(size=(64, ours.dim)) * 0.05).astype(np.float32)
    lp = np.asarray(theirs.log_pdf(x))
    np.testing.assert_allclose(ours.log_pdf(torch.as_tensor(x)).numpy(), lp,
                               rtol=1e-5, atol=1e-5 * np.abs(lp).max())


def test_banked_joint_equals_joint_log_pdf():
    """``GaussNewtonMAP`` evaluates the joint through the banks: the same
    density as ``StructuredJointFactor.log_pdf``, one row at a time."""
    nodes, truth, factors = graph_file_parser(CASE1_DA)
    m = GaussNewtonMAP(nodes, factors, device="cpu")
    x0 = np.concatenate([np.asarray(truth[v], np.float32)[:v.dim]
                         for v in m.joint.vars])
    rng = np.random.default_rng(7)
    for _ in range(4):
        x = torch.as_tensor((x0 + rng.normal(size=x0.shape) * 0.1).astype(
            np.float32))
        joint = float(m.joint.log_pdf(x[None])[0])
        assert abs(float(m._neg_logp(x)) + joint) <= 1e-5 * abs(joint)


def test_joint_sample_draws_every_variable_on_the_tree():
    """The ancestral draw: one key a tree factor from ``split_host``, the
    same key stream giving the same draws, and the tree factors' draws
    consistent with the observations (odometry chains near the truth)."""
    _, ours, truth = _joint_pair(CASE1)
    key = np.array([0, 17], np.uint32)
    a = ours.sample(key, 500, "cpu")
    assert a.shape == (500, ours.dim) and bool(torch.isfinite(a).all())
    assert torch.equal(a, ours.sample(key, 500, "cpu"))
    for v in ours.vars:
        if v.dim == 3:
            idx = ours.var_to_indices[v]
            mean = a[:, idx[:2]].mean(0).numpy()
            assert np.linalg.norm(mean - np.asarray(truth[v])[:2]) < 2.0


def test_gauss_newton_best_of_512_start_and_laplace_samples():
    """No ``x0``: the start is the best of 512 ancestral draws; Laplace
    samples come from a generator seeded by the key."""
    nodes, truth, factors = graph_file_parser(CASE1)
    m = GaussNewtonMAP(nodes, factors, device="cpu")
    x, cov, nll, it = m.solve()
    assert x.shape == (m.dim,) and cov.shape == (m.dim, m.dim)
    assert np.isfinite(nll) and 0 < it <= 100
    key = np.array([3, 4], np.uint32)
    s = m.sample(key, 2000)
    np.testing.assert_array_equal(s, m.sample(key, 2000))
    assert np.abs(s.mean(0) - x).max() < 0.1
    rmse, _ = chip_smoke.point_errors(m.results(), truth)
    assert rmse < 1.0


def test_map_solvers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    nodes, _, factors = graph_file_parser(CASE1)
    with pytest.raises(RuntimeError, match="CUDA"):
        IncrementalGaussNewtonMAP()
    with pytest.raises(RuntimeError, match="CUDA"):
        GaussNewtonMAP(nodes, factors)


def test_unsupported_factor_type_raises():
    from nfisam_tpu_torch.core import SE2Variable
    from nfisam_tpu_torch.factors.factors import UndefinedFactor
    m = IncrementalGaussNewtonMAP(device="cpu")
    a, b = SE2Variable("A"), SE2Variable("B")
    with pytest.raises(NotImplementedError, match="UndefinedFactor"):
        m.update([a, b], [UndefinedFactor([a, b])])


# ---------------------------------------------------------------------------
# the JAX package's figures for chip_smoke.py's gates (run as a script)
# ---------------------------------------------------------------------------
def map_spread(label, parse, new_solver, n_moved=3):
    """One of ``chip_smoke.MAP_CASES`` through a package's parser and the
    case's MAP solver (``chip_smoke.map_case``'s ``new_solver``), from the
    truth and from the truth moved by 2e-7 of itself (``n_moved`` seeded
    draws, float32 starts): [(RMSE m, max error m, final NLL, LM
    iterations)] a start.  How far a figure moves here is how far it is
    defined."""
    path, kind = chip_smoke.MAP_CASES[label]
    nodes, truth, factors = parse(path)
    if kind == "laplace":
        m = new_solver(nodes, factors)
        order = m.joint.vars
    else:
        m = new_solver()
        m.update(nodes, factors)
        order = m.vars
    x = np.concatenate([np.asarray(truth[v], np.float64)[:v.dim]
                        for v in order])
    rng = np.random.default_rng(0)
    starts = [x] + [x * (1 + 2e-7 * rng.standard_normal(x.shape))
                    for _ in range(n_moved)]
    out = []
    for x0 in starts:
        if kind == "laplace":
            m.solve(x0=x0.astype(np.float32))
            nll, iters = m.final_nll, m.iterations
        else:
            m._x, m._solved_once = x0.astype(np.float32), True
            m.solve()
            nll, iters = m.last_nll, m.last_iterations
        out.append((*chip_smoke.point_errors(m.results(), truth), nll,
                    iters))
    return out


def jax_prefix_floor(path, steps, new=jb.IncrementalGaussNewtonMAP):
    nodes, truth, factors = j_parse(path, "fg")
    batches = j_group(nodes, factors, incremental_step=5)[:steps]
    m = new()
    m.update([n for ns, _ in batches for n in ns],
             [f for _, fs in batches for f in fs])
    return chip_smoke.floor_from_truth(m, truth)


def jax_manhattan(steps=chip_smoke.MANHATTAN_STEPS):
    """The JAX package's Manhattan-scale smoke at chip_smoke's
    configuration on the CPU, with the runner's read-out."""
    from nfisam_tpu.parallel import ParallelNFiSAM as JParallel
    from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs
    nodes, truth, factors = j_parse(chip_smoke.MANHATTAN_G8_FG, "fg")
    batches = j_group(nodes, factors, incremental_step=1)[:steps]
    solver = JParallel(JNFiSAMArgs(**msr.solver_args(
        msr.parse_args(chip_smoke.MANHATTAN_G8_ARGV))))
    return msr.run_manhattan(solver, jb.IncrementalGaussNewtonMAP(), batches,
                             "cpu", truth, factors), solver


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for label, (_, kind) in chip_smoke.MAP_CASES.items():
        banked = kind == "banked"
        runs = {"JAX": map_spread(
                    label, lambda p: j_parse(p, "fg"),
                    jb.IncrementalGaussNewtonMAP if banked
                    else JGaussNewtonMAP),
                "port": map_spread(
                    label, graph_file_parser,
                    (lambda: IncrementalGaussNewtonMAP(device="cpu"))
                    if banked
                    else (lambda n, f: GaussNewtonMAP(n, f, device="cpu")))}
        if banked:
            runs["JAX, banked solve in float64"] = map_spread(
                label, lambda p: j_parse(p, "fg"), JaxFloat64MAP)
            tb.MAP_DTYPE = torch.float32
            runs["port, banked solve in float32"] = map_spread(
                label, graph_file_parser,
                lambda: IncrementalGaussNewtonMAP(device="cpu"))
            tb.MAP_DTYPE = torch.float64
        rmse, worst, nll, iters = runs["JAX"][0]
        print(f"{label}: JAX from the truth: RMSE {rmse!r} m, max {worst!r} "
              f"m, {iters} LM iterations, NLL {nll!r}", flush=True)
        for who, rs in runs.items():
            print(f"  {who}, from the truth and 3 starts moved by 2e-7: "
                  + "; ".join(f"RMSE {a:.4f} m, NLL {c:.4f}, {d} iterations"
                              for a, _, c, d in rs), flush=True)
            r, n = [a for a, _, _, _ in rs], [c for _, _, c, _ in rs]
            print(f"    band: RMSE ({min(r)!r}, {max(r)!r}), NLL "
                  f"({min(n)!r}, {max(n)!r})", flush=True)
    for label, path, steps in (
            ("plaza1", chip_smoke.PLAZA1_FG, chip_smoke.PLAZA_STEPS),
            ("plaza1_ada0.2", chip_smoke.PLAZA_ADA_FG,
             chip_smoke.PLAZA_ADA_STEPS)):
        r = jax_prefix_floor(path, steps)
        r64 = jax_prefix_floor(path, steps, JaxFloat64MAP)
        ours = chip_smoke.prefix_floor(path, steps, "cpu")
        print(f"{label} first {steps} steps' floor: JAX RMSE "
              f"{r['rmse']:.4f} m, max {r['max']!r} m, {r['iters']} LM "
              f"iterations, NLL {r['nll']:.4f}; JAX in float64 RMSE "
              f"{r64['rmse']:.4f} m, max {r64['max']:.4f} m, {r64['iters']} "
              f"LM iterations, NLL {r64['nll']:.4f}; the port RMSE "
              f"{ours['rmse']:.4f} m, max {ours['max']:.4f} m, "
              f"{ours['iters']} LM iterations, NLL {ours['nll']:.4f}",
              flush=True)
    (steps, m, _), solver = jax_manhattan()
    for i, st in enumerate(steps):
        print(f"  step {i}: wall {st['s']:.2f} s, fit {st['fit_s']:.2f} s, "
              f"floor {st['floor_s']:.3f} s ({st['floor_iters']} LM "
              f"iterations), buckets {st['buckets']}", flush=True)
    print(f"manhattan g8 first {chip_smoke.MANHATTAN_STEPS} steps (JAX, "
          f"CPU): {chip_smoke.scale_line(m)}, repairs "
          f"{solver.mode_repair_log}; the runner's gate: "
          f"{msr.manhattan_gate(m)}")
