"""The port's nested sampler against the JAX package's on the CPU.

Bit for bit: ``combine_runs`` and ``_finish`` (the birth-death merge and
the final resampling are the same numpy) on ``NSRun`` records that the
JAX package's own ``_run_ns`` wrote, one run and two merged.

In distribution (the port draws from ``torch.Generator``s): the
analytic-evidence oracles of ``tests/test_nested_dynamic.py`` at that
test's settings and tolerances, for the ``rslice``, ``rwalk`` and
``grad`` proposals and the dynamic sampler, and its closed-form
displacement-graph evidence through the factor path.  ``ncall`` counts
what the JAX package counts: the live points' first batch, then K a
shrink step.

The solvers' nested clique path: ``local_sampling_method="nested"`` by
``NFiSAM`` and ``ParallelNFiSAM`` on the graph of
``tests/test_solver_e2e.py::test_nested_clique_training_path`` at its
settings and gate, and against the JAX package's ``NFiSAM`` on it; and
ROADMAP C3, the JAX package's dropped ``dynamic`` flag, which the port
reproduces: "dynamic nested" draws what "nested" draws.

Run as a script, this file prints the JAX package's figure behind the
card's gate on the nested clique path: case1 by its ``NFiSAM`` at the
bench configuration with ``local_sampling_method="nested"``, seed 1, on
the CPU, and the mean joint MMD over steps 0-5 (``python
tests/test_torch_nested.py``, ~2 min); with ``scatter``, the logz of
static NS on case1 at 300 live points for seeds 100-115 by both packages
on the CPU, and each package's mean and standard deviation (~10 min);
with ``scatter-dynamic [JAX|port]``, dynamic NS at
``chip_smoke.dynamic_ns_phase``'s protocol for seeds 11-26 by both
packages (or the one named) on the CPU (~2 min a seed for the port on
one thread, ~30 min for all 16)."""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.stats import norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

import nfisam_tpu.samplers.nested as jnested  # noqa: E402
import nfisam_tpu_torch.core as tcore
import nfisam_tpu_torch.factors as tfactors
from nfisam_tpu_torch.eval import gaussian_displacement_graph_evidence
from nfisam_tpu_torch.parallel import ParallelNFiSAM
from nfisam_tpu_torch.samplers import GlobalNestedSampler
from nfisam_tpu_torch.samplers.nested import (HOST_READS, NestedConfig,
                                              NSRun, _finish, combine_runs,
                                              dynamic_nested_sample,
                                              nested_sample)
from nfisam_tpu_torch.solver import NFiSAM, NFiSAMArgs
from nfisam_tpu_torch.solver.nested_adapter import nested_clique_samples


torch.set_num_threads(1)
D = 2
S0, S = 2.0, 0.5
MU = np.array([1.0, -0.5])
TRUE_LOGZ = float(np.sum(norm.logpdf(MU, 0.0, np.sqrt(S0 ** 2 + S ** 2))))
POST_PREC = 1 / S0 ** 2 + 1 / S ** 2
POST_MU = (MU / S ** 2) / POST_PREC
POST_SD = POST_PREC ** -0.5


def ptform(u):
    return torch.special.ndtri(u) * S0


def loglike(x):
    return (-0.5 * torch.sum((x - torch.as_tensor(MU, dtype=x.dtype)) ** 2,
                             -1) / S ** 2
            - 0.5 * D * np.log(2 * np.pi * S ** 2))


def _jax_runs(n_runs):
    """NSRun records of the JAX package's ``_run_ns`` on the oracle."""
    import jax.numpy as jnp

    def jptform(u):
        return jax.scipy.stats.norm.ppf(u) * S0

    def jloglike(x):
        return (-0.5 * jnp.sum((x - MU) ** 2, -1) / S ** 2
                - 0.5 * D * jnp.log(2 * jnp.pi * S ** 2))

    cfg = jnested.NestedConfig(n_live=100, replace_batch=10, max_iters=400)
    return [jnested._run_ns(np.array([0, 20 + i], np.uint32), jptform,
                            jloglike, D, cfg) for i in range(n_runs)]


@pytest.mark.parametrize("n_runs", [1, 2])
def test_combine_runs_and_finish_bit_for_bit(n_runs):
    theirs = _jax_runs(n_runs)
    ours = [NSRun(X=r.X, L_death=r.L_death, L_birth=r.L_birth,
                  ncall=r.ncall) for r in theirs]
    got = combine_runs(ours)
    want = jnested.combine_runs(theirs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    cfg = NestedConfig(n_live=100, replace_batch=10)
    key = np.array([3, 17], np.uint32)
    s_ours, s_theirs = {}, {}
    a = _finish(key, ours, *got, cfg, s_ours)
    b = jnested._finish(key, theirs, *want, jnested.NestedConfig(
        n_live=100, replace_batch=10), s_theirs)
    np.testing.assert_array_equal(a, b)
    assert s_ours == s_theirs


@pytest.mark.parametrize("proposal", ["rslice", "rwalk", "grad"])
def test_static_ns_matches_analytic_evidence(proposal):
    cfg = NestedConfig(n_live=400, replace_batch=10, proposal=proposal,
                       max_iters=2500)
    summ = {}
    HOST_READS.clear()
    samples = nested_sample(np.array([0, 5], dtype=np.uint32), ptform,
                            loglike, D, cfg, summary=summ, device="cpu")
    assert abs(summ["logz"] - TRUE_LOGZ) < max(3.5 * summ["logzerr"], 0.35)
    assert np.all(np.abs(samples.mean(0) - POST_MU) < 4 * POST_SD /
                  np.sqrt(len(samples) / 20))
    assert summ["ncall"] > 0 and summ["logzerr"] > 0
    iters = HOST_READS["ns_iteration"]
    assert summ["niter"] == iters * cfg.replace_batch + cfg.n_live
    if proposal == "rslice":
        assert summ["ncall"] == cfg.n_live + \
            cfg.replace_batch * HOST_READS["ns_shrink"]
    elif proposal == "rwalk":
        assert summ["ncall"] == cfg.n_live + \
            iters * cfg.replace_batch * cfg.walk_steps
    else:
        assert summ["ncall"] == cfg.n_live + \
            iters * cfg.replace_batch * (2 * cfg.walk_steps + 1)


def test_dynamic_ns_evidence_and_posterior():
    cfg = NestedConfig(n_live=400, replace_batch=10, max_iters=2500)
    summ = {}
    samples = dynamic_nested_sample(np.array([0, 9], dtype=np.uint32),
                                    ptform, loglike, D, cfg, n_batches=2,
                                    summary=summ, device="cpu")
    assert abs(summ["logz"] - TRUE_LOGZ) < max(3.5 * summ["logzerr"], 0.35)
    assert np.all(np.abs(samples.mean(0) - POST_MU) < 0.2)
    assert np.all(np.abs(samples.std(0) - POST_SD) < 0.2)


def _displacement_graph():
    xs = [tcore.R2Variable(f"X{i}", tcore.VariableType.Pose)
          for i in range(4)]
    cov = np.eye(2) * 0.3
    fs = [tfactors.UnaryR2GaussianPriorFactor(xs[0], np.zeros(2),
                                              np.eye(2))]
    for a, b, d in ((0, 1, [1.0, 0.2]), (1, 2, [0.8, -0.4]),
                    (2, 3, [-0.1, 1.1]), (0, 2, [1.9, -0.1]),
                    (1, 3, [0.6, 0.6])):
        fs.append(tfactors.R2RelativeGaussianLikelihoodFactor(
            xs[a], xs[b], np.array(d), cov))
    return xs, fs


def test_dynamic_ns_unbiased_on_closed_form_graph_evidence():
    """Dynamic-mode logz against the exact evidence of a linear-Gaussian
    displacement graph with two loop closures, through the factor path:
    each seed within 3.5 of its stated error, the mean bias over seeds
    within 2.5 standard errors."""
    xs, fs = _displacement_graph()
    sampler = GlobalNestedSampler(nodes=xs, factors=fs, device="cpu")
    truth = gaussian_displacement_graph_evidence(sampler.joint)
    biases, errs = [], []
    for seed in (1, 2, 3, 4):
        summ = {}
        sampler.sample(key=np.array([seed, 7], dtype=np.uint32),
                       live_points=400, dynamic=True, n_batches=2,
                       res_summary=summ)
        biases.append(summ["logz"] - truth)
        errs.append(summ["logzerr"])
        assert abs(biases[-1]) < 3.5 * summ["logzerr"]
    sem = float(np.mean(errs)) / np.sqrt(len(biases))
    assert abs(float(np.mean(biases))) < 2.5 * sem


def test_dynamic_nested_clique_path_runs_the_static_sampler():
    """ROADMAP C3: the JAX package's ``nested_clique_samples`` never
    passes ``dynamic`` on, so "dynamic nested" is the static sampler; the
    port keeps that, so the same key gives the same samples."""
    xs, fs = _displacement_graph()
    key = np.array([0, 5], np.uint32)
    a = nested_clique_samples(key, xs, fs, 200, dynamic=False, device="cpu")
    b = nested_clique_samples(key, xs, fs, 200, dynamic=True, device="cpu")
    assert a.shape == (200, 8)
    np.testing.assert_array_equal(a, b)


def _clique_path_solve(core, factors, solver):
    """``chip_smoke.clique_path_graph`` through ``solver`` on the CPU:
    samples by name."""
    return chip_smoke.clique_path_graph(core, factors, solver, "cpu")[1][-1]


CLIQUE_ARGS = {k: v for k, v in chip_smoke.CLIQUE_PATH_ARGS.items()
               if k != "mode_repair"}


@pytest.fixture(scope="module")
def jax_clique_path():
    import nfisam_tpu.core as jcore
    import nfisam_tpu.factors as jfactors
    from nfisam_tpu.solver import NFiSAM as JNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs as JArgs
    with pytest.MonkeyPatch.context() as mp:
        # no background compiles to outlive the process
        mp.setenv("NFISAM_PREWARM", "0")
        return _clique_path_solve(jcore, jfactors,
                                  JNFiSAM(JArgs(**CLIQUE_ARGS)))


@pytest.mark.parametrize("solver_cls", [NFiSAM, ParallelNFiSAM])
def test_nested_clique_path_by_both_solvers(solver_cls, jax_clique_path):
    ours = _clique_path_solve(
        tcore, tfactors,
        solver_cls(NFiSAMArgs(mode_repair=False, **CLIQUE_ARGS),
                   device="cpu"))
    m1 = ours["X1"].mean(0)
    assert np.linalg.norm(m1 - np.array([1.1, 1.0])) < \
        chip_smoke.CLIQUE_PATH_GATE_M
    for name, x in jax_clique_path.items():
        assert ours[name].shape == x.shape
        np.testing.assert_allclose(ours[name].mean(0), x.mean(0), atol=0.2)
        np.testing.assert_allclose(ours[name].std(0), x.std(0), atol=0.15)


def logz_scatter(seeds=range(100, 116), live: int = 300,
                 packages=("JAX", "port"), **kw) -> None:
    """NS logz on case1 by each of ``packages`` (CPU), seed by seed;
    ``kw`` goes to ``sample`` (e.g. ``dynamic=True``)."""
    from nfisam_tpu.io import graph_file_parser as j_parse
    from nfisam_tpu.samplers import GlobalNestedSampler as JNested
    from nfisam_tpu_torch.io import graph_file_parser

    runs = {
        "JAX": (JNested, j_parse(chip_smoke.CASE1_FG, "fg"), {}),
        "port": (GlobalNestedSampler, graph_file_parser(chip_smoke.CASE1_FG),
                 {"device": "cpu"})}
    for name in packages:
        cls, (nodes, _, fs), dev = runs[name]
        logz = []
        for seed in seeds:
            summ = {}
            cls(nodes, fs, **dev).sample(
                key=np.array([0, seed], np.uint32), live_points=live,
                res_summary=summ, **kw)
            logz.append(summ["logz"])
            print(f"{name} seed {seed}: logz {summ['logz']!r} +- "
                  f"{summ['logzerr']!r}", flush=True)
        print(f"{name}: mean {np.mean(logz)!r}, std {np.std(logz)!r} over "
              f"{len(logz)} seeds", flush=True)


if __name__ == "__main__" and sys.argv[1:] == ["scatter"]:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    logz_scatter()
elif __name__ == "__main__" and sys.argv[1:2] == ["scatter-dynamic"]:
    # dynamic NS at chip_smoke.dynamic_ns_phase's protocol, seeds 11-26,
    # by both packages on the CPU (or by the one named after the mode);
    # on the card, the same sampler call for the port alone:
    # python3 -c 'import numpy as np, chip_smoke as c
    # from nfisam_tpu_torch.samplers import GlobalNestedSampler as G
    # n, f, _ = c.case1_dims()
    # for s in range(11, 27):
    #     d = {}
    #     G(n, f, device="cuda").sample(key=np.array([0, s], np.uint32),
    #         live_points=c.DYNAMIC_LIVE, max_iters=c.DYNAMIC_ITERS,
    #         dynamic=True, res_summary=d)
    #     print(s, d["logz"])'
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    logz_scatter(range(11, 27), chip_smoke.DYNAMIC_LIVE,
                 tuple(sys.argv[2:]) or ("JAX", "port"), dynamic=True,
                 max_iters=chip_smoke.DYNAMIC_ITERS)
elif __name__ == "__main__":
    # the JAX package's nested clique path on case1 (CPU), seed 1
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["NFISAM_PREWARM"] = "0"
    from nfisam_tpu.io import graph_file_parser as j_parse
    from nfisam_tpu.io import group_nodes_factors_incrementally as j_group
    from nfisam_tpu.solver import NFiSAM as JNFiSAM
    from nfisam_tpu.solver import NFiSAMArgs as JArgs

    nodes, _, fs = j_parse(chip_smoke.CASE1_FG, "fg")
    solver = JNFiSAM(JArgs(**{**chip_smoke.BENCH_ARGS, "seed": 1,
                              "local_sampling_method": "nested"}))
    per_step = []
    for ns, step_fs in j_group(nodes, fs, incremental_step=1):
        for n in ns:
            solver.add_node(n)
        for f in step_fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        solver.fit_tree_density_models()
        per_step.append({str(v.name): np.asarray(x) for v, x in
                         solver.sample_posterior().items()})
    ours, ref, per = chip_smoke.accuracy_gate(
        per_step, {str(v.name): v.dim for v in nodes})
    print(f"JAX nested clique path, case1 seed 1: mean joint MMD {ours!r} "
          f"(reference run1 {ref!r}), per step {per}")
