"""The whole slice on the CPU: the case1 incremental solve in the port
against the JAX package's, at reduced settings (300 training samples per
clique, <= 60 Adam iterations, 500 posterior draws, mode repair off in
both).  Structure is compared exactly, a carried-across clique model
element by element, and the posteriors in distribution.

Run as a script, ``python tests/test_torch_solver.py``, it solves case1
with the JAX package on the CPU at the full bench.py configuration with
``mode_repair=False`` for seeds 1-3 and prints the accuracy gate of
``chip_smoke.py`` on those posteriors: the reference point for the
port's gate on the card."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from nfisam_tpu.flows.base_dist import BaseDistribution as JBase  # noqa: E402
from nfisam_tpu.flows.model import conditional_draw_core as j_draw  # noqa: E402
from nfisam_tpu.flows.nsf import stack_inverse_masked as j_inverse  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.solver import NFiSAM as JNFiSAM  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.eval import mmd  # noqa: E402
from nfisam_tpu_torch.flows import CliqueFlowModel  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.solver import (NFiSAM, NFiSAMArgs,  # noqa: E402
                                     effective_hidden_dim)

torch.set_num_threads(1)
CASE1 = chip_smoke.CASE1_FG
SMALL = dict(posterior_sample_num=500, local_sample_num=300,
             flow_iterations=60, num_knots=9, learning_rate=0.025,
             hidden_dim=8, average_window=25, loss_delta_tol=0.04,
             elimination_method="pose_first", mode_repair=False, seed=1)
# how far a pose's last-step posterior mean moves between two of the JAX
# package's own seeds at SMALL: the largest gap over seeds 1-16 (X5,
# 4.805 m; ``python tests/test_torch_solver.py scatter``)
CASE1_POSE_GAP_M = 4.81


def _tree(tree):
    return [(sorted(str(v.name) for v in c.frontal),
             sorted(str(v.name) for v in c.separator),
             repr(c.parent) if c.parent is not None else None)
            for c in tree.clique_ordering()]


def _solve(solver, batches, to_numpy):
    steps = []
    for ns, fs in batches:
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        solver.update_physical_and_working_graphs()
        samples = solver.incremental_inference()
        steps.append({
            "working": _tree(solver.working_bayes_tree),
            "physical": _tree(solver.physical_bayes_tree),
            "trained": sorted(solver._temp_training_loss),
            "samples": {str(v.name): to_numpy(x) for v, x in samples.items()},
        })
    return steps, solver


@pytest.fixture(scope="module")
def jax_run():
    nodes, _, factors = j_parse(CASE1, "fg")
    return _solve(JNFiSAM(JNFiSAMArgs(**SMALL)),
                  j_group(nodes, factors, incremental_step=1), np.asarray)


@pytest.fixture(scope="module")
def torch_run():
    nodes, _, factors = graph_file_parser(CASE1)
    return _solve(NFiSAM(NFiSAMArgs(**SMALL), device="cpu"),
                  group_nodes_factors_incrementally(nodes, factors, 1),
                  lambda x: x.numpy())


@pytest.fixture(scope="module")
def name2dim():
    nodes, _, _ = graph_file_parser(CASE1)
    return {str(v.name): v.dim for v in nodes}


@pytest.mark.parametrize("step", range(6))
def test_clique_structure_matches_jax(jax_run, torch_run, step):
    ours, theirs = torch_run[0][step], jax_run[0][step]
    assert ours["working"] == theirs["working"]
    assert ours["physical"] == theirs["physical"]
    assert ours["trained"] == theirs["trained"]
    assert sorted(ours["samples"]) == sorted(theirs["samples"])


def test_posterior_is_finite_and_shaped(torch_run, name2dim):
    for step in torch_run[0]:
        for name, x in step["samples"].items():
            assert x.shape == (SMALL["posterior_sample_num"],
                               name2dim[name])
            assert np.isfinite(x).all()


def test_posterior_matches_jax_in_distribution(jax_run, torch_run):
    """Last step: the joint translation MMD between the two solves below
    0.15 (kernel sigma 1 m over all 8 variables; it reads 0.02-0.06 for
    seeds 1-2), every pose's posterior mean within ``CASE1_POSE_GAP_M`` of
    JAX's and every landmark's within 12 m.  The mean bounds are loose on
    purpose: at these reduced settings the JAX solve's own means move
    between its seeds (ring-mode commitment; seeds 1-16: its last pose by
    up to 4.805 m, L2 by up to 18.3 m), so a tighter bound would test the
    seed, not the port."""
    ours, theirs = torch_run[0][-1]["samples"], jax_run[0][-1]["samples"]
    for name in ours:
        gap = np.linalg.norm(ours[name][:, :2].mean(0) -
                             theirs[name][:, :2].mean(0))
        assert gap < (12.0 if name.startswith("L") else CASE1_POSE_GAP_M), \
            (name, gap)
    names = sorted(ours)
    joint = mmd(np.hstack([ours[n][:, :2] for n in names]),
                np.hstack([theirs[n][:, :2] for n in names]))
    assert joint < 0.15


def test_carried_clique_model_reproduces_jax_draw(jax_run):
    """A clique model trained by the JAX solve, carried across as numpy
    and fed the same base draws z, gives JAX's ``conditional_draw_core``
    element by element.  Tolerance: 1e-4 + 1e-5 relative on metre-scale
    outputs (normalized values agree to ~1e-6, scaled by stds of up to
    tens of metres)."""
    solver = jax_run[1]
    checked = 0
    for clique, adapter in solver._clique_density_model.items():
        jm = adapter.model
        cfg = jm.cfg
        sep_dim = jm.aug_sep_dim
        rng = np.random.default_rng(checked)
        n = 400
        # prefix: the true observations, then separator samples drawn
        # around the normalizer's mean
        prefix = np.zeros((n, cfg.dim), np.float32)
        mean, std = np.asarray(jm.mean), np.asarray(jm.std)
        prefix[:, :sep_dim] = mean[:sep_dim] + std[:sep_dim] * \
            rng.normal(size=(n, sep_dim)) * 0.5
        invert = np.arange(cfg.dim) >= sep_dim
        key = jax.random.PRNGKey(11 + checked)
        circ = jnp.asarray(np.asarray(list(jm.circular_dim_list) + [False] *
                                      jm.pad_dims, dtype=bool))
        ref = j_draw(jm.flow_params, jm.mean, jm.std, circ, key,
                     jnp.asarray(prefix), jnp.asarray(invert), cfg,
                     JBase(cfg.circular_mask), j_inverse)
        z = np.array(JBase(cfg.circular_mask).sample(key, n))
        ours = CliqueFlowModel.from_numpy(
            dataclasses.asdict(cfg),
            [{k: np.asarray(v) for k, v in p.items()}
             for p in jm.flow_params], mean, std, jm.circular_dim_list,
            sep_dim, jm.pad_dims, "cpu")
        got = ours.conditional_draw(
            torch.as_tensor(z),
            torch.as_tensor(prefix[:, :sep_dim]) if sep_dim else None)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref)[:, sep_dim:],
                                   atol=1e-4, rtol=1e-5)
        checked += 1
    assert checked >= 2


def test_accuracy_gate_protocol_runs_on_cpu_samples(torch_run, name2dim):
    per_step = [s["samples"] for s in torch_run[0]]
    ours, ref, per = chip_smoke.accuracy_gate(per_step, name2dim)
    assert len(per) == 6 and np.isfinite(per).all()
    assert 0.0 < ref < 0.05       # reference run1: 0.0227
    assert 0.0 < ours < 0.5


def test_roundtrip_residuals_on_trained_cliques(torch_run):
    from nfisam_tpu_torch.flows import stack_inverse_masked_plain
    res, res_plain, checked = chip_smoke.roundtrip_residuals(
        torch_run[1], stack_inverse_masked_plain)
    assert checked >= 1
    assert res == res_plain and res < 1e-3


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_no_jax_package():
    code = ("import sys\n"
            "import nfisam_tpu_torch, nfisam_tpu_torch.solver, "
            "nfisam_tpu_torch.flows, nfisam_tpu_torch.io, "
            "nfisam_tpu_torch.eval, nfisam_tpu_torch.train, "
            "nfisam_tpu_torch.samplers, nfisam_tpu_torch.utils.cuda_build, "
            "nfisam_tpu_torch.parallel, "
            "nfisam_tpu_torch.solver.posterior_pass, "
            "nfisam_tpu_torch.solver.banked_joint, "
            "nfisam_tpu_torch.solver.map_solver, "
            "nfisam_tpu_torch.samplers.joint, "
            "nfisam_tpu_torch.graph.ordering, "
            "nfisam_tpu_torch.eval.metrics, nfisam_tpu_torch.cli, "
            "nfisam_tpu_torch.solver.run, nfisam_tpu_torch.solver.checkpoint, "
            "nfisam_tpu_torch.sim, nfisam_tpu_torch.io.g2o, "
            "nfisam_tpu_torch.core.likelihoods, "
            "nfisam_tpu_torch.samplers.nested, "
            "nfisam_tpu_torch.samplers.nuts, nfisam_tpu_torch.samplers.smc, "
            "nfisam_tpu_torch.samplers.run_batch, "
            "nfisam_tpu_torch.solver.nested_adapter, "
            "nfisam_tpu_torch.utils.functions, "
            "nfisam_tpu_torch.utils.cuda_graph\n"
            "from nfisam_tpu_torch.train import fit_flows_batched\n"
            "from nfisam_tpu_torch.examples.toy_examples import (\n"
            "    r2_relative_eight_nodes, r2_range_incremental,\n"
            "    eight_pose_circle, five_node_range_incremental)\n"
            "from nfisam_tpu_torch.examples.small_range_gaussian_problem "
            "import (\n"
            "    run_nfisam, generate_reference_solution, compute_mmd)\n"
            "from nfisam_tpu_torch.examples.manhattan_world_with_range "
            "import generate_and_run\n"
            "import importlib, pkgutil\n"
            "for m in pkgutil.walk_packages(nfisam_tpu_torch.__path__, "
            "'nfisam_tpu_torch.'):\n"
            "    if m.name != 'nfisam_tpu_torch.__main__':\n"
            "        importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m in ('jax', 'optax', "
            "'nfisam_tpu', 'bench') or m.startswith(('jax.', 'optax.', "
            "'nfisam_tpu.'))]\n"
            "assert not bad, bad\n"
            "examples = sorted(m for m in sys.modules if m.startswith("
            "'nfisam_tpu_torch.examples.') and m.count('.') == 3)\n"
            "assert len(examples) == 8, examples\n"
            "print('clean')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_solver_without_device_raises_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        NFiSAM(NFiSAMArgs(**SMALL))


@pytest.mark.parametrize("bad", [dict(elimination_method="minimum_degree"),
                                 dict(elimination_method="metis"),
                                 dict(elimination_method="colamd"),
                                 dict(flow_type="RealNVP")])
def test_unported_options_raise(bad):
    """Options neither package takes raise (every ``NFiSAMArgs`` field of
    the JAX package is taken)."""
    with pytest.raises(NotImplementedError):
        NFiSAM(NFiSAMArgs(**{**SMALL, **bad}), device="cpu")


@pytest.mark.parametrize("opts", [dict(host_parallel=True),
                                  dict(host_parallel="off"),
                                  dict(data_parallel_mesh="mesh"),
                                  dict(sample_mesh="mesh")])
def test_multi_rank_options_are_taken(opts):
    """``host_parallel`` and the two meshes are ``NFiSAMArgs`` fields as
    in the JAX package, and the meshes stay out of the arguments' JSON
    (``parallel/`` runs them; ``test_torch_mesh.py``)."""
    if "mesh" in str(opts):
        from nfisam_tpu_torch.parallel import make_mesh
        opts = {k: make_mesh() for k in opts}
    args = NFiSAMArgs(**{**SMALL, **opts})
    NFiSAM(args, device="cpu")
    keys = json.loads(args.json_str())
    assert "data_parallel_mesh" not in keys and "sample_mesh" not in keys
    assert keys["host_parallel"] == args.host_parallel


@pytest.mark.parametrize("opts", [dict(pad_dim_multiple=8),
                                  dict(dim_bucket_floor=32),
                                  dict(hidden_dim=12),
                                  dict(scale_hidden_with_dim=False),
                                  dict(training_set_frac=0.8),
                                  dict(num_knots=3)])
def test_flow_options_run(opts):
    """The JAX package's flow options, which raised before the generic
    kernel and the validation stop: the first case1 step solves, and the
    flow has the bucket and width the options give."""
    nodes, _, factors = graph_file_parser(CASE1)
    args = NFiSAMArgs(**{**SMALL, "flow_iterations": 20, **opts})
    solver = NFiSAM(args, device="cpu")
    steps, _ = _solve(solver, group_nodes_factors_incrementally(
        nodes, factors, 1)[:1], lambda x: x.numpy())
    for adapter in solver._clique_density_model.values():
        cfg = adapter.model.cfg
        assert cfg.dim == solver._dim_bucket(cfg.dim)
        assert cfg.hidden_dim == effective_hidden_dim(args, cfg.dim)
        assert cfg.num_knots == args.num_knots
    assert all(np.isfinite(x).all() for x in steps[0]["samples"].values())


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def jax_reference_gate(seeds=(1, 2, 3)):
    """The JAX package's case1 solve on the CPU at chip_smoke's (bench.py)
    configuration with mode repair off, through chip_smoke's gate."""
    jax.config.update("jax_platforms", "cpu")
    nodes, _, factors = j_parse(CASE1, "fg")
    name2dim = {str(v.name): v.dim for v in nodes}
    per_seed = []
    for seed in seeds:
        solver = JNFiSAM(JNFiSAMArgs(**{**chip_smoke.BENCH_ARGS,
                                        "seed": seed}))
        steps, _ = _solve(solver, j_group(nodes, factors,
                                          incremental_step=1), np.asarray)
        per_seed.append([s["samples"] for s in steps])
    return chip_smoke.median_gate(per_seed, name2dim)


def posterior_mean_scatter(arm: str, seeds) -> dict:
    """Case1 at ``SMALL`` by one package (``JAX`` or ``port``) for each
    seed: the last step's posterior translation mean of every variable,
    {seed: {name: [x, y]}}, each seed printed as it ends."""
    means = {}
    for seed in seeds:
        args = {**SMALL, "seed": seed}
        if arm == "JAX":
            nodes, _, factors = j_parse(CASE1, "fg")
            steps, _ = _solve(JNFiSAM(JNFiSAMArgs(**args)),
                              j_group(nodes, factors, incremental_step=1),
                              np.asarray)
        else:
            nodes, _, factors = graph_file_parser(CASE1)
            steps, _ = _solve(NFiSAM(NFiSAMArgs(**args), device="cpu"),
                              group_nodes_factors_incrementally(nodes,
                                                                factors, 1),
                              lambda x: x.numpy())
        means[seed] = {name: [float(v) for v in x[:, :2].mean(0)]
                       for name, x in steps[-1]["samples"].items()}
        print(f"{arm} seed {seed}: {json.dumps(means[seed])}", flush=True)
    return means


def scatter_report(jax_means: dict, port_means: dict) -> None:
    """For each variable: the largest gap between two JAX seeds' posterior
    means (how far the JAX package moves between its own seeds) and the
    gaps between the port and the JAX package at each shared seed."""
    def gap(a, b):
        return float(np.linalg.norm(np.subtract(a, b)))

    for name in sorted(next(iter(jax_means.values()))):
        own = [gap(jax_means[s][name], jax_means[t][name])
               for s in jax_means for t in jax_means if s < t]
        cross = {s: round(gap(port_means[s][name], jax_means[s][name]), 4)
                 for s in port_means if s in jax_means}
        print(f"{name}: JAX between its seeds max {max(own)!r} median "
              f"{float(np.median(own))!r}; port vs JAX by seed {cross}",
              flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["scatter"]:
    # python tests/test_torch_solver.py scatter [JAX|port] [seed ...]:
    # one package's means (seeds 1-8 by default); both packages, then the
    # report, without a package named
    arms = [a for a in sys.argv[2:] if a in ("JAX", "port")] or \
        ["JAX", "port"]
    seeds = [int(a) for a in sys.argv[2:] if a not in arms] or \
        list(range(1, 9))
    runs = {arm: posterior_mean_scatter(arm, seeds) for arm in arms}
    if len(runs) == 2:
        scatter_report(runs["JAX"], runs["port"])
elif __name__ == "__main__":
    mmd_joint, ref_mmd, results = jax_reference_gate()
    for seed, (ours, _, per) in zip((1, 2, 3), results):
        print(f"seed {seed}: joint MMD {ours:.4f}, per step "
              f"{[round(x, 4) for x in per]}")
    print(f"JAX on CPU, mode_repair=False: median joint MMD {mmd_joint:.4f}"
          f" vs reference run1 {ref_mmd:.4f} (gate {2 * ref_mmd:.4f})")
