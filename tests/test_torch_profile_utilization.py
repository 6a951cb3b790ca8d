"""The port's utilization profile (``nfisam_tpu_torch.scripts.
profile_utilization``) against the JAX package's
``scripts/profile_utilization.py`` on the CPU.

The JAX script is read as source (``torch_script_ast``), never imported
(it sets a compilation cache and writes ``PROFILE.json``).  Its three
analytic FLOP counts, defined in a namespace at each (d, h, K) of a grid,
equal the port's exactly at every n; its sizes are the port's; its rows'
and output's keys are among the port's.  The profile's chain pass runs
the solver's fused-pass code (``posterior_pass.run_plan``): with the JAX
script's chain flow (the zero key's parameters, carried over as numpy)
its samples match the JAX package's own chain program in moments, and
each clique equals that flow's conditional draw from the same key.  The
solver's fused pass, split into ``pack_plan`` and ``run_plan``, equals
the pass as it stood before the split, bit for bit, on a case1 state.  A
CPU run at cut sizes writes the JSON; without a card and without
``--device cpu`` the profile exits 1.
"""
import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from nfisam_tpu_torch.flows.model import (CliqueFlowModel,  # noqa: E402
                                          _select_inverse_fn,
                                          conditional_draw_core)
from nfisam_tpu_torch.scripts import profile_utilization as pu  # noqa: E402
from nfisam_tpu_torch.solver.posterior_pass import (  # noqa: E402
    LazySamples, fused_sample_posterior, run_plan, topological_cliques)
from nfisam_tpu_torch.utils.keys import torch_generator  # noqa: E402
from torch_script_ast import (dict_keys, script_functions,  # noqa: E402
                              script_path)

torch.set_num_threads(1)
JAX_SCRIPT = script_path("profile_utilization.py")
FLOP_FUNCTIONS = ("conditioner_flops_per_sample", "trainer_flops_per_iter",
                  "inverse_flops_per_sample")


def _tree():
    with open(JAX_SCRIPT) as fh:
        return ast.parse(fh.read())


def _function(name):
    return next(n for n in _tree().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _module_constants() -> dict:
    """The JAX script's module-level constants with literal values."""
    out = {}
    for node in _tree().body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = value
                elif isinstance(t, ast.Tuple):
                    out.update(zip((e.id for e in t.elts), value))
    return out


def _loop_literals(func: str) -> list:
    """The literal iterables of ``func``'s ``for`` loops, in order."""
    return [ast.literal_eval(n.iter) for n in ast.walk(_function(func))
            if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)]


def _appended_keys(func: str) -> set:
    """The keys of the dict literal ``func`` appends to its rows."""
    for n in ast.walk(_function(func)):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == \
                "append" and n.args and isinstance(n.args[0], ast.Dict):
            return {k.value for k in n.args[0].keys}
    raise AssertionError(func)


@pytest.mark.parametrize("name", FLOP_FUNCTIONS)
def test_flop_counts_equal_the_jax_scripts_exactly(name):
    """Over a grid of (d, h, K) and n, including the script's own (16,
    8, 9): the JAX script's function, defined with those constants, and
    the port's give the same number, of the same type."""
    for d in (1, 2, 12, 16, 32, 64, 128, 256):
        for h in (1, 8, 16, 64, 128):
            for k in (2, 5, 9, 12, 33):
                ns = {"DIM": d, "HIDDEN": h, "KNOTS": k,
                      "RQS_FLOPS_PER_SCALAR": 45}
                script_functions(JAX_SCRIPT, list(FLOP_FUNCTIONS), ns)
                if name == "conditioner_flops_per_sample":
                    theirs = [ns[name]()]
                    mine = [pu.conditioner_flops_per_sample(d, h, 3 * k)]
                elif name == "trainer_flops_per_iter":
                    ns_ = (1, 1000, 2000, 262144)
                    theirs = [ns[name](n) for n in ns_]
                    mine = [pu.trainer_flops_per_iter(n, d, h, k)
                            for n in ns_]
                else:
                    theirs = [ns[name]()]
                    mine = [pu.inverse_flops_per_sample(d, h, k)]
                assert mine == theirs and \
                    [type(x) for x in mine] == [type(x) for x in theirs], \
                    (d, h, k)
    # the defaults: the script's own constants
    ns = dict(_module_constants())
    script_functions(JAX_SCRIPT, list(FLOP_FUNCTIONS), ns)
    args = (2000,) if name == "trainer_flops_per_iter" else ()
    assert getattr(pu, name)(*args) == ns[name](*args)


def test_sizes_and_peaks_are_the_jax_scripts_on_the_card():
    c = _module_constants()
    assert (c["DIM"], c["KNOTS"], c["HIDDEN"], c["RQS_FLOPS_PER_SCALAR"]) \
        == (pu.DIM, pu.KNOTS, pu.HIDDEN, pu.RQS_FLOPS_PER_SCALAR)
    assert _loop_literals("profile_trainer") == [pu.FIT_CASES]
    assert _loop_literals("profile_batched_trainer") == [pu.BATCHED_B]
    assert _loop_literals("profile_fused_pass") == [pu.PASS_N]
    batched = next(n for n in _function("profile_batched_trainer").body
                   if isinstance(n, ast.Assign))
    assert ast.literal_eval(batched.value) == (pu.BATCHED_N,
                                               pu.BATCHED_ITERS)
    chain = next(n for n in _function("profile_fused_pass").body
                 if isinstance(n, ast.Assign))
    assert ast.literal_eval(chain.value)[0] == pu.CHAIN_L
    # the card's, not the TPU v5e's 98.5 TFLOP/s
    assert pu.PEAK_F32 == 67e12 and pu.PEAK_TF32 == 495e12
    assert c["PEAK_BF16"] / 2 != pu.PEAK_F32


def test_rows_and_output_carry_the_jax_scripts_keys(tmp_path, monkeypatch):
    """``main`` on the CPU at sizes cut small: every row has its JAX row's
    keys and the port's, and the output the JAX script's keys and the
    card's."""
    for name, value in (("FIT_CASES", ((64, 3), (256, 2))),
                        ("BATCHED_N", 64), ("BATCHED_ITERS", 2),
                        ("BATCHED_B", (1, 2)), ("PASS_N", (16, 64))):
        monkeypatch.setattr(pu, name, value)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "p.json"
    assert pu.main(["--device", "cpu", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    j_out = dict_keys(JAX_SCRIPT, "main", "out")
    assert j_out <= set(r)
    assert set(r) - j_out == {"peak_tf32_flops", "card", "device_name"}
    assert r["backend"] == "cpu" and r["card"] == "cpu"
    port = {"mfu_tf32_pct", "peak_mem_bytes"}
    for func, comp in (("profile_trainer", "clique_fit"),
                       ("profile_batched_trainer", "clique_fit_batched"),
                       ("profile_fused_pass", "fused_posterior_pass")):
        rows = [x for x in r["rows"] if x["component"] == comp]
        assert len(rows) == 2
        for x in rows:
            assert set(x) == _appended_keys(func) | port
            assert x["peak_mem_bytes"] is None        # no card: no figure
    fits = [x for x in r["rows"] if x["component"] == "clique_fit"]
    assert [x["iters"] for x in fits] == [3, 2]      # fixed work
    assert not (tmp_path / "PROFILE.json").exists()


def test_profile_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert pu.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_chain_cliques_are_their_flows_conditional_draws():
    """Each clique of the profile's chain, drawn by ``run_plan``, is its
    flow's conditional draw from the same key (no prefix)."""
    plan = pu.chain_plan(torch.device("cpu"))
    keys = np.array([[3, i] for i in range(pu.CHAIN_L)], dtype=np.uint32)
    it = iter(keys)
    buf = run_plan(plan, lambda: next(it), 50, torch.device("cpu"))
    assert buf.shape == (50, pu.CHAIN_L * pu.DIM + 1)
    assert torch.equal(buf[:, -1], torch.zeros(50))
    model = plan.models[0]
    for i in (0, 7, pu.CHAIN_L - 1):
        x = model.conditional_sample(keys[i], 50)
        assert torch.equal(buf[:, i * pu.DIM:(i + 1) * pu.DIM], x), i


def test_chain_pass_matches_the_jax_chain_program_in_moments():
    """The JAX script's chain (its ``_fused_chain_program`` on the zero
    key's flow, 16 cliques, every dim inverted) and the port's on the same
    flow, carried over as numpy: every column's mean and std within 0.05
    at 20000 draws, 5 standard errors of their difference (different
    base draws: threefry and torch)."""
    import jax
    import jax.numpy as jnp
    from nfisam_tpu.flows.nsf import NSFConfig as JCfg
    from nfisam_tpu.flows.nsf import init_flow_params as j_init
    from nfisam_tpu.solver.posterior_pass import (_fused_chain_program,
                                                  _jstack, _stack_tree)

    L, D, n = pu.CHAIN_L, pu.DIM, 20000
    jcfg = JCfg(dim=D, num_knots=pu.KNOTS, hidden_dim=pu.HIDDEN,
                num_flows=1)
    p0 = j_init(jnp.zeros(2, jnp.uint32), jcfg)
    stacked = _stack_tree([p0] * L)
    zero_d = jnp.zeros(D)
    dst = jnp.asarray(np.stack([np.arange(i * D, (i + 1) * D)
                                for i in range(L)]).astype(np.int32))
    keys = np.zeros((L, 2), dtype=np.uint32)
    keys[:, 1] = np.arange(L) + 5
    theirs = np.asarray(_fused_chain_program(jcfg)(
        jnp.zeros((n, L * D), jnp.float32), stacked,
        _jstack(*([zero_d] * L)), _jstack(*([zero_d + 1.0] * L)),
        jnp.asarray(np.zeros((L, D), bool)),
        jnp.asarray(np.full((L, D), -1, np.int32)),
        jnp.asarray(np.zeros((L, D), bool)),
        jnp.asarray(np.zeros((L, D), np.float32)),
        jnp.asarray(np.ones((L, D), bool)), dst, jnp.asarray(keys)))
    plan = pu.chain_plan(torch.device("cpu"))
    model = CliqueFlowModel.from_numpy(
        dataclasses.asdict(jcfg),
        [{k: np.asarray(v) for k, v in p.items()} for p in p0],
        np.zeros(D), np.ones(D), [False] * D, 0, 0, "cpu")
    plan.models = [model] * L
    it = iter(keys)
    mine = run_plan(plan, lambda: next(it), n,
                    torch.device("cpu"))[:, :L * D].numpy()
    assert np.isfinite(mine).all() and np.isfinite(theirs).all()
    np.testing.assert_allclose(mine.mean(0), theirs.mean(0), atol=0.05)
    np.testing.assert_allclose(mine.std(0), theirs.std(0), atol=0.05)
    del jax


@torch.no_grad()
def fused_pass_before_the_split(solver, num_samples):
    """``fused_sample_posterior`` as it stood before ``pack_plan`` and
    ``run_plan`` were split out of it (no mesh)."""
    specs, col_of, D = [], {}, 0
    for clique in topological_cliques(solver._physical_bayes_tree.root):
        model = solver._clique_density_model[clique].model
        frontal_list = sorted(
            clique.frontal, key=lambda v: solver._reverse_ordering_map[v])
        separator_list = sorted(
            clique.separator, key=lambda v: solver._reverse_ordering_map[v])
        first = D
        for v in frontal_list:
            col_of[v] = D
            D += v.dim
        obs = np.asarray(solver._clique_true_obs[clique],
                         dtype=np.float32).reshape(-1)
        specs.append((model, obs, separator_list, first, D - first))
    zero_col = D
    L, width = len(specs), max(s[0].dim for s in specs)
    src = np.full((L, width), zero_col, dtype=np.int64)
    omask = np.zeros((L, width), dtype=bool)
    ovals = np.zeros((L, width), dtype=np.float32)
    imask = np.ones((L, width), dtype=bool)
    lead = []
    for i, (_, obs, separator_list, _, _) in enumerate(specs):
        c = len(obs)
        omask[i, :c] = True
        ovals[i, :c] = obs
        for v in separator_list:
            src[i, c:c + v.dim] = np.arange(col_of[v], col_of[v] + v.dim)
            c += v.dim
        imask[i, :c] = False
        lead.append(c)
    src, omask, ovals, imask = (torch.from_numpy(a)
                                for a in (src, omask, ovals, imask))
    inverse_fn = _select_inverse_fn(solver.device)
    buffer = torch.zeros((num_samples, D + 1), dtype=torch.float32)
    for i, (model, _, _, first, frontal_dim) in enumerate(specs):
        d = model.dim
        gen = torch_generator(solver._next_key(), solver.device)
        z = model.base.sample(gen, num_samples, solver.device)
        prefix = torch.where(omask[i, :d], ovals[i, :d],
                             buffer.index_select(1, src[i, :d]))
        x = conditional_draw_core(model.flow_params, model.mean, model.std,
                                  model.circ_mask, z, prefix, imask[i, :d],
                                  model.cfg, inverse_fn)
        buffer[:, first:first + frontal_dim] = \
            x[:, lead[i]:lead[i] + frontal_dim]
    return LazySamples(buffer, col_of)


def test_split_fused_pass_equals_the_pass_before_the_split_on_case1():
    """case1 solved by ``ParallelNFiSAM`` at tiny sizes (6 steps): from
    the same key stream, the fused pass now and as it stood before the
    split give the same samples bit for bit and take the same keys."""
    import copy
    *_, solver = chip_smoke.solve_case1(
        1, "cpu", parallel=True, flow_iterations=20, local_sample_num=150,
        posterior_sample_num=60)
    keys = copy.deepcopy(solver._keys)
    now = fused_sample_posterior(solver, 300)
    after = copy.deepcopy(solver._keys)
    solver._keys = keys
    before = fused_pass_before_the_split(solver, 300)
    assert set(now) == set(before) and len(now) == 8
    for v in before:
        assert torch.equal(now[v], before[v]), v
    assert solver._keys().tolist() == after().tolist()
