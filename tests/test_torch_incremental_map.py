"""The port's incremental warm-started MAP and its truth-initialised floor
against the JAX package's, on the CPU: each update's initial values
(dead-reckoned poses, ring-scored landmarks; tolerance 1e-4), the cold
start, the solves, and ``chip_smoke.floor_from_truth`` (the map_floor
recipe of ``scripts/plaza_family_run.py``).  The port solves in float64
(``banked_joint.MAP_DTYPE``), so the solves are held to the JAX package's
own LM-CG program run in float64 (``test_torch_map.JaxFloat64MAP``):
states within 1e-3 m, the same LM iterations, final NLL within 1e-6 of
it.  (The JAX package's float32 solve stops at its iteration cap short of
the optimum on plaza1's warm steps and on lawnmower_4x4, wherever its
rounding takes it.)"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.solver import banked_joint as jb  # noqa: E402
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.solver import IncrementalGaussNewtonMAP  # noqa: E402
from nfisam_tpu_torch.solver import banked_joint as tb  # noqa: E402
from test_torch_map import JaxFloat64MAP  # noqa: E402

torch.set_num_threads(1)
CASE1 = chip_smoke.CASE1_FG
CASE1_DA = chip_smoke.CASE1_DA_FG
LAWNMOWER = os.path.join(REPO, "data", "lawnmower_4x4_factor_graph.fg")


def _incremental_runs(n_steps):
    """Both packages' incremental MAP over plaza1's first ``n_steps``
    steps (5 poses a step): per step the state after ``update`` (the
    dead-reckoned and ring-scored initial values), after ``solve``, the LM
    iterations and the final NLL.  Before each update the port takes JAX's
    state, so each step's initial values come from the same point."""
    runs, states = [], []
    for parse, group, new in (
            (lambda p: j_parse(p, "fg"), j_group, JaxFloat64MAP),
            (graph_file_parser, group_nodes_factors_incrementally,
             lambda: IncrementalGaussNewtonMAP(device="cpu"))):
        nodes, _, factors = parse(chip_smoke.PLAZA1_FG)
        m = new()
        steps = []
        batches = group(nodes, factors, incremental_step=5)[:n_steps]
        for i, (ns, fs) in enumerate(batches):
            if runs and i:
                m._x = np.array(states[i - 1])
            m.update(ns, fs)
            init = None if m._x is None else np.array(m._x)
            m.solve()
            if not runs:
                states.append(np.array(m._x))
            steps.append((init, np.array(m._x), m.last_iterations,
                          m.last_nll))
        runs.append(steps)
    return runs


@pytest.fixture(scope="module")
def plaza_incremental():
    return _incremental_runs(3)


@pytest.mark.parametrize("step", range(3))
def test_incremental_map_matches_jax(plaza_incremental, step):
    """Each update's initial values (dead-reckoned poses, ring-scored
    landmarks) equal JAX's; the cold first solve and the warm ones agree
    with JAX's in float64 within 1e-3 m, in as many LM iterations, at the
    same final NLL."""
    theirs, ours = (run[step] for run in plaza_incremental)
    if step == 0:
        assert ours[0] is None and theirs[0] is None
    else:
        np.testing.assert_allclose(ours[0], theirs[0], atol=1e-4)
    np.testing.assert_allclose(ours[1], theirs[1], atol=1e-3)
    assert ours[2] == theirs[2]
    assert abs(ours[3] - theirs[3]) <= 1e-6 * abs(theirs[3])


def test_incremental_map_cold_start_matches_jax():
    """The first solve starts cold: priors, dead-reckoning and ring
    scoring over every factor (``_cold_start``)."""
    starts = []
    for parse, new in ((lambda p: j_parse(p, "fg"),
                        jb.IncrementalGaussNewtonMAP),
                       (graph_file_parser,
                        lambda: IncrementalGaussNewtonMAP(device="cpu"))):
        nodes, _, factors = parse(CASE1_DA)
        m = new()
        m.update(nodes, factors)
        starts.append(np.array(m._cold_start()))
    np.testing.assert_allclose(starts[1], starts[0], atol=1e-4)


@pytest.mark.parametrize("path", [CASE1, LAWNMOWER],
                         ids=["case1", "lawnmower_4x4"])
def test_truth_floor_matches_jax(path):
    """``chip_smoke.floor_from_truth`` (the map_floor recipe) in both
    packages, JAX's in float64: states and RMSE within 1e-3 m, the same LM
    iterations, final NLL within 1e-6 of JAX's.  case1's truth is a fixed
    point; lawnmower_4x4 (collinear sightings) is ill-conditioned, and the
    JAX package's float32 solve stops there at its cap short of the
    optimum (RMSE 2.475 m against 2.618 m)."""
    runs = []
    for parse, new in ((lambda p: j_parse(p, "fg"), JaxFloat64MAP),
                       (graph_file_parser,
                        lambda: IncrementalGaussNewtonMAP(device="cpu"))):
        nodes, truth, factors = parse(path)
        m = new()
        m.update(nodes, factors)
        r = chip_smoke.floor_from_truth(m, truth)
        runs.append((r, np.array(m._x)))
    (theirs, xj), (ours, xt) = runs
    np.testing.assert_allclose(xt, xj, atol=1e-3)
    assert abs(ours["rmse"] - theirs["rmse"]) < 1e-3
    assert ours["iters"] == theirs["iters"]
    assert abs(ours["nll"] - theirs["nll"]) <= 1e-6 * abs(theirs["nll"])


def test_map_gate_fails_the_float32_plaza1_floor(monkeypatch):
    """``chip_smoke.map_gate`` on the full-size plaza1 floor: the port's
    float64 solve passes it; the same solve in float32, which stops at its
    iteration cap where its rounding takes it, fails it."""
    label = "plaza1 truth floor"

    def floor():
        return chip_smoke.map_case(
            label, graph_file_parser,
            lambda: IncrementalGaussNewtonMAP(device="cpu"))

    assert chip_smoke.map_gate(label, floor())
    monkeypatch.setattr(tb, "MAP_DTYPE", torch.float32)
    assert not chip_smoke.map_gate(label, floor())
