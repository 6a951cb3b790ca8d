"""The port's ccolamd ordering (constrained minimum degree) against the
JAX package's, with its C++ library (``native/libnfisam_ordering.so``)
and with ``_load_native`` patched to the Python fallback, on case1,
plaza1, the Manhattan g8 graph and seeded random graphs; then a ccolamd
``ParallelNFiSAM`` on the first steps of the g8 stream in both packages,
orderings and trees step by step at small settings.  Orderings are
compared exactly."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import nfisam_tpu.graph.ordering as j_ordering  # noqa: E402
from nfisam_tpu.graph import FactorGraph as JFactorGraph  # noqa: E402
from nfisam_tpu.io import graph_file_parser as j_parse  # noqa: E402
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group  # noqa: E402
from nfisam_tpu.parallel import ParallelNFiSAM as JParallel  # noqa: E402
from nfisam_tpu.solver import NFiSAMArgs as JNFiSAMArgs  # noqa: E402
from nfisam_tpu_torch.graph import (FactorGraph,  # noqa: E402
                                    constrained_min_degree_indices)
from nfisam_tpu_torch.io import graph_file_parser  # noqa: E402
from nfisam_tpu_torch.io import group_nodes_factors_incrementally  # noqa: E402
from nfisam_tpu_torch.parallel import ParallelNFiSAM  # noqa: E402
from nfisam_tpu_torch.solver import NFiSAMArgs  # noqa: E402
from test_torch_solver import SMALL, _tree  # noqa: E402

torch.set_num_threads(1)
GRAPHS = {"case1": chip_smoke.CASE1_FG, "plaza1": chip_smoke.PLAZA1_FG,
          "manhattan_g8": chip_smoke.MANHATTAN_G8_FG}


@pytest.fixture(params=["native", "python"])
def jax_backend(request, monkeypatch):
    """The JAX package's ordering with its C++ library, or with the
    library hidden so that it takes its Python fallback."""
    if request.param == "native":
        assert j_ordering._load_native() is not None
    else:
        monkeypatch.setattr(j_ordering, "_load_native", lambda: None)
    return request.param


def _graph(cls, nodes, factors):
    g = cls()
    for v in nodes:
        g.add_node(v)
    for f in factors:
        g.add_factor(f)
    return g


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ccolamd_ordering_matches_jax(jax_backend, name):
    nodes, _, factors = j_parse(GRAPHS[name], "fg")
    theirs = _graph(JFactorGraph, nodes, factors
                    ).analyze_elimination_ordering("ccolamd")
    nodes, _, factors = graph_file_parser(GRAPHS[name])
    ours = _graph(FactorGraph, nodes, factors
                  ).analyze_elimination_ordering("ccolamd")
    assert [str(v.name) for v in ours] == [str(v.name) for v in theirs]
    # the newest pose is eliminated last
    assert str(ours[-1].name) == str([v for v in nodes if v.dim == 3][-1]
                                     .name)


@pytest.mark.parametrize("seed", range(6))
def test_min_degree_indices_match_jax_on_random_graphs(jax_backend, seed):
    """Random graphs of 20-80 vertices, edge density 2-15%, and up to
    three constraint groups."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 80))
    p = float(rng.uniform(0.02, 0.15))
    adj = [set() for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < p:
                adj[i].add(j)
                adj[j].add(i)
    cmember = rng.integers(0, 1 + seed % 3, n).astype(np.int32)
    theirs = j_ordering.constrained_min_degree_indices(n, adj, cmember)
    ours = constrained_min_degree_indices(n, adj, cmember)
    assert ours == theirs
    assert sorted(ours) == list(range(n))
    groups = [int(cmember[i]) for i in ours]
    assert groups == sorted(groups)


def _ccolamd_steps(solver, batches, to_numpy):
    """Orderings, trees and trained cliques step by step, and the error
    that stops the stream (None if it runs to its end)."""
    steps = []
    for ns, fs in batches:
        for n in ns:
            solver.add_node(n)
        for f in fs:
            solver.add_factor(f)
        try:
            solver.update_physical_and_working_graphs()
            solver.incremental_inference()
        except RuntimeError as e:
            return steps, str(e)
        steps.append({
            "ordering": [str(v.name) for v in solver._elimination_ordering],
            "working": _tree(solver.working_bayes_tree),
            "physical": _tree(solver.physical_bayes_tree),
            "trained": sorted(solver._temp_training_loss)})
    return steps, None


@pytest.fixture(scope="module")
def g8_runs():
    """Both packages' ccolamd ParallelNFiSAM on the g8 stream's first
    ``chip_smoke.MANHATTAN_STEPS`` + 1 steps (one pose a step) at 200
    training samples, 20 Adam iterations, mode repair on."""
    args = {**SMALL, "elimination_method": "ccolamd", "mode_repair": True,
            "local_sample_num": 200, "posterior_sample_num": 200,
            "flow_iterations": 20, "seed": 0}
    n = chip_smoke.MANHATTAN_STEPS + 1
    nodes, _, factors = j_parse(chip_smoke.MANHATTAN_G8_FG, "fg")
    theirs = _ccolamd_steps(JParallel(JNFiSAMArgs(**args)),
                            j_group(nodes, factors, 1)[:n], np.asarray)
    nodes, _, factors = graph_file_parser(chip_smoke.MANHATTAN_G8_FG)
    ours = _ccolamd_steps(ParallelNFiSAM(NFiSAMArgs(**args), device="cpu"),
                          group_nodes_factors_incrementally(nodes, factors,
                                                            1)[:n],
                          lambda x: x.numpy())
    return theirs, ours


@pytest.mark.parametrize("step", range(chip_smoke.MANHATTAN_STEPS))
def test_ccolamd_solver_matches_jax_step_by_step(g8_runs, step):
    (theirs, _), (ours, _) = g8_runs
    assert ours[step] == theirs[step]


def test_ccolamd_stream_stops_where_jax_stops(g8_runs):
    """At step ``MANHATTAN_STEPS`` L3 is first seen, by one range from
    X11; min degree eliminates it first, and the leaf clique {L3 | X11}
    has no factor to draw X11 from, so both packages' simulation raises
    (the cut of chip_smoke's Manhattan phase)."""
    (theirs, j_err), (ours, t_err) = g8_runs
    assert len(ours) == len(theirs) == chip_smoke.MANHATTAN_STEPS
    assert t_err == j_err and "disconnected clique factors" in t_err
    assert "X11 L3" in t_err
