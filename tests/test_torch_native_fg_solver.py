"""The port's MAP solvers against the native C++ ``.fg`` MAP solver
(``native/fg_solver.cc``), as ``tests/test_native_fg_solver.py`` holds
the JAX package's: on case1, ``GaussNewtonMAP`` (float32 LM with Laplace
marginals) and the banked float64 LM (``IncrementalGaussNewtonMAP``) each
lie within 0.05 m and 0.05 rad of the binary's estimate.  The binary runs
as a subprocess (the package loads nothing from ``native/``); the test
skips only where ``make fg_solver`` fails.
"""
import json
import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
BIN = os.path.join(NATIVE, "fg_solver")
CASE1 = os.path.join(REPO, "data", "case1_factor_graph.fg")


@pytest.fixture(scope="module")
def native_estimate(tmp_path_factory):
    """(summary, {name: estimate}) of the binary on case1."""
    if not os.path.exists(BIN):
        r = subprocess.run(["make", "-s", "fg_solver"], cwd=NATIVE,
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"cannot build fg_solver: {r.stderr[:200]}")
    dump = tmp_path_factory.mktemp("native") / "est.txt"
    r = subprocess.run([BIN, CASE1, "100", "--dump", str(dump)],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    est = {}
    with open(dump) as fh:
        for line in fh:
            parts = line.split()
            est[parts[0]] = np.asarray([float(x) for x in parts[1:]])
    return json.loads(r.stdout.strip().splitlines()[-1]), est


def _port_map(kind: str) -> dict:
    from nfisam_tpu_torch.io import graph_file_parser
    from nfisam_tpu_torch.solver import (GaussNewtonMAP,
                                         IncrementalGaussNewtonMAP)

    nodes, _, factors = graph_file_parser(CASE1, "fg")
    if kind == "GaussNewtonMAP":
        m = GaussNewtonMAP(nodes, factors, device="cpu")
    else:
        m = IncrementalGaussNewtonMAP(device="cpu")
        m.update(nodes, factors)
    m.solve()
    return {str(v.name): np.asarray(x, np.float64)
            for v, x in m.results().items()}


@pytest.mark.parametrize("kind", ["GaussNewtonMAP", "banked float64 LM"])
def test_port_map_matches_the_native_solver_on_case1(native_estimate, kind):
    summary, est = native_estimate
    assert summary["iters"] >= 1
    ours = _port_map(kind)
    assert set(ours) == set(est)
    for name, x in ours.items():
        native = est[name]
        assert np.linalg.norm(x[:2] - native[:2]) < 0.05, \
            f"{name}: native {native[:2]} vs port {x[:2]}"
        if x.shape[0] == 3:
            d = abs(float(x[2]) - float(native[2])) % (2 * np.pi)
            assert min(d, 2 * np.pi - d) < 0.05, name
