"""The port's Caesar.jl export (``io/caesar.py``) against the JAX
package's: on case1, lawnmower_4x4 in batches of 5 (its ambiguous ranges
become ``multihypo`` factors, as ``tests/test_caesar_surface.py`` builds
it) and case1_da, the port's script equals the JAX package's byte for
byte, every statement fits both packages' grammars
(``io/caesar_surface.py``), every symbol is declared before a factor
uses it, and the multihypo weights are [1; w] with w summing to 1."""
import os
import re
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import nfisam_tpu.io as jio  # noqa: E402
from nfisam_tpu.io.caesar_surface import \
    validate_script as j_validate  # noqa: E402
import nfisam_tpu_torch.io as tio  # noqa: E402
from nfisam_tpu_torch.io.caesar_surface import (ALLOWED_LINES,  # noqa: E402
                                                validate_script)

GRAPHS = [("case1_factor_graph.fg", 1), ("lawnmower_4x4_factor_graph.fg", 5),
          ("case1_da_factor_graph.fg", 1)]


def scripts(name: str, step: int, **kwargs) -> tuple:
    """(the JAX package's script, the port's) for a graph file."""
    path = os.path.join(REPO, "data", name)
    out = []
    for io in (jio, tio):
        nodes, truth, factors = io.graph_file_parser(path, "fg")
        batches = io.group_nodes_factors_incrementally(
            nodes, factors, incremental_step=step)
        out.append(io.export_caesar_script(batches, truth=truth, **kwargs))
    return tuple(out)


@pytest.mark.parametrize("name, step", GRAPHS)
def test_script_equals_the_jax_packages(name, step):
    theirs, ours = scripts(name, step)
    assert ours == theirs
    kw = dict(output_dir="mmisam_out", posterior_sample_num=500)
    theirs, ours = scripts(name, step, **kw)
    assert ours == theirs and 'output_dir = "mmisam_out"' in ours


@pytest.mark.parametrize("name, step", GRAPHS)
def test_script_fits_both_grammars(name, step):
    _, ours = scripts(name, step)
    assert validate_script(ours) == [] == j_validate(ours)
    if "da" in name or "lawnmower" in name:
        assert "multihypo=" in ours


@pytest.mark.parametrize("name, step", GRAPHS)
def test_symbols_declared_before_use_and_multihypo_weights(name, step):
    _, script = scripts(name, step)
    declared = set()
    for line in script.splitlines():
        m = re.match(r"addVariable!\(fg, :(\w+),", line)
        if m:
            declared.add(m.group(1))
        m = re.match(r"addFactor!\(fg, \[([^\]]+)\]", line)
        if m:
            assert set(re.findall(r":(\w+)", m.group(1))) <= declared
    for m in re.finditer(r"multihypo=\[([^\]]+)\]", script):
        w = [float(x) for x in m.group(1).split(";")]
        assert w[0] == 1.0 and len(w) >= 3
        assert abs(sum(w[1:]) - 1.0) < 1e-6


def test_grammar_is_the_jax_packages_and_rejects_drift(tmp_path):
    """The same statement forms as the JAX package's surface; a renamed
    call is reported; ``write_caesar_script`` writes the script."""
    from nfisam_tpu.io.caesar_surface import ALLOWED_LINES as J_ALLOWED
    assert ALLOWED_LINES == J_ALLOWED
    _, script = scripts(*GRAPHS[0])
    bad = script.replace("Pose2Pose2(", "Pose2Pose2Rel(", 1)
    lines = validate_script(bad)
    assert len(lines) == 1 and "Pose2Pose2Rel" in lines[0][1]
    path = os.path.join(tmp_path, "case1.jl")
    nodes, truth, factors = tio.graph_file_parser(
        os.path.join(REPO, "data", GRAPHS[0][0]))
    batches = tio.group_nodes_factors_incrementally(nodes, factors, 1)
    assert tio.write_caesar_script(path, batches, truth=truth) == path
    with open(path) as fh:
        assert fh.read() == script


def test_unmapped_factor_raises():
    """A factor with no Caesar form raises, as in the JAX package."""
    from nfisam_tpu_torch.core.variables import R2Variable
    from nfisam_tpu_torch.factors import UnaryR2GaussianPriorFactor
    v = R2Variable("L1")
    with pytest.raises(NotImplementedError):
        tio.export_caesar_script([([v], [UnaryR2GaussianPriorFactor(
            v, np.zeros(2), np.eye(2))])])
