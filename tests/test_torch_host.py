"""The port's host layer against the JAX package's: ``.fg`` parsing, the
key stream, incremental batching, pose_first ordering and Bayes trees.
These are exact (names, structure, integer keys); parsed float values
compare with zero tolerance."""
import os

import numpy as np
import pytest
import torch

from nfisam_tpu.graph import FactorGraph as JFactorGraph
from nfisam_tpu.io import graph_file_parser as j_parse
from nfisam_tpu.io import group_nodes_factors_incrementally as j_group
from nfisam_tpu.utils import KeyStream as JKeyStream
from nfisam_tpu.utils import split_host as j_split_host
from nfisam_tpu_torch.factors import Factor
from nfisam_tpu_torch.graph import FactorGraph
from nfisam_tpu_torch.io import graph_file_parser, group_nodes_factors_incrementally
from nfisam_tpu_torch.utils import (KeyStream, generator_seed, split_host,
                                    torch_generator)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
CASE1 = os.path.join(DATA, "case1_factor_graph.fg")
PLAZA1 = os.path.join(DATA, "plaza1_factor_graph.fg")

_FACTOR_FIELDS = ("prior_pose", "covariance", "obs", "sigma")


def _factor_summary(f):
    out = [type(f).__name__, [str(v.name) for v in f.vars]]
    for field in _FACTOR_FIELDS:
        if hasattr(f, field):
            out.append((field, np.asarray(getattr(f, field)).tolist()))
    return out


def _graph_summary(nodes, truth, factors):
    return ([(str(v.name), type(v).__name__, v.type.value, v.dim,
              v.circular_dim_list) for v in nodes],
            {str(v.name): np.asarray(t).tolist() for v, t in truth.items()},
            [_factor_summary(f) for f in factors])


@pytest.fixture
def plaza1_head(tmp_path):
    path = tmp_path / "plaza1_head.fg"
    with open(PLAZA1) as f:
        lines = [next(f) for _ in range(200)]
    path.write_text("".join(lines))
    return str(path)


@pytest.mark.parametrize("which", ["case1", "plaza1_head"])
def test_fg_parsing_matches_jax(which, plaza1_head):
    path = CASE1 if which == "case1" else plaza1_head
    ours = _graph_summary(*graph_file_parser(path))
    theirs = _graph_summary(*j_parse(path, "fg"))
    assert ours == theirs
    assert len(ours[0]) > 0


def test_unregistered_factor_type_raises(tmp_path):
    nodes, _, _ = graph_file_parser(CASE1)
    with pytest.raises(ValueError, match="NoSuchFactor"):
        Factor.construct_from_text("Factor NoSuchFactor X0 X1 1.0", nodes)
    path = tmp_path / "bad.fg"
    path.write_text("Variable Pose SE2 X0 0.0 0.0 0.0\n"
                    "Factor NoSuchFactor X0 1.0\n")
    with pytest.raises(ValueError, match="NoSuchFactor"):
        graph_file_parser(str(path))


def test_unknown_variable_raises(tmp_path):
    path = tmp_path / "bad.fg"
    path.write_text("Variable Pose SE2 X0 0.0 0.0 0.0\n"
                    "Factor SE2R2RangeGaussianLikelihoodFactor X0 L9 3.0 "
                    "1.0\n")
    with pytest.raises(ValueError, match="unknown variable"):
        graph_file_parser(str(path))


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 33 + 5])
def test_key_stream_and_split_match_jax(seed):
    ours, theirs = KeyStream(seed), JKeyStream(seed)
    for _ in range(50):
        k = ours()
        np.testing.assert_array_equal(k, theirs())
        np.testing.assert_array_equal(split_host(k, 5), j_split_host(k, 5))


def test_torch_generator_is_deterministic_per_key():
    k1, k2 = KeyStream(3)(), KeyStream(4)()
    a = torch.rand(8, generator=torch_generator(k1, "cpu"))
    b = torch.rand(8, generator=torch_generator(k1, "cpu"))
    c = torch.rand(8, generator=torch_generator(k2, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("lo", [7, 0, 2 ** 32 - 1])
def test_cpu_generator_draws_differ_with_the_high_word(lo):
    """Keys that differ only in their first word draw differently on the
    CPU (mt19937 keeps 32 bits of its seed), and so do their
    ``split_host`` children, whose low words agree (ROADMAP C7)."""
    def draws(key):
        return torch.rand(8, generator=torch_generator(key, "cpu"))

    keys = [np.array([hi, lo], np.uint32) for hi in range(4)]
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(draws(a), draws(b))
            for ca, cb in zip(split_host(a, 3), split_host(b, 3)):
                assert ca[1] == cb[1]
                assert not torch.equal(draws(ca), draws(cb))


def test_generator_seed_keeps_the_cards_64_bit_word():
    """On a card the seed is the key's 64-bit word whole, so the card's
    Philox streams do not depend on the CPU's fold; on the CPU the seed
    fits the 32 bits mt19937 keeps and depends on both words."""
    key = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    assert generator_seed(key, "cuda") == 0x12345678 << 32 | 0x9ABCDEF0
    assert generator_seed([0, 7], "cuda") == 7
    cpu = [generator_seed([hi, lo], "cpu") for hi in range(64)
           for lo in (0, 7, 2 ** 32 - 1)]
    assert all(0 <= s < 2 ** 32 for s in cpu)
    assert len(set(cpu)) == len(cpu)
    gen = torch_generator(key, "cpu")
    assert gen.initial_seed() == generator_seed(key, "cpu")


def _batches_summary(batches):
    return [([str(v.name) for v in ns], [_factor_summary(f) for f in fs])
            for ns, fs in batches]


@pytest.mark.parametrize("which", ["case1", "plaza1_head"])
@pytest.mark.parametrize("step", [1, 2, None])
def test_incremental_batches_match_jax(which, step, plaza1_head):
    path = CASE1 if which == "case1" else plaza1_head
    nodes, _, factors = graph_file_parser(path)
    j_nodes, _, j_factors = j_parse(path, "fg")
    ours = _batches_summary(group_nodes_factors_incrementally(
        nodes, factors, incremental_step=step))
    theirs = _batches_summary(j_group(j_nodes, j_factors,
                                      incremental_step=step))
    assert ours == theirs


def _tree_summary(tree):
    out = []
    for c in tree.clique_ordering():
        out.append((sorted(str(v.name) for v in c.frontal),
                    sorted(str(v.name) for v in c.separator),
                    repr(c.parent) if c.parent is not None else None))
    return out


def test_pose_first_bayes_trees_match_jax_at_every_case1_step():
    nodes, _, factors = graph_file_parser(CASE1)
    j_nodes, _, j_factors = j_parse(CASE1, "fg")
    ours, theirs = FactorGraph(), JFactorGraph()
    batches = group_nodes_factors_incrementally(nodes, factors, 1)
    j_batches = j_group(j_nodes, j_factors, incremental_step=1)
    assert len(batches) == 6
    for (ns, fs), (jns, jfs) in zip(batches, j_batches):
        for v in ns:
            ours.add_node(v)
        for v in jns:
            theirs.add_node(v)
        for f in fs:
            ours.add_factor(f)
        for f in jfs:
            theirs.add_factor(f)
        order = ours.analyze_elimination_ordering("pose_first")
        j_order = theirs.analyze_elimination_ordering("pose_first")
        assert [str(v.name) for v in order] == \
            [str(v.name) for v in j_order]
        assert _tree_summary(ours.build_bayes_tree(order)) == \
            _tree_summary(theirs.build_bayes_tree(j_order))


def test_ccolamd_is_not_ported():
    """Named while ccolamd raised here.  It is ported now
    (``graph/ordering.py``): an empty graph orders to [], case1 to the JAX
    package's ordering with the newest pose last
    (``test_torch_ordering.py`` holds it on more graphs), and an unknown
    method still raises."""
    assert FactorGraph().analyze_elimination_ordering("ccolamd") == []
    nodes, _, factors = graph_file_parser(CASE1)
    j_nodes, _, j_factors = j_parse(CASE1, "fg")
    ours, theirs = FactorGraph(), JFactorGraph()
    for v in nodes:
        ours.add_node(v)
    for v in j_nodes:
        theirs.add_node(v)
    for f in factors:
        ours.add_factor(f)
    for f in j_factors:
        theirs.add_factor(f)
    order = [str(v.name) for v in ours.analyze_elimination_ordering("ccolamd")]
    assert order == [str(v.name) for v in
                     theirs.analyze_elimination_ordering("ccolamd")]
    assert order[-1] == "X5"
    with pytest.raises(ValueError):
        FactorGraph().analyze_elimination_ordering("amd")
