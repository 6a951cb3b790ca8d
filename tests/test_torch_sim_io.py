"""The port's simulator and graph IO against the JAX package's: the
``simulate`` command writes the JAX CLI's file byte for byte (three
trajectories, two seeds, with ambiguous data association and outliers),
the environment's masks and paths are the JAX package's, the g2o and
TORO readers give the same nodes, truth and factor strings, and the
``.fg`` writer gives the JAX package's text and reads back."""
import os

import numpy as np
import pytest

from nfisam_tpu import cli as j_cli
from nfisam_tpu.io import graph_file_parser as j_parse
from nfisam_tpu.io import write_factor_graph_to_file as j_write
from nfisam_tpu.sim import manhattan as j_sim
from nfisam_tpu_torch import cli
from nfisam_tpu_torch.factors import (SE2R2RangeGaussianLikelihoodFactor,
                                      SE2RelativeGaussianLikelihoodFactor)
from nfisam_tpu_torch.io import (graph_file_parser,
                                 group_nodes_factors_incrementally,
                                 read_factor_graph_from_file,
                                 write_factor_graph_to_file)
from nfisam_tpu_torch.io.fg_io import generate_measurements_for_factor_graph
from nfisam_tpu_torch.io.g2o import G2oToroPoseGraphReader
from nfisam_tpu_torch.sim import manhattan as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_sim_io.py's g2o and TORO files, and a g2o file with a
# correlated information matrix
G2O_JAX = """VERTEX_SE2 0 0.0 0.0 0.0
VERTEX_SE2 1 1.0 0.0 0.0
EDGE_SE2 0 1 1.0 0.0 0.0 100.0 0.0 0.0 100.0 0.0 400.0
"""
G2O = """VERTEX_SE2 0 0.0 0.0 0.0
VERTEX_SE2 1 1.0 0.0 0.0
VERTEX_SE2 2 2.0 0.5 0.1
EDGE_SE2 0 1 1.0 0.0 0.0 100.0 0.0 0.0 100.0 0.0 400.0
EDGE_SE2 1 2 1.0 0.5 0.1 90.0 1.0 0.5 80.0 0.2 300.0
"""
TORO = """VERTEX2 0 0.0 0.0 0.0
VERTEX2 1 2.0 0.0 0.0
EDGE2 0 1 2.0 0.0 0.0 25.0 0.0 25.0 100.0 0.0 0.0
"""


@pytest.mark.parametrize("trajectory", ["lawnmower", "edge", "random"])
@pytest.mark.parametrize("seed", [1, 2])
def test_simulate_writes_the_jax_cli_file(tmp_path, trajectory, seed):
    argv = ["simulate", "--trajectory", trajectory, "--seed", str(seed),
            "--ada-prob", "0.4", "--outlier-prob", "0.1"]
    ours, theirs = tmp_path / "ours.fg", tmp_path / "theirs.fg"
    assert cli.main(argv + ["--out", str(ours)]) == 0
    assert j_cli.main(argv + ["--out", str(theirs), "--platform", "cpu",
                              "--compile-cache", ""]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert "Factor SE2RelativeGaussianLikelihoodFactor" in ours.read_text()


def test_simulate_emits_ambiguous_and_outlier_factors(tmp_path):
    from nfisam_tpu_torch.factors.mixtures import (
        AmbiguousDataAssociationFactor, BinaryFactorWithNullHypo)
    env = sim.ManhattanGrid((4, 4), 20.0, robot_area=[(0, 0), (3, 3)])
    rbt = sim.GridRobot("A", step_scale=20.0, range_std=2.0)
    env.add_robot(rbt, 0, 0)
    env.landmark_feasibility[:] = True
    for k, (i, j) in enumerate([(1, 1), (2, 2), (3, 1)]):
        env.add_landmark(sim.GridBeacon(f"L{k + 1}"), i, j)
    s = sim.ManhattanSimulator(env, sim.SimulationArgs(
        range_sensing_prob=1.0, ambiguous_data_association_prob=0.5,
        outlier_prob=0.2, seed=5, range_std=2.0))
    _, _, factors, _ = s.waypoint_slam(rbt, env.lawnmower_path()[1:])
    assert any(isinstance(f, BinaryFactorWithNullHypo) for f in factors)
    assert any(isinstance(f, AmbiguousDataAssociationFactor)
               for f in factors)


def test_environment_masks_and_paths_match_jax():
    for mod in (sim, j_sim):
        env = mod.ManhattanGrid((5, 5), 10.0, robot_area=[(1, 1), (3, 3)])
        assert env.robot_feasibility[1, 1] and not env.robot_feasibility[0, 0]
        assert env.landmark_feasibility[0, 0]
        assert not env.add_robot(mod.GridRobot("B"), 0, 0)
        assert not env.add_landmark(mod.GridBeacon("L2"), 2, 2)
    ours = sim.ManhattanGrid((6, 5), 1.0, robot_area=[(0, 0), (4, 3)])
    theirs = j_sim.ManhattanGrid((6, 5), 1.0, robot_area=[(0, 0), (4, 3)])
    assert ours.lawnmower_path() == theirs.lawnmower_path()
    assert ours.edge_path() == theirs.edge_path()
    path = ours.lawnmower_path()
    assert len(set(path)) == len(path) == 20
    for a, b in zip(path, path[1:]):
        assert abs(a[0] - b[0]) + abs(a[1] - b[1]) == 1


def test_simulated_graph_round_trips_and_groups(tmp_path):
    env = sim.ManhattanGrid((3, 3), 10.0, robot_area=[(0, 0), (2, 2)])
    rbt = sim.GridRobot("X", step_scale=10.0, range_std=1.0)
    env.add_robot(rbt, 0, 0)
    env.landmark_feasibility[:] = True
    env.add_landmark(sim.GridBeacon("L1"), 1, 1)
    s = sim.ManhattanSimulator(env, sim.SimulationArgs(
        range_sensing_prob=1.0, seed=1, range_std=1.0))
    rbt_vars, lmk_vars, factors, truth = s.waypoint_slam(
        rbt, env.lawnmower_path()[1:4])
    odos = [f for f in factors
            if isinstance(f, SE2RelativeGaussianLikelihoodFactor)]
    assert len(odos) == len(rbt_vars) - 1
    assert any(isinstance(f, SE2R2RangeGaussianLikelihoodFactor)
               for f in factors)
    all_vars = rbt_vars + lmk_vars
    path = str(tmp_path / "sim.fg")
    write_factor_graph_to_file(all_vars, factors, truth, path)
    nodes2, truth2, factors2 = read_factor_graph_from_file(path)
    assert [str(v) for v in nodes2] == [str(v) for v in all_vars]
    assert [str(f) for f in factors2] == [str(f) for f in factors]
    for v in nodes2:
        np.testing.assert_allclose(truth2[v], truth[v])
    # the JAX package writes the same bytes for the same graph
    jnodes, jtruth, jfactors = j_parse(path, "fg")
    j_write(jnodes, jfactors, jtruth, str(tmp_path / "theirs.fg"))
    write_factor_graph_to_file(nodes2, factors2, truth2,
                               str(tmp_path / "ours.fg"))
    assert (tmp_path / "ours.fg").read_bytes() == \
        (tmp_path / "theirs.fg").read_bytes()
    batches = group_nodes_factors_incrementally(all_vars, factors, 2)
    assert {v for b in batches for v in b[0]} == set(all_vars)
    assert sum(len(b[1]) for b in batches) == len(factors)


@pytest.mark.parametrize("name,content,fmt", [("toy.g2o", G2O_JAX, "g2o"),
                                              ("toy.graph", TORO, "toro"),
                                              ("corr.g2o", G2O, "g2o")])
def test_pose_graph_readers_match_jax(tmp_path, name, content, fmt):
    path = tmp_path / name
    path.write_text(content)
    for scale in (0.1, 0.5):
        nodes, truth, factors = graph_file_parser(str(path), fmt,
                                                  prior_cov_scale=scale)
        jn, jt, jf = j_parse(str(path), fmt, prior_cov_scale=scale)
        assert [str(v) for v in nodes] == [str(v) for v in jn]
        assert [str(f) for f in factors] == [str(f) for f in jf]
        for v, w in zip(nodes, jn):
            np.testing.assert_array_equal(truth[v], jt[w])
    reader = G2oToroPoseGraphReader(str(path))
    nodes, factors, _ = reader.data_for_solver()
    assert len(factors) == len(nodes)   # the anchor prior and the edges
    with pytest.raises(ValueError):
        G2oToroPoseGraphReader(str(tmp_path / "toy.txt"))


def test_generated_measurements_follow_the_truth(tmp_path):
    """Odometry between consecutive poses and one range to the nearest
    landmark in reach, each drawn near the ground truth."""
    from nfisam_tpu_torch.factors import factors as F
    src = tmp_path / "truth.fg"
    lines = [f"Variable Pose SE2 X{i} {3.0 * i} 0.0 0.0" for i in range(4)]
    lines += ["Variable Landmark R2 L1 4.0 3.0"]
    src.write_text("\n".join(lines) + "\n")
    out = tmp_path / "gen.fg"
    nodes, truth, factors = generate_measurements_for_factor_graph(
        str(src), F.SE2RelativeGaussianLikelihoodFactor,
        F.SE2R2RangeGaussianLikelihoodFactor, 4.0, str(out), seed=3,
        odometry_sigma=0.01, orientation_sigma=0.001, landmark_sigma=0.05)
    odos = [f for f in factors
            if isinstance(f, F.SE2RelativeGaussianLikelihoodFactor)]
    ranges = [f for f in factors
              if isinstance(f, F.SE2R2RangeGaussianLikelihoodFactor)]
    assert len(odos) == 3 and len(ranges) == 2   # X1 and X2 are in reach
    for f in odos:
        assert abs(f.obs[0] - 3.0) < 0.1 and abs(f.obs[2]) < 0.01
    for f in ranges:
        d = np.linalg.norm(truth[f.var1][:2] - truth[f.var2][:2])
        assert abs(f.obs[0] - d) < 0.3
    assert len(read_factor_graph_from_file(str(out))[2]) == 5
