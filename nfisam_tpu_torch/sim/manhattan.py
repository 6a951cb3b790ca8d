"""Manhattan-world range-SLAM simulator.

The port's own copy of ``nfisam_tpu/sim/manhattan.py``: a grid world with
robot and landmark feasibility masks, random-walk, edge and lawnmower
trajectories, and SLAM factor emission with ambiguous-data-association
and outlier (null-hypothesis) injection.  A host-side generator in plain
numpy: it draws from ``np.random.default_rng(seed)`` in the JAX
package's order, so a seed gives the JAX package's graph, and its
``.fg`` file byte for byte.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.variables import (R2Variable, SE2Variable, Variable,
                              VariableType)
from ..factors.factors import (SE2R2RangeGaussianLikelihoodFactor,
                               SE2RelativeGaussianLikelihoodFactor,
                               UnarySE2ApproximateGaussianPriorFactor)
from ..factors.mixtures import (AmbiguousDataAssociationFactor,
                                BinaryFactorWithNullHypo)


# host-side SE(2) helpers: the data is made pose by pose, in float64

def _wrap(t):
    return (t + np.pi) % (2 * np.pi) - np.pi


def _compose(a, b):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1],
                     _wrap(a[2] + b[2])])


def _se2_exp(v):
    vx, vy, w = float(v[0]), float(v[1]), float(v[2])
    if abs(w) < 1e-9:
        a, b = 1.0 - w * w / 6.0, w / 2.0 - w ** 3 / 24.0
    else:
        a, b = np.sin(w) / w, (1.0 - np.cos(w)) / w
    return np.array([a * vx - b * vy, b * vx + a * vy, _wrap(w)])


def _range_and_bearing(pose, pt):
    pose = np.asarray(pose, dtype=float)
    pt = np.asarray(pt, dtype=float)
    d = pt[:2] - pose[:2]
    rng = float(np.hypot(d[0], d[1]))
    c, s = np.cos(-pose[2]), np.sin(-pose[2])
    local = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]])
    return rng, float(np.arctan2(local[1], local[0]))


@dataclass
class SimulationArgs:
    """Knobs for measurement synthesis (reference ``SimulationArgs``
    Simulator.py:12)."""
    range_sensing_prob: float = 0.5
    ambiguous_data_association_prob: float = 0.0
    outlier_prob: float = 0.0
    outlier_scale: float = 5.0
    outlier_weights: Tuple[float, float] = (0.5, 0.5)
    seed: int = 0
    range_std: float = 4.0
    max_da_lmk: int = 3
    # sensing radius: 0/inf disables (reference parity — its grids were
    # small enough that everything was in range).  Real range sensors
    # (the Plaza UWB beacons) top out at tens of meters; unbounded
    # ranges on large worlds produce ~300 m ambiguous rings that no
    # commit-as-you-go solver recovers from (measured: 1024-pose
    # unbounded run diverged to 258 m RMSE while its truth-init MAP
    # floor was 1.1 m — results/manhattan_scale_unbounded_range.json).
    max_sensing_range: float = 0.0


@dataclass(eq=False)
class GridRobot:
    """Grid-walking robot with odometry + range noise models
    (reference ``GridRobot`` Agent.py:34)."""
    name: str
    step_scale: float = 1.0
    range_std: float = 0.2
    odom_cov: np.ndarray = field(
        default_factory=lambda: np.diag([0.1, 0.1, 0.02]))
    move_probs: np.ndarray = field(
        default_factory=lambda: np.array([0.5, 0.2, 0.2, 0.1]))
    noise_free_obs: bool = False

    def range_measurement(self, rng, gt_range: float) -> float:
        if self.noise_free_obs:
            return gt_range
        return float(rng.normal(gt_range, self.range_std))

    def odom_measurement(self, rng, gt_rel: np.ndarray) -> np.ndarray:
        if self.noise_free_obs:
            return gt_rel
        noise = rng.multivariate_normal(np.zeros(3), self.odom_cov)
        return _compose(gt_rel, _se2_exp(noise))

    def select_goal(self, rng, cur_pose: np.ndarray,
                    goals: List[Tuple[float, float]]):
        """Weight candidate waypoints by relative bearing: forward, left,
        right, turn-around (reference Agent.py:58-70)."""
        weights = np.zeros(len(goals))
        for i, goal in enumerate(goals):
            r, b = _range_and_bearing(cur_pose, np.asarray(goal,
                                                            dtype=float))
            if abs(b) < 1e-1:
                weights[i] = self.move_probs[0]
            elif abs(b + np.pi / 2) < 1e-1:
                weights[i] = self.move_probs[1]
            elif abs(b - np.pi / 2) < 1e-1:
                weights[i] = self.move_probs[2]
            elif abs(abs(b) - np.pi) < 1e-1:
                weights[i] = self.move_probs[3]
        if weights.sum() == 0:
            weights[:] = 1.0
        weights = weights / weights.sum()
        return goals[rng.choice(len(goals), p=weights)]

    def local_path(self, cur_pose: np.ndarray, goal_xy,
                   tol: float = 1e-4) -> List[np.ndarray]:
        """Relative moves: first a turn-and-step toward the goal, then
        straight steps (reference ``local_path_planner`` Agent.py:73)."""
        r, b = _range_and_bearing(cur_pose, np.asarray(goal_xy,
                                                        dtype=float))
        q, remainder = divmod(r, self.step_scale)
        steps = math.ceil(q)
        if steps > 0:
            moves = [np.array([self.step_scale * np.cos(b),
                               self.step_scale * np.sin(b), b])]
            moves += [np.array([self.step_scale, 0.0, 0.0])
                      for _ in range(1, steps)]
            if remainder > tol:
                moves.append(np.array([remainder, 0.0, 0.0]))
        else:
            moves = [np.array([remainder * np.cos(b),
                               remainder * np.sin(b), b])]
        return moves


@dataclass(eq=False)
class GridBeacon:
    name: str


class ManhattanGrid:
    """Grid environment with feasibility masks (reference
    ``ManhattanWaterworld`` Environment.py:16)."""

    def __init__(self, grid_vertices_shape=(9, 9), cell_scale: float = 1.0,
                 robot_area=None, landmark_area=None):
        self.nx, self.ny = grid_vertices_shape
        self.scale = cell_scale
        self.x_coords = np.arange(self.nx) * cell_scale
        self.y_coords = np.arange(self.ny) * cell_scale
        self.robot_feasibility = np.ones((self.nx, self.ny), dtype=bool)
        self.landmark_feasibility = np.zeros((self.nx, self.ny), dtype=bool)
        if robot_area is not None:
            bl, tr = robot_area
            self.robot_feasibility[:] = False
            self.robot_feasibility[bl[0]:tr[0] + 1, bl[1]:tr[1] + 1] = True
            self.landmark_feasibility = ~self.robot_feasibility
        elif landmark_area is not None:
            bl, tr = landmark_area
            self.landmark_feasibility[:] = False
            self.landmark_feasibility[bl[0]:tr[0] + 1,
                                      bl[1]:tr[1] + 1] = True
            self.robot_feasibility = ~self.landmark_feasibility
        self.robot_poses: Dict[GridRobot, np.ndarray] = {}
        self.landmark_points: Dict[GridBeacon, np.ndarray] = {}

    # ------------------------------------------------------------ geometry
    def vertex2coordinate(self, i: int, j: int) -> Tuple[float, float]:
        return (float(self.x_coords[i]), float(self.y_coords[j]))

    def neighbors(self, i: int, j: int) -> List[Tuple[int, int]]:
        out = []
        for di, dj in ((1, 0), (0, 1), (-1, 0), (0, -1)):
            a, b = i + di, j + dj
            if 0 <= a < self.nx and 0 <= b < self.ny:
                out.append((a, b))
        return out

    def feasible_neighbors(self, i, j, feas=None):
        feas = self.robot_feasibility if feas is None else feas
        return [v for v in self.neighbors(i, j) if feas[v[0], v[1]]]

    def nearest_vertex(self, x: float, y: float) -> Tuple[int, int]:
        i = int(np.argmin(np.abs(self.x_coords - x)))
        j = int(np.argmin(np.abs(self.y_coords - y)))
        return i, j

    def waypoint_candidates(self, x: float, y: float
                            ) -> List[Tuple[float, float]]:
        """Neighboring feasible vertices of the current (on-grid) position."""
        i, j = self.nearest_vertex(x, y)
        cands = self.feasible_neighbors(i, j)
        return [self.vertex2coordinate(*v) for v in cands]

    # -------------------------------------------------------------- agents
    def add_robot(self, rbt: GridRobot, i: int, j: int,
                  orientation: float = 0.0) -> bool:
        if not self.robot_feasibility[i, j] or rbt in self.robot_poses:
            return False
        x, y = self.vertex2coordinate(i, j)
        self.robot_poses[rbt] = np.array([x, y, orientation])
        return True

    def add_landmark(self, lmk: GridBeacon, i: int, j: int) -> bool:
        if not self.landmark_feasibility[i, j] or \
                lmk in self.landmark_points:
            return False
        x, y = self.vertex2coordinate(i, j)
        self.landmark_points[lmk] = np.array([x, y])
        return True

    @property
    def robots(self) -> List[GridRobot]:
        return list(self.robot_poses)

    @property
    def landmarks(self) -> List[GridBeacon]:
        return list(self.landmark_points)

    # ---------------------------------------------------------------- paths
    def lawnmower_path(self, feas: Optional[np.ndarray] = None
                       ) -> List[Tuple[int, int]]:
        """Boustrophedon sweep over the feasible area (reference
        ``robot_lawn_mower`` Environment.py:365)."""
        feas = self.robot_feasibility if feas is None else feas
        wps: List[Tuple[int, int]] = []
        flip = False
        for j in range(feas.shape[1]):
            idx = np.where(feas[:, j])[0]
            if idx.size == 0:
                continue
            wps += [(int(i), j) for i in (idx[::-1] if flip else idx)]
            flip = not flip
        return wps

    def edge_path(self) -> List[Tuple[int, int]]:
        """Counter-clockwise loop along the boundary of the feasible area
        (reference ``robot_edge_path`` Environment.py:301)."""
        feas = self.robot_feasibility.copy()
        edge = {tuple(p) for p in np.argwhere(feas)
                if len(self.feasible_neighbors(*p, feas)) < 4}
        start = min(edge)
        path = [start]
        visited = {start}
        order = [(1, 0), (0, 1), (-1, 0), (0, -1)]
        while True:
            i, j = path[-1]
            cands = [v for v in self.feasible_neighbors(i, j)
                     if v in edge and v not in visited]
            if not cands:
                break
            cands.sort(key=lambda v: order.index((v[0] - i, v[1] - j)))
            path.append(cands[0])
            visited.add(cands[0])
        return path


class ManhattanSimulator:
    """SLAM factor emission along grid trajectories (reference
    ``ManhattanSimulator`` Simulator.py:38)."""

    def __init__(self, env: ManhattanGrid, args: SimulationArgs):
        self.env = env
        self.args = args
        seed = args.seed if args.seed >= 0 else None
        self.rng = np.random.default_rng(seed)

    # --------------------------------------------------------- measurement
    def _emit_range_factor(self, cur_pose, rbt: GridRobot,
                           rbt_var: SE2Variable,
                           lmk_vars: List[R2Variable], factors: List,
                           var2truth: Dict, has_da: List[bool]) -> None:
        """One randomly chosen landmark per pose; injects ADA / outlier
        factors per the configured probabilities (reference
        ``add_one_range_factor`` Simulator.py:117)."""
        env, args, rng = self.env, self.args, self.rng
        if not env.landmarks:
            return
        visible = env.landmarks
        if args.max_sensing_range and np.isfinite(args.max_sensing_range):
            visible = [l for l in env.landmarks
                       if np.linalg.norm(env.landmark_points[l]
                                         - cur_pose[:2])
                       <= args.max_sensing_range]
            if not visible:
                return
        lmk = visible[rng.integers(len(visible))]
        lmk_pt = env.landmark_points[lmk]
        if rng.random() >= args.range_sensing_prob:
            return
        r = float(np.linalg.norm(lmk_pt - cur_pose[:2]))
        var = R2Variable(name=lmk.name,
                         variable_type=VariableType.Landmark)
        noisy_r = rbt.range_measurement(rng, r)
        sigma = rbt.range_std
        odd = rng.random()
        known = set(lmk_vars)

        others = [v for v in lmk_vars if v != var]
        if args.max_sensing_range and np.isfinite(args.max_sensing_range):
            # confusable candidates are the ones the sensor could
            # actually be hearing — landmarks inside the sensing radius
            others = [v for v in others
                      if np.linalg.norm(np.asarray(var2truth[v])[:2]
                                        - cur_pose[:2])
                      <= args.max_sensing_range]
        if len(others) > args.max_da_lmk - 1:
            rng.shuffle(others)
            others = others[:args.max_da_lmk - 1]
        observed = [var] + others

        if odd < args.outlier_prob:
            if var not in known:
                lmk_vars.append(var)
                var2truth[var] = lmk_pt.copy()
            outlier_r = noisy_r + args.outlier_scale * sigma
            factors.append(BinaryFactorWithNullHypo(
                var1=rbt_var, var2=var,
                weights=np.asarray(args.outlier_weights),
                binary_factor_class=SE2R2RangeGaussianLikelihoodFactor,
                observation=outlier_r, sigma=sigma,
                null_sigma_scale=args.outlier_scale))
        elif (odd < args.outlier_prob +
              args.ambiguous_data_association_prob and var in known and
              len(observed) > 1 and not has_da[0]):
            factors.append(AmbiguousDataAssociationFactor(
                observer_var=rbt_var, observed_vars=observed,
                weights=np.ones(len(observed)) / len(observed),
                binary_factor_class=SE2R2RangeGaussianLikelihoodFactor,
                observation=noisy_r, sigma=sigma))
            has_da[0] = True
        else:
            if var not in known:
                lmk_vars.append(var)
                var2truth[var] = lmk_pt.copy()
            factors.append(SE2R2RangeGaussianLikelihoodFactor(
                var1=rbt_var, var2=var, observation=noisy_r, sigma=sigma))

    # ----------------------------------------------------------- trajectory
    def _walk(self, rbt: GridRobot, moves_source, rbt_prefix: str,
              prior_pose_cov: np.ndarray):
        env = self.env
        rbt_vars: List[SE2Variable] = []
        lmk_vars: List[R2Variable] = []
        var2truth: Dict[Variable, np.ndarray] = {}
        factors: List = []
        pose_id = 0
        last_pose = env.robot_poses[rbt]
        last_var = SE2Variable(rbt_prefix + str(pose_id))
        rbt_vars.append(last_var)
        var2truth[last_var] = last_pose.copy()
        factors.append(UnarySE2ApproximateGaussianPriorFactor(
            var=last_var, prior_pose=last_pose,
            covariance=prior_pose_cov))
        has_da = [False]
        self._emit_range_factor(last_pose, rbt, last_var, lmk_vars,
                                factors, var2truth, has_da)
        for moves in moves_source(last_pose):
            for move in moves:
                pose_id += 1
                var = SE2Variable(rbt_prefix + str(pose_id))
                rbt_vars.append(var)
                cur_pose = _compose(last_pose, move)
                var2truth[var] = cur_pose.copy()
                env.robot_poses[rbt] = cur_pose
                noisy = rbt.odom_measurement(self.rng, move)
                factors.append(SE2RelativeGaussianLikelihoodFactor(
                    var1=last_var, var2=var, observation=noisy,
                    covariance=rbt.odom_cov))
                # reset per pose: the reference allows one DA factor PER
                # POSE (``add_range_factors`` Simulator.py:65 re-inits
                # has_da each call); carrying it across the walk silently
                # capped every generated workload at a single DA factor
                has_da = [False]
                self._emit_range_factor(cur_pose, rbt, var, lmk_vars,
                                        factors, var2truth, has_da)
                last_pose, last_var = cur_pose, var
        return rbt_vars, lmk_vars, factors, var2truth

    def random_walk_slam(self, rbt: GridRobot, num_waypoints: int = 50,
                         rbt_prefix: str = "X",
                         prior_pose_cov: np.ndarray = None):
        """Random-walk trajectory SLAM (reference
        ``single_robot_range_slam_iterate`` Simulator.py:186)."""
        prior_pose_cov = prior_pose_cov if prior_pose_cov is not None \
            else np.diag([0.1, 0.1, 0.02])
        env = self.env

        def moves_source(start_pose):
            pose = start_pose
            for _ in range(num_waypoints):
                goals = env.waypoint_candidates(pose[0], pose[1])
                if not goals:
                    return
                goal = rbt.select_goal(self.rng, pose, goals)
                moves = rbt.local_path(pose, goal)
                for m in moves:
                    pose = _compose(pose, m)
                yield moves

        return self._walk(rbt, moves_source, rbt_prefix, prior_pose_cov)

    def waypoint_slam(self, rbt: GridRobot,
                      waypoints: List[Tuple[int, int]],
                      rbt_prefix: str = "X",
                      prior_pose_cov: np.ndarray = None):
        """Follow given grid waypoints (reference
        ``single_robot_range_slam_given_waypoints`` Simulator.py:262)."""
        prior_pose_cov = prior_pose_cov if prior_pose_cov is not None \
            else np.diag([0.1, 0.1, 0.02])
        env = self.env

        def moves_source(start_pose):
            pose = start_pose
            for wp in waypoints:
                goal = env.vertex2coordinate(*wp)
                moves = rbt.local_path(pose, goal)
                for m in moves:
                    pose = _compose(pose, m)
                yield moves

        return self._walk(rbt, moves_source, rbt_prefix, prior_pose_cov)
