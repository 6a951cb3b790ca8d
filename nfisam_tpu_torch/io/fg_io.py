"""Reader and writer of the text ``.fg`` factor-graph format.

Lines are ``Variable <Type> <Space> <name> <truth...>`` and
``Factor <ClassName> ...``, the grammar of ``nfisam_tpu/io/fg_io.py``;
a file the port writes is the file the JAX package writes, byte for
byte.  ``generate_measurements_for_factor_graph`` synthesises noisy
odometry and landmark measurements for a graph of ground-truth poses.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..core.variables import Variable
from ..factors.factors import Factor, UnknownVariableError


def read_variable_and_truth_from_line(line: str) -> Tuple[Variable,
                                                          np.ndarray]:
    var = Variable.construct_from_text(line)
    tok = line.strip().split()
    truth = np.array([float(tok[4 + i]) for i in range(var.dim)]) \
        if len(tok) >= 4 + var.dim else None
    return var, truth


def write_variable_and_truth_to_line(var: Variable,
                                     truth: np.ndarray = None) -> str:
    line = str(var)
    if truth is not None:
        line += " " + " ".join(str(v) for v in np.asarray(truth).reshape(-1))
    return line


def factor_graph_to_string(variables: Iterable[Variable],
                           factors: Iterable[Factor],
                           var_truth: Dict[Variable, np.ndarray] = None
                           ) -> str:
    var_truth = var_truth or {}
    lines = [write_variable_and_truth_to_line(v, var_truth.get(v))
             for v in variables]
    lines += [str(f) for f in factors]
    return "\n".join(lines)


def write_factor_graph_to_file(variables, factors, var_truth,
                               file_name: str) -> None:
    with open(file_name, "w") as f:
        f.write(factor_graph_to_string(variables, factors, var_truth))
        f.write("\n")


def read_factor_graph_from_file(file_name: str) -> Tuple[
        List[Variable], Dict[Variable, np.ndarray], List[Factor]]:
    variables: List[Variable] = []
    truth: Dict[Variable, np.ndarray] = {}
    factors: List[Factor] = []
    with open(file_name) as f:
        for line_no, line in enumerate(f, start=1):
            tok = line.strip().split()
            if not tok:
                continue
            # unknown leading tokens are skipped (comment convention)
            try:
                if tok[0] == "Variable":
                    var, val = read_variable_and_truth_from_line(line)
                    variables.append(var)
                    if val is not None:
                        truth[var] = val
                elif tok[0] == "Factor":
                    factors.append(Factor.construct_from_text(line,
                                                              variables))
            except UnknownVariableError as e:
                raise ValueError(
                    f"{file_name}:{line_no}: factor references unknown "
                    f"variable {e} (declare Variables before Factors): "
                    f"{line.strip()!r}") from e
            except (KeyError, ValueError, IndexError) as e:
                raise ValueError(
                    f"{file_name}:{line_no}: malformed line "
                    f"{line.strip()!r}: {e}") from e
    return variables, truth, factors


def generate_measurements_for_factor_graph(
        input_file_name: str, odometry_class, landmark_measurement_class,
        landmark_measurement_range: float, output_file_name: str = None,
        max_measurements_allowed: int = 1, seed: int = 0, **kwargs):
    """Synthesise noisy odometry between consecutive poses, and landmark
    measurements from each pose to its nearest landmarks within
    ``landmark_measurement_range`` (at most ``max_measurements_allowed``),
    for a graph whose file has ground-truth poses; returns (variables,
    truth, factors) and writes them to ``output_file_name`` if given.

    ``odometry_class`` is ``R2RelativeGaussianLikelihoodFactor`` or
    ``SE2RelativeGaussianLikelihoodFactor``; ``landmark_measurement_class``
    one of those R^2 odometry, R^2 range or SE(2)-R^2 range classes.
    Noise: ``odometry_covariance`` or ``odometry_sigma`` (with
    ``orientation_sigma``), ``landmark_covariance`` or ``landmark_sigma``.
    Each measurement is drawn on the CPU from the next key of a
    ``KeyStream(seed)``."""
    from ..core.variables import VariableType
    from ..factors.factors import (R2RangeGaussianLikelihoodFactor,
                                   R2RelativeGaussianLikelihoodFactor,
                                   SE2R2RangeGaussianLikelihoodFactor,
                                   SE2RelativeGaussianLikelihoodFactor)
    from ..utils.keys import KeyStream

    keys = KeyStream(seed)

    def odom_cov(dim):
        if "odometry_covariance" in kwargs:
            return np.asarray(kwargs["odometry_covariance"])
        cov = np.eye(dim) * kwargs["odometry_sigma"] ** 2
        if dim == 3:
            cov[2, 2] = kwargs["orientation_sigma"] ** 2
        return cov

    def make_odom(v1, v2, obs=None):
        if odometry_class is R2RelativeGaussianLikelihoodFactor:
            o = np.zeros(2) if obs is None else obs
            return R2RelativeGaussianLikelihoodFactor(
                v1, v2, o, covariance=odom_cov(2))
        if odometry_class is SE2RelativeGaussianLikelihoodFactor:
            o = np.zeros(3) if obs is None else obs
            return SE2RelativeGaussianLikelihoodFactor(
                v1, v2, o, covariance=odom_cov(3))
        raise ValueError("Unsupported odometry class")

    def make_lmk(pose, lmk, obs=None):
        if landmark_measurement_class is R2RelativeGaussianLikelihoodFactor:
            cov = np.asarray(kwargs.get(
                "landmark_covariance",
                np.eye(2) * kwargs["landmark_sigma"] ** 2))
            o = np.zeros(2) if obs is None else obs
            return R2RelativeGaussianLikelihoodFactor(pose, lmk, o,
                                                      covariance=cov)
        klass = landmark_measurement_class
        if klass in (R2RangeGaussianLikelihoodFactor,
                     SE2R2RangeGaussianLikelihoodFactor):
            o = 0.0 if obs is None else float(np.asarray(obs).reshape(-1)[0])
            return klass(pose, lmk, o, sigma=kwargs["landmark_sigma"])
        raise ValueError("Unsupported landmark measurement class")

    def draw(proto, a, b):
        return proto.sample(
            keys(), var1=torch.as_tensor(truth[a].reshape(1, -1),
                                         dtype=torch.float32),
            var2=torch.as_tensor(truth[b].reshape(1, -1),
                                 dtype=torch.float32)).numpy().reshape(-1)

    variables, truth, factors = read_factor_graph_from_file(input_file_name)
    poses = [v for v in variables if v.type == VariableType.Pose]
    landmarks = [v for v in variables
                 if v.type == VariableType.Landmark]

    for v1, v2 in zip(poses, poses[1:]):
        factors.append(make_odom(v1, v2, draw(make_odom(v1, v2), v1, v2)))

    for pose in poses:
        td = pose.translational_dim
        loc = truth[pose][:td]
        dists = {l: float(np.linalg.norm(loc - truth[l][:td]))
                 for l in landmarks}
        detected = [l for l in landmarks
                    if dists[l] <= landmark_measurement_range]
        for lmk in sorted(detected, key=lambda l: dists[l])[
                :max_measurements_allowed]:
            factors.append(make_lmk(pose, lmk,
                                    draw(make_lmk(pose, lmk), pose, lmk)))

    if output_file_name:
        write_factor_graph_to_file(variables, factors, truth,
                                   output_file_name)
    return variables, truth, factors
