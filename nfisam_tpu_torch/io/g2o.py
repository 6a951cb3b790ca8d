"""g2o / TORO pose-graph readers.

Counterpart of ``nfisam_tpu/io/g2o.py``: ``VERTEX_SE2``/``EDGE_SE2``
(g2o, ``.g2o``) and ``VERTEX2``/``EDGE2`` (TORO, ``.graph``) lines, each
with its own order of the upper-triangular information matrix.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.variables import R2Variable, SE2Variable, Variable
from ..factors.factors import (R2RelativeGaussianLikelihoodFactor,
                               SE2RelativeGaussianLikelihoodFactor,
                               UnaryR2GaussianPriorFactor,
                               UnarySE2ApproximateGaussianPriorFactor)

_FORMATS = {
    "g2o": ("VERTEX_SE2", "EDGE_SE2",
            [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]),
    "graph": ("VERTEX2", "EDGE2",
              [(0, 0), (0, 1), (1, 1), (2, 2), (0, 2), (1, 2)]),
}


class G2oToroPoseGraphReader:
    def __init__(self, file_path: str, correlated_R_t: bool = True,
                 ignore_orientation: bool = False) -> None:
        self.file_path = file_path
        fmt = next((k for k in _FORMATS if file_path.endswith(k)), None)
        if fmt is None:
            raise ValueError("Unrecognized pose-graph suffix: " + file_path)
        self.file_type = fmt
        node_head, edge_head, info_order = _FORMATS[fmt]
        dim = 2 if ignore_orientation else 3
        var_cls = R2Variable if ignore_orientation else SE2Variable

        self.node_list: List[Variable] = []
        self.factor_list: List = []
        self.true_location_mapping: Dict[Variable, np.ndarray] = {}
        with open(file_path) as fp:
            for line in fp:
                tok = line.strip().split()
                if not tok:
                    continue
                if tok[0] == node_head:
                    var = var_cls(tok[1])
                    self.node_list.append(var)
                    self.true_location_mapping[var] = np.array(
                        [float(t) for t in tok[2:2 + dim]])
                elif tok[0] == edge_head:
                    info = np.zeros((3, 3))
                    for k, (i, j) in enumerate(info_order):
                        info[i, j] = info[j, i] = float(tok[6 + k])
                    cov = np.linalg.inv(info)
                    v1, v2 = var_cls(tok[1]), var_cls(tok[2])
                    if ignore_orientation:
                        self.factor_list.append(
                            R2RelativeGaussianLikelihoodFactor(
                                v1, v2,
                                np.array([float(tok[3]), float(tok[4])]),
                                covariance=cov[:2, :2]))
                    else:
                        self.factor_list.append(
                            SE2RelativeGaussianLikelihoodFactor(
                                v1, v2,
                                np.array([float(tok[3]), float(tok[4]),
                                          float(tok[5])]),
                                covariance=cov,
                                correlated_R_t=correlated_R_t))

    def data_for_solver(self, prior_cov_scale: float = 0.1):
        """(nodes, factors with a prior anchoring the first node at its
        truth, truth)."""
        var0 = self.node_list[0]
        truth0 = self.true_location_mapping[var0]
        if var0.dim == 2:
            prior = UnaryR2GaussianPriorFactor(
                var0, truth0, covariance=prior_cov_scale * np.eye(2))
        else:
            prior = UnarySE2ApproximateGaussianPriorFactor(
                var0, truth0, covariance=prior_cov_scale * np.eye(3))
        return self.node_list, [prior] + self.factor_list, \
            self.true_location_mapping

    # the reference's spelling
    dataForSolver = data_for_solver
