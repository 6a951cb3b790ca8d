"""Reader for the text ``.fg`` factor-graph format.

Lines are ``Variable <Type> <Space> <name> <truth...>`` and
``Factor <ClassName> ...``, the grammar of ``nfisam_tpu/io/fg_io.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.variables import Variable
from ..factors.factors import Factor, UnknownVariableError


def read_variable_and_truth_from_line(line: str) -> Tuple[Variable,
                                                          np.ndarray]:
    var = Variable.construct_from_text(line)
    tok = line.strip().split()
    truth = np.array([float(tok[4 + i]) for i in range(var.dim)]) \
        if len(tok) >= 4 + var.dim else None
    return var, truth


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
