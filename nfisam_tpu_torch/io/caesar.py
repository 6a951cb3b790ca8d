"""Caesar.jl (mm-iSAM) comparison bridge: a Julia script from a graph.

Counterpart of ``nfisam_tpu/io/caesar.py``.  It walks the parsed factor
objects and emits a Julia script that replays the incremental batches
through Caesar.jl / IncrementalInference.jl, so mm-iSAM can run as a
comparison solver on the same problems (the reference translates ``.fg``
files in ``src/external/caesar/fg2caesar.jl``).  The script is the
artifact; no Julia runs here.  The port's script equals the JAX
package's byte for byte.

Mapping (fg2caesar.jl:265-300):

==============================================  =========================
this package                                    Caesar.jl
==============================================  =========================
``SE2Variable`` (Pose)                          ``Pose2``
``R2Variable`` (Landmark)                       ``Point2``
``UnarySE2ApproximateGaussianPriorFactor``      ``PriorPose2(MvNormal)``
``SE2RelativeGaussianLikelihoodFactor``         ``Pose2Pose2(MvNormal)``
``SE2R2RangeGaussianLikelihoodFactor``          ``Pose2Point2Range``
``AmbiguousDataAssociationFactor``              component factor with
                                                ``multihypo=[1; w...]``
==============================================  =========================
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.variables import Variable, VariableType
from ..factors.factors import (Factor, SE2R2RangeGaussianLikelihoodFactor,
                               SE2RelativeGaussianLikelihoodFactor,
                               UnarySE2ApproximateGaussianPriorFactor)
from ..factors.mixtures import AmbiguousDataAssociationFactor

_HEADER = """\
# Auto-generated by nfisam_tpu.io.caesar (fg2caesar bridge).
# Requires: Caesar.jl / IncrementalInference.jl / RoME.jl
using RoME, IncrementalInference, Distributions
using DelimitedFiles

fg = initfg()
"""


def _jvec(a) -> str:
    return "[" + "; ".join(f"{float(x):.12g}" for x in np.ravel(a)) + "]"


def _jmat(a) -> str:
    a = np.asarray(a, dtype=np.float64)
    return "[" + "; ".join(" ".join(f"{v:.12g}" for v in row)
                           for row in a) + "]"


def _range(f) -> str:
    return (f"Pose2Point2Range(Normal({float(f.obs[0]):.12g}, "
            f"{float(f.sigma):.12g}))")


def _pose2pose2(f) -> str:
    return f"Pose2Pose2(MvNormal({_jvec(f.observation)}, " \
        f"{_jmat(f.covariance)}))"


def _variable_line(v: Variable) -> str:
    kind = "Point2" if v.type == VariableType.Landmark else "Pose2"
    return f"addVariable!(fg, :{v.name}, {kind})"


def _factor_lines(f: Factor) -> List[str]:
    if isinstance(f, UnarySE2ApproximateGaussianPriorFactor):
        return [f"addFactor!(fg, [:{f.var.name}], PriorPose2(MvNormal("
                f"{_jvec(f.observation)}, {_jmat(f.covariance)})))"]
    if isinstance(f, SE2RelativeGaussianLikelihoodFactor):
        return [f"addFactor!(fg, [:{f.var1.name}, :{f.var2.name}], "
                f"{_pose2pose2(f)})"]
    if isinstance(f, SE2R2RangeGaussianLikelihoodFactor):
        return [f"addFactor!(fg, [:{f.var1.name}, :{f.var2.name}], "
                f"{_range(f)})"]
    if isinstance(f, AmbiguousDataAssociationFactor):
        # fg2caesar.jl:291-300: the observer is certain (weight 1), the
        # observed variables share the hypothesis weights
        syms = ", ".join(f":{v.name}" for v in f.vars)
        hypos = _jvec([1.0] + [float(w) for w in f.weights])
        comp = f.components[0]
        if isinstance(comp, SE2R2RangeGaussianLikelihoodFactor):
            inner = _range(comp)
        elif isinstance(comp, SE2RelativeGaussianLikelihoodFactor):
            inner = _pose2pose2(comp)
        else:
            raise NotImplementedError(
                f"No Caesar mapping for ADA component {type(comp).__name__}")
        return [f"addFactor!(fg, [{syms}], {inner}, multihypo={hypos})"]
    raise NotImplementedError(
        f"No Caesar mapping for factor type {type(f).__name__}")


def export_caesar_script(
        nodes_factors_by_step: Sequence[Tuple[List[Variable], List[Factor]]],
        output_dir: str = "caesar_out",
        posterior_sample_num: int = 1000,
        truth: Optional[Dict[Variable, np.ndarray]] = None) -> str:
    """A Julia script that replays the incremental batches through
    Caesar.jl: each step adds its variables and factors, runs
    ``solveTree!`` and writes every variable's posterior points to
    ``output_dir/step{i}`` (the reference's ``caesar{N}/step{i}``
    convention, fg2caesar.jl:320-380)."""
    lines = [_HEADER, f'output_dir = "{output_dir}"', "mkpath(output_dir)",
             f"getSolverParams(fg).N = {int(posterior_sample_num)}"]
    for i, (step_nodes, step_factors) in enumerate(nodes_factors_by_step):
        lines.append(f"\n# ---- incremental step {i} ----")
        lines += [_variable_line(v) for v in step_nodes]
        for f in step_factors:
            lines += _factor_lines(f)
        lines.append("tree = solveTree!(fg)")
        lines.append(f'open(joinpath(output_dir, "step{i}"), "w") do io')
        lines += [f"    writedlm(io, getPoints(getBelief(fg, :{v.name}))')"
                  for s in nodes_factors_by_step[:i + 1] for v in s[0]]
        lines.append("end")
    if truth:
        lines.append("\n# ground truth for reference")
        lines += [f"# truth {v.name}: {_jvec(p)}" for v, p in truth.items()]
    return "\n".join(lines) + "\n"


def write_caesar_script(path: str, nodes_factors_by_step,
                        **kwargs) -> str:
    """``export_caesar_script`` written to ``path``; returns ``path``."""
    with open(path, "w") as fh:
        fh.write(export_caesar_script(nodes_factors_by_step, **kwargs))
    return path
