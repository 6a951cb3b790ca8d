"""Recorded streams: the ``.fg`` text parsed in plain Python, cut into the
steps a robot or a fleet feeds the solver, and written back as text.

This is the benchmark's own copy of the stream cutting: it imports nothing
of the program, so the judge (``reference.py``) and the harness agree on
what each step adds without asking the program.  The cut follows the
runners' grouping (``group_nodes_factors_incrementally`` with a robot's
poses named letter + index): a step adds ``poses_per_step`` poses in file
order; each pose brings its priors, its odometry, its ranges and its
ambiguous ranges (the factors it is the first variable of), and a landmark
arrives with the first range that sees it.  A fleet is ``robots`` copies of
one stream with every variable renamed ``R<r>_<name>``, so no factor spans
two robots; its step ``t`` is every robot's step ``t``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

STREAM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "streams")

PRIOR = "UnarySE2ApproximateGaussianPriorFactor"
ODOM = "SE2RelativeGaussianLikelihoodFactor"
RANGE = "SE2R2RangeGaussianLikelihoodFactor"
MIXTURE = "AmbiguousDataAssociationFactor"


@dataclass
class Var:
    name: str
    kind: str            # "Pose" (SE2, dim 3) or "Landmark" (R2, dim 2)
    dim: int
    truth: np.ndarray
    line: str


@dataclass
class Fac:
    kind: str            # PRIOR, ODOM, RANGE or MIXTURE
    vars: List[str]      # ODOM: (i, j); RANGE: (pose, landmark);
    #                      MIXTURE: (observer, candidates ...)
    obs: np.ndarray      # PRIOR / ODOM: (3,); RANGE / MIXTURE: (1,)
    cov: np.ndarray      # PRIOR / ODOM: (3, 3); RANGE / MIXTURE: sigma (1,)
    weights: np.ndarray = field(default_factory=lambda: np.ones(1))
    line: str = ""


@dataclass
class Stream:
    vars: Dict[str, Var]
    factors: List[Fac]


def _floats(tok) -> np.ndarray:
    return np.asarray([float(t) for t in tok], dtype=np.float64)


def parse_text(lines) -> Stream:
    """A ``.fg`` text (the grammar of ``io/fg_io.py``: ``Variable`` lines,
    then ``Factor`` lines), restricted to the four factor kinds of the
    recorded range-SLAM streams; anything else raises."""
    vars_: Dict[str, Var] = {}
    factors: List[Fac] = []
    for raw in lines:
        line = raw.strip()
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "Variable":
            kind, space, name = tok[1], tok[2], tok[3]
            dim = {"SE2": 3, "R2": 2}[space]
            vars_[name] = Var(name, kind, dim, _floats(tok[4:4 + dim]), line)
        elif tok[0] == "Factor":
            kind = tok[1]
            if kind in (PRIOR, ODOM):
                n = 1 if kind == PRIOR else 2
                names = tok[2:2 + n]
                obs = _floats(tok[2 + n:5 + n])
                if tok[5 + n] != "covariance":
                    raise ValueError(f"malformed factor: {line!r}")
                cov = _floats(tok[6 + n:15 + n]).reshape(3, 3)
                factors.append(Fac(kind, names, obs, cov, line=line))
            elif kind == RANGE:
                factors.append(Fac(kind, tok[2:4], _floats(tok[4:5]),
                                   _floats(tok[5:6]), line=line))
            elif kind == MIXTURE:
                i_obs, i_w = tok.index("Observed"), tok.index("Weights")
                i_bin = tok.index("Binary")
                if tok[i_bin + 1] != RANGE:
                    raise ValueError(f"unsupported mixture: {line!r}")
                names = [tok[tok.index("Observer") + 1]] + tok[i_obs + 1:i_w]
                factors.append(Fac(
                    kind, names,
                    _floats([tok[tok.index("Observation") + 1]]),
                    _floats([tok[tok.index("Sigma") + 1]]),
                    weights=_floats(tok[i_w + 1:i_bin]), line=line))
            else:
                raise ValueError(f"unsupported factor kind {kind!r}")
        for name in (factors[-1].vars if tok[0] == "Factor" else ()):
            if name not in vars_:
                raise ValueError(f"factor before its variable: {line!r}")
    return Stream(vars_, factors)


def load(name: str) -> Stream:
    """The frozen stream ``streams/<name>.fg``."""
    with open(os.path.join(STREAM_DIR, f"{name}.fg")) as fh:
        return parse_text(fh)


Step = Tuple[List[Var], List[Fac]]


def cut(stream: Stream, poses_per_step: int, max_steps: int) -> List[Step]:
    """The first ``max_steps`` steps of one robot's stream: each step adds
    ``poses_per_step`` poses in file order, every node before any factor.
    A pose owns the factors whose first variable it is (its prior, the
    odometry into it from an earlier pose, its ranges and ambiguous
    ranges), grouped by kind in the order each kind first appears among
    them, as the runners' grouping has it; a landmark joins with the first
    factor of its pose that names it, and brings its own priors."""
    poses = [v for v in stream.vars.values() if v.kind == "Pose"]
    owned: Dict[str, Dict[str, List[Fac]]] = {}
    for f in stream.factors:
        if f.kind == ODOM:
            # odometry belongs to its later pose, other pose-pose
            # factors to their first
            i, j = f.vars
            owner = j if _index(j) - _index(i) == 1 else i
            group = "odom" if owner == j else "pose_obsv"
        elif f.kind == PRIOR:
            owner, group = f.vars[0], "prior"
        else:
            owner, group = f.vars[0], "lmk_obsv"
        owned.setdefault(owner, {}).setdefault(group, []).append(f)
    steps: List[Step] = []
    seen_lmks = set()
    vs: List[Var] = []
    fs: List[Fac] = []
    for k, pose in enumerate(poses):
        vs.append(pose)
        groups = owned.get(pose.name, {})
        for group in groups.values():
            fs += group
        for f in groups.get("lmk_obsv", []):
            for name in f.vars[1:]:
                v = stream.vars[name]
                if v.kind == "Landmark" and name not in seen_lmks:
                    seen_lmks.add(name)
                    vs.append(v)
                    fs += owned.get(name, {}).get("prior", [])
        if (k + 1) % poses_per_step == 0 or k == len(poses) - 1:
            steps.append((vs, fs))
            vs, fs = [], []
            if len(steps) == max_steps:
                break
    return steps


def _index(name: str) -> int:
    digits = name[len(name.rstrip("0123456789")):]
    return int(digits) if digits else -1


def renamed(stream: Stream, prefix: str) -> Stream:
    """The stream with every variable renamed ``prefix + name``."""
    vars_ = {prefix + n: Var(prefix + n, v.kind, v.dim, v.truth,
                             _rename_line(v.line, stream.vars, prefix))
             for n, v in stream.vars.items()}
    factors = [Fac(f.kind, [prefix + n for n in f.vars], f.obs, f.cov,
                   f.weights, _rename_line(f.line, stream.vars, prefix))
               for f in stream.factors]
    return Stream(vars_, factors)


def _rename_line(line: str, names, prefix: str) -> str:
    return " ".join(prefix + t if t in names else t for t in line.split())


def fleet(stream: Stream, robots: int, poses_per_step: int,
          max_steps: int) -> List[Step]:
    """``robots`` renamed copies of ``stream`` (one robot: the stream as
    it is), step ``t`` holding every robot's step ``t`` in robot order."""
    if robots == 1:
        return cut(stream, poses_per_step, max_steps)
    per_robot = [cut(renamed(stream, f"R{r}_"), poses_per_step, max_steps)
                 for r in range(robots)]
    return [([v for steps in per_robot for v in steps[t][0]],
             [f for steps in per_robot for f in steps[t][1]])
            for t in range(min(len(s) for s in per_robot))]


def to_text(steps: List[Step]) -> str:
    """The steps as one ``.fg`` text: every variable line, then every
    factor line, in step order."""
    return "\n".join([v.line for vs, _ in steps for v in vs] +
                     [f.line for _, fs in steps for f in fs]) + "\n"
