"""Typed factor-graph variables (host-side symbolic layer).

The port's own copy of ``nfisam_tpu/core/variables.py`` (numpy-free
metadata): hashable by name, consumed by the host-side graph layer, while
all numeric state lives in tensors keyed by these variables.
"""
from __future__ import annotations

from enum import Enum
from typing import Hashable, List, Sequence, Set


class VariableType(Enum):
    Pose = "Pose"
    Landmark = "Landmark"
    Measurement = "Measurement"


class Variable:
    """A uniquely named variable with manifold metadata.

    Identity (hash/eq) is by name only, matching the reference semantics so
    host-side graph surgery behaves identically.
    """

    __slots__ = ("_name", "_dim", "_type", "_rot_dims")

    def __init__(self, name: Hashable, dim: int,
                 variable_type: VariableType = VariableType.Pose,
                 rotational_dims: Set[int] | None = None) -> None:
        if dim <= 0:
            raise ValueError("Dimensionality must be positive")
        self._name = name
        self._dim = dim
        self._type = variable_type
        rot = set(rotational_dims) if rotational_dims else set()
        if rot and not (0 <= min(rot) <= max(rot) < dim):
            raise ValueError("rotational_dims is incorrect")
        self._rot_dims = rot

    # ------------------------------------------------------------------ meta
    @property
    def name(self) -> Hashable:
        return self._name

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def type(self) -> VariableType:
        return self._type

    @property
    def translational_dim(self) -> int:
        return self._dim - len(self._rot_dims)

    @property
    def rotational_dim(self) -> int:
        return len(self._rot_dims)

    @property
    def circular_dim_list(self) -> List[bool]:
        """Per-dim circular flags; convention: translation dims first."""
        return [i in self._rot_dims for i in range(self._dim)]

    @property
    def t_dim_indices(self) -> List[int]:
        return list(range(self.translational_dim))

    @property
    def R_dim_indices(self) -> List[int]:
        return list(range(self.translational_dim, self._dim))

    # ------------------------------------------------------------ identity
    def __hash__(self) -> int:
        return hash(self._name)

    def __eq__(self, other) -> bool:
        return isinstance(other, Variable) and self._name == other._name

    def __lt__(self, other: "Variable") -> bool:
        return self._name < other._name

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._name})"

    def __str__(self) -> str:
        return " ".join(["Variable", self._type.value,
                         type(self).__name__.replace("Variable", ""),
                         str(self._name)])

    # --------------------------------------------------------------- text io
    @classmethod
    def construct_from_text(cls, line: str) -> "Variable":
        """Parse ``Variable <Type> <Space> <name> ...`` lines (.fg format)."""
        tok = line.strip().split()
        if tok[0] != "Variable":
            raise ValueError("Not a variable line: " + line)
        space, vtype, name = tok[2], VariableType(tok[1]), tok[3]
        klass = _SPACE_TO_CLASS.get(space)
        if klass is None:
            raise ValueError(f"Unknown variable space {space}")
        return klass(name=name, variable_type=vtype)


class R2Variable(Variable):
    def __init__(self, name: Hashable,
                 variable_type: VariableType = VariableType.Pose) -> None:
        super().__init__(name, 2, variable_type, None)


class R1Variable(Variable):
    def __init__(self, name: Hashable,
                 variable_type: VariableType = VariableType.Pose) -> None:
        super().__init__(name, 1, variable_type, None)


class Bearing2DVariable(Variable):
    def __init__(self, name: Hashable,
                 variable_type: VariableType = VariableType.Pose) -> None:
        super().__init__(name, 1, variable_type, {0})


class SE2Variable(Variable):
    def __init__(self, name: Hashable,
                 variable_type: VariableType = VariableType.Pose) -> None:
        super().__init__(name, 3, variable_type, {2})


_SPACE_TO_CLASS = {
    "R2": R2Variable,
    "R1": R1Variable,
    "Bearing2D": Bearing2DVariable,
    "SE2": SE2Variable,
}


def circular_dim_list(variables: Sequence[Variable]) -> List[bool]:
    """Concatenate circular flags across an ordered variable list."""
    out: List[bool] = []
    for var in variables:
        out += var.circular_dim_list
    return out


def file2vars(order_file: str, pose_space: str = "SE2") -> List[Variable]:
    """Typed variables from a whitespace-separated ordering file: names
    starting with ``L`` are R2 landmarks, the others poses in
    ``pose_space`` ("SE2" or "R2"); ``#`` starts a comment."""
    pose_class = {"SE2": SE2Variable, "R2": R2Variable}.get(pose_space)
    if pose_class is None:
        raise ValueError(f"Unknown pose space {pose_space}")
    with open(order_file) as fh:
        names = [n for line in fh for n in line.split("#")[0].split()]
    return [R2Variable(name=n, variable_type=VariableType.Landmark)
            if n[0] == "L" else pose_class(name=n) for n in names]
