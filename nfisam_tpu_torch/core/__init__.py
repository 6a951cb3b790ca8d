from . import geometry
from .variables import (Variable, VariableType, R1Variable, R2Variable,
                        SE2Variable, circular_dim_list)
