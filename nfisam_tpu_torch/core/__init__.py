from . import geometry
from .variables import (Variable, VariableType, Bearing2DVariable,
                        R1Variable, R2Variable, SE2Variable,
                        circular_dim_list)
