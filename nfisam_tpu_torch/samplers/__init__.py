from .simulation import (SimulationBasedSampler, SimulationSchedule,
                         compile_schedule, execute_schedule)
from .joint import JointFactor, StructuredJointFactor
