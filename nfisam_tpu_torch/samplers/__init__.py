from .simulation import (SimulationBasedSampler, SimulationSchedule,
                         compile_schedule, execute_schedule)
from .joint import JointFactor, StructuredJointFactor
from .nested import (GlobalNestedSampler, NestedConfig, dynamic_nested_sample,
                     nested_sample)
from .nuts import GlobalMCMCSampler, NUTSConfig, nuts_sample
from .smc import GlobalSMCSampler, SMCConfig, smc_sample
from .run_batch import (dynesty_run_batch, nested_run_batch, nuts_run_batch,
                        sampler_run_batch, smc_run_batch)
