from .nfisam import (FlowModelAdapter, FlowsPriorFactor, NFiSAM, NFiSAMArgs,
                     effective_hidden_dim)
from .solver import (CliqueSeparatorFactor, ConditionalSampler,
                     FactorGraphSolver, SolverArgs)
from .posterior_pass import LazySamples, fused_sample_posterior
from .banked_joint import FactorBanks, IncrementalGaussNewtonMAP
from .map_solver import GaussNewtonMAP
from .run import (NFiSAM_empirial_study, nfisam_empirical_study,
                  run_incrementally)
