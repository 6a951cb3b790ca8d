from .ar_inverse import (ar_inverse_kernel, flow_inverse_masked_plain,
                         stack_inverse_masked_cuda,
                         stack_inverse_masked_plain)
from .base_dist import (BaseDistribution, normal_sample, von_mises_log_prob,
                        von_mises_sample)
from .model import (CliqueFlowModel, compute_normalizer,
                    conditional_draw_core, negative_log_likelihood,
                    normalize, unnormalize)
from .nsf import (NSFConfig, flow_forward, flow_inverse, flow_inverse_masked,
                  flow_params_from_numpy, init_flow_params, stack_forward,
                  stack_inverse, stack_inverse_masked)
from .rqs import unconstrained_rqs
