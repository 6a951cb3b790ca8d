from .factors import (FACTOR_REGISTRY, BinaryFactor, Factor,
                      ImplicitPriorFactor, LikelihoodFactor, PriorFactor,
                      SE2R2RangeGaussianLikelihoodFactor,
                      SE2RelativeGaussianLikelihoodFactor, UnaryFactor,
                      UndefinedFactor, UnaryR2GaussianPriorFactor,
                      UnarySE2ApproximateGaussianPriorFactor,
                      register_factor)
from .utils import classify_factors, unpack_prior_binary_nh_da_factors
