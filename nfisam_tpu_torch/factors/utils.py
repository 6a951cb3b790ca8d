"""Factor classification helpers."""
from __future__ import annotations

from typing import List, Tuple

from .factors import BinaryFactor, PriorFactor


def classify_factors(factors: List, ranked_classes: List) -> List[List]:
    """Partition factors into the first matching class in
    ``ranked_classes``."""
    groups: List[List] = [[] for _ in ranked_classes]
    for factor in factors:
        for i, klass in enumerate(ranked_classes):
            if isinstance(factor, klass):
                groups[i].append(factor)
                break
        else:
            raise ValueError("Unknown factor class: " + str(factor))
    return groups


def unpack_prior_binary_nh_da_factors(factors: List) -> Tuple[List, List]:
    """Split into (priors, plain binary) groups, which drive the clique
    simulation schedule.  The null-hypothesis and data-association groups
    of the JAX package come with the mixture factors, which the port does
    not have yet."""
    priors, binary = classify_factors(factors, [PriorFactor, BinaryFactor])
    return priors, binary
