"""Factor classification helpers."""
from __future__ import annotations

from typing import List, Tuple

from .factors import BinaryFactor, PriorFactor
from .mixtures import AmbiguousDataAssociationFactor, BinaryFactorWithNullHypo


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


def unpack_prior_binary_nh_da_factors(factors: List) -> Tuple[List, List,
                                                              List, List]:
    """Split into (priors, plain binary, null-hypothesis, data-association)
    groups, which drive the clique simulation schedule.  The ranking puts
    the null-hypothesis and data-association mixtures before plain binary
    factors (a null-hypothesis factor is a binary factor too)."""
    priors, null_hypo, da, binary = classify_factors(
        factors, [PriorFactor, BinaryFactorWithNullHypo,
                  AmbiguousDataAssociationFactor, BinaryFactor])
    return priors, binary, null_hypo, da
