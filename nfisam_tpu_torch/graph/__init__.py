from .bayes_tree import BayesTree, CliqueNode
from .factor_graph import FactorGraph, pose_first_ordering
from .ordering import (constrained_min_degree_indices,
                       constrained_min_degree_ordering)
