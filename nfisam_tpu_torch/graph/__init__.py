from .bayes_tree import BayesTree, CliqueNode
from .factor_graph import FactorGraph, pose_first_ordering
