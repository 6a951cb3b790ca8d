"""Host-side factor graph with symbolic elimination to a Bayes tree.

The port's counterpart of ``nfisam_tpu/graph/factor_graph.py``: symbolic
elimination with fill-in, Bayes-tree construction and subgraph
extraction.  The graph never touches device memory; it only decides which
cliques are simulated, trained and sampled.  Orderings: ``natural``,
``pose_first`` and ``ccolamd`` (constrained minimum degree,
``ordering.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..core.variables import Variable, VariableType
from ..factors.factors import Factor, ImplicitPriorFactor, UndefinedFactor
from .bayes_tree import BayesTree, CliqueNode
from .ordering import constrained_min_degree_ordering


class FactorGraph:
    def __init__(self) -> None:
        self._vars: List[Variable] = []
        self._factors: List[Factor] = []
        self._var_neighbors: Dict[Variable, Set[Variable]] = {}
        self._bayes_net_parents: Dict[Variable, Set[Variable]] = {}

    # ------------------------------------------------------------ building
    @property
    def vars(self) -> List[Variable]:
        return self._vars

    @property
    def factors(self) -> List[Factor]:
        return self._factors

    def add_node(self, var: Variable) -> "FactorGraph":
        if var in self._var_neighbors:
            raise KeyError(f"{var} already in graph")
        self._vars.append(var)
        self._var_neighbors[var] = set()
        return self

    def add_factor(self, factor: Factor) -> "FactorGraph":
        self._factors.append(factor)
        fvars = factor.vars
        for i, v1 in enumerate(fvars):
            for v2 in fvars[i + 1:]:
                if v1 != v2:
                    self._var_neighbors[v1].add(v2)
                    self._var_neighbors[v2].add(v1)
        return self

    def neighbors(self, var: Variable) -> Set[Variable]:
        return self._var_neighbors[var]

    def factors_of(self, var: Variable) -> Set[Factor]:
        """The factors on ``var`` (KeyError for a variable not in the
        graph), found by a scan: the graph keeps no index of them."""
        if var not in self._var_neighbors:
            raise KeyError(var)
        return {f for f in self._factors if var in f.vars}

    # -------------------------------------------------------- elimination
    def _symbolic_eliminate(self, var: Variable) -> None:
        """Remove ``var`` from the symbolic graph, fully connecting its
        neighbors (chordal fill-in via an UndefinedFactor clique edge) and
        recording them as the variable's Bayes-net parents
        (reference ``eliminate_from_factor_graph_for_analysis``
        FactorGraph.py:70)."""
        if var in self._bayes_net_parents:
            raise KeyError(f"{var} already eliminated")
        separator = set(self._var_neighbors[var])
        for nb in separator:
            self._var_neighbors[nb].discard(var)
        self._var_neighbors[var] = set()
        if separator:
            self.add_factor(UndefinedFactor(list(separator)))
        self._bayes_net_parents[var] = separator

    def eliminate_to_bayes_net(self, ordering: List[Variable]
                               ) -> "FactorGraph":
        for var in ordering:
            self._symbolic_eliminate(var)
        return self

    def bayes_net_parents(self, var: Variable) -> Set[Variable]:
        return self._bayes_net_parents[var]

    def analyze_elimination_ordering(
            self, method: str = "pose_first",
            last_vars: Optional[List[Variable]] = None) -> List[Variable]:
        """Elimination ordering by ``method`` (reference
        ``analyze_elimination_ordering`` FactorGraph.py:106).  ``ccolamd``
        eliminates ``last_vars`` last: by default the newest pose."""
        if method == "natural":
            return sorted(self._vars)
        if method == "pose_first":
            return pose_first_ordering(self._vars)
        if method == "ccolamd":
            if not last_vars:
                poses = [v for v in self._vars
                         if v.type == VariableType.Pose]
                last_vars = [poses[-1]] if poses else []
            return constrained_min_degree_ordering(
                self._vars, self._var_neighbors, last_vars)
        raise ValueError(f"Unknown ordering method {method}")

    def build_bayes_tree(self, ordering: List[Variable]) -> BayesTree:
        """Symbolically eliminate (on a scratch copy) and assemble the
        Bayes tree (reference ``get_bayes_tree`` FactorGraph.py:172)."""
        scratch = FactorGraph()
        scratch._vars = list(self._vars)
        scratch._var_neighbors = {v: set(nbs) for v, nbs
                                  in self._var_neighbors.items()}
        scratch.eliminate_to_bayes_net(ordering)

        tree = BayesTree(frontal=ordering[-1])
        tree.reverse_elimination_order = ordering[::-1]
        for frontal in ordering[-2::-1]:
            tree.insert_frontal(frontal,
                                scratch.bayes_net_parents(frontal))
        return tree

    # ----------------------------------------------------------- subgraphs
    def subgraph_with_separator_priors(
            self, variables: Set[Variable], subtrees: List[BayesTree],
            clique_priors: Dict[CliqueNode, ImplicitPriorFactor]
    ) -> "FactorGraph":
        """Working graph for an incremental step: the affected variables,
        their factors (except ones fully inside a detached subtree), plus
        cached separator-marginal priors of detached roots
        (reference ``get_sub_factor_graph_with_prior`` FactorGraph.py:204).
        """
        sub = FactorGraph()
        for v in self._vars:
            if v in variables:
                sub.add_node(v)
        for factor in self._factors:
            fvars = set(factor.vars)
            if not fvars.issubset(variables):
                continue
            if any(fvars.issubset(t.root.vars) for t in subtrees):
                continue
            sub.add_factor(factor)
        for subtree in subtrees:
            if not subtree.root.separator:
                # a separator-less detached root is a disconnected
                # component (e.g. a landmark added with only a unary
                # prior, not yet observed): nothing to condition on, its
                # kept clique model is the whole posterior of that
                # component
                continue
            sub.add_factor(clique_priors[subtree.root])
        return sub

    def without_clique(self, clique: CliqueNode,
                       new_factor: Optional[Factor]) -> "FactorGraph":
        """Eliminate a clique: drop its frontals and intra-clique factors,
        append the separator-marginal factor
        (reference ``eliminate_clique_variables`` FactorGraph.py:230)."""
        sub = FactorGraph()
        for v in self._vars:
            if v not in clique.frontal:
                sub.add_node(v)
        for factor in self._factors:
            if not set(factor.vars).issubset(clique.vars):
                sub.add_factor(factor)
        if new_factor is not None:
            sub.add_factor(new_factor)
        return sub

    def clique_subgraph(self, clique: CliqueNode) -> "FactorGraph":
        """Factors fully inside a clique (reference
        ``get_clique_factor_graph`` FactorGraph.py:249)."""
        sub = FactorGraph()
        for v in self._vars:
            if v in clique.vars:
                sub.add_node(v)
        for factor in self._factors:
            if set(factor.vars).issubset(clique.vars):
                sub.add_factor(factor)
        return sub


def pose_first_ordering(nodes: List[Variable]) -> List[Variable]:
    """Eliminate poses before landmarks, preserving insertion order within
    each group (reference ``generate_pose_first_ordering``
    FactorGraph.py:265)."""
    poses = [v for v in nodes if v.type != VariableType.Landmark]
    lmks = [v for v in nodes if v.type == VariableType.Landmark]
    return poses + lmks
