"""Bayes tree (clique tree) with incremental-update machinery.

The port's own copy of ``nfisam_tpu/graph/bayes_tree.py`` (host-side
symbolic layer): clique graphs are tiny, and all numeric work hangs off
cliques via dictionaries keyed by ``CliqueNode`` in the solver.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Set, Tuple

from ..core.variables import Variable


class CliqueNode:
    """One clique: frontal (eliminated-here) and separator variables."""

    __slots__ = ("frontal", "separator", "parent", "children")

    def __init__(self, frontal, separator: Optional[Set[Variable]] = None,
                 parent: Optional["CliqueNode"] = None,
                 children: Optional[Set["CliqueNode"]] = None) -> None:
        if isinstance(frontal, Variable):
            self.frontal: Set[Variable] = {frontal}
        else:
            self.frontal = set(frontal)
        self.separator: Set[Variable] = set(separator) if separator else set()
        self.parent = parent
        self.children: Set[CliqueNode] = set(children) if children else set()

    # ------------------------------------------------------------ topology
    def attach_child(self, child: "CliqueNode") -> "CliqueNode":
        self.children.add(child)
        child.parent = self
        return self

    def detach_child(self, child: "CliqueNode") -> "CliqueNode":
        self.children.remove(child)
        child.parent = None
        return self

    @property
    def is_leaf(self) -> bool:
        return not self.children

    @property
    def is_root(self) -> bool:
        return self.parent is None

    # ------------------------------------------------------------- content
    @property
    def vars(self) -> Set[Variable]:
        return self.frontal | self.separator

    @property
    def num_vars(self) -> int:
        return len(self.frontal) + len(self.separator)

    @property
    def dim(self) -> int:
        return sum(v.dim for v in self.vars)

    @property
    def frontal_dim(self) -> int:
        return sum(v.dim for v in self.frontal)

    @property
    def separator_dim(self) -> int:
        return sum(v.dim for v in self.separator)

    def shallow_copy(self) -> "CliqueNode":
        return CliqueNode(frontal=set(self.frontal),
                          separator=set(self.separator))

    def deep_copy(self) -> "CliqueNode":
        """Copy this clique and its whole subtree (parent left None).

        Iterative: pose_first trees of long trajectories are CHAINS with
        depth == clique count, and the recursive form blew Python's
        stack at ~1000 poses (found by the 1024-pose scale run)."""
        root_copy = self.shallow_copy()
        stack = [(self, root_copy)]
        while stack:
            src, dst = stack.pop()
            for child in src.children:
                child_copy = child.shallow_copy()
                dst.attach_child(child_copy)
                stack.append((child, child_copy))
        return root_copy

    # ------------------------------------------------------------ identity
    def __eq__(self, other) -> bool:
        return (isinstance(other, CliqueNode) and
                self.frontal == other.frontal and
                self.separator == other.separator)

    def __hash__(self) -> int:
        return hash((frozenset(v.name for v in self.frontal),
                     frozenset(v.name for v in self.separator)))

    def __repr__(self) -> str:
        f = ",".join(sorted(str(v.name) for v in self.frontal))
        s = ",".join(sorted(str(v.name) for v in self.separator))
        return f"Clique(f=[{f}] s=[{s}])"


class BayesTree:
    """Clique tree built from a variable elimination ordering."""

    def __init__(self, root: Optional[CliqueNode] = None,
                 frontal: Optional[Variable] = None) -> None:
        if root is not None:
            self.root = root
            for child in root.children:
                child.parent = root
        elif frontal is not None:
            self.root = CliqueNode(frontal=frontal)
        else:
            raise ValueError("Need a root clique or a root frontal variable")
        # latest-eliminated first; used for in-clique column ordering
        self.reverse_elimination_order: Optional[List[Variable]] = None

    # ----------------------------------------------------------- traversal
    @property
    def clique_nodes(self) -> Set[CliqueNode]:
        out, stack = set(), [self.root]
        while stack:
            c = stack.pop()
            out.add(c)
            stack.extend(c.children)
        return out

    @property
    def leaves(self) -> Set[CliqueNode]:
        return {c for c in self.clique_nodes if c.is_leaf}

    @property
    def frontal_vars(self) -> Set[Variable]:
        return set().union(*[c.frontal for c in self.clique_nodes])

    def clique_ordering(self) -> List[CliqueNode]:
        """BFS root-first; callers pop() for leaves-first training
        (reference ``clique_ordering`` BayesTree.py:375).

        Children are visited in canonical (sorted-name) order:
        ``children`` is a set hashed on variable NAMES, so raw iteration
        order varies with PYTHONHASHSEED — a solve must assign the same
        RNG keys to the same cliques in every process for the multi-host
        scheduler (parallel/multihost.py) to be replicated-deterministic.
        """
        order, queue = [], [self.root]
        while queue:
            c = queue.pop(0)
            order.append(c)
            queue.extend(sorted(c.children, key=str))
        return order

    # -------------------------------------------------------- construction
    def insert_frontal(self, frontal: Variable,
                       parents: Set[Variable]) -> "BayesTree":
        """Place a frontal whose Bayes-net parents are ``parents``: merged
        into a clique whose vars equal the parents, else a new child of any
        clique containing them (reference ``add_node`` BayesTree.py:215).

        Candidates are scanned in canonical BFS order: several cliques may
        contain the parents, and the attachment choice fixes the tree
        SHAPE — set iteration here made tree structure (and thus wave
        widths, compiled shapes, and RNG assignment) vary with
        PYTHONHASHSEED across processes."""
        for clique in self.clique_ordering():
            if parents.issubset(clique.vars):
                if len(parents) == clique.num_vars:
                    clique.frontal.add(frontal)
                else:
                    clique.attach_child(CliqueNode(frontal=frontal,
                                                   separator=parents))
                break
        return self

    def copy(self) -> "BayesTree":
        new = BayesTree(root=self.root.deep_copy())
        if self.reverse_elimination_order is not None:
            new.reverse_elimination_order = \
                list(self.reverse_elimination_order)
        return new

    # ---------------------------------------------------------- increments
    def graft_subtree(self, subtree: "BayesTree") -> "BayesTree":
        """Re-attach a detached subtree where its root separator fits
        (reference ``append_child_bayes_tree`` BayesTree.py:292).
        Canonical BFS scan for the same determinism reasons as
        ``insert_frontal``."""
        for attach_point in self.clique_ordering():
            if subtree.root.separator.issubset(attach_point.vars):
                attach_point.attach_child(subtree.root)
                break
        return self

    def graft_subtrees(self, subtrees: Iterable["BayesTree"]) -> "BayesTree":
        for sub in subtrees:
            self.graft_subtree(sub)
        return self

    def prune_affected(self, touched: Set[Variable],
                       deep: Set[Variable] = frozenset()
                       ) -> Tuple[Set[Variable], Set["BayesTree"]]:
        """Variables whose cliques must be re-eliminated, plus the detached
        unaffected subtrees.

        A clique is affected if one of its frontals is touched, or if any
        descendant is affected (ancestors up to the root are always
        affected).  Matches reference
        ``get_affected_vars_and_partial_bayes_trees`` (BayesTree.py:310).

        ``deep`` variables (mode repair) also affect every clique that
        merely contains them, separator appearances in descendants
        included: a flow conditioned on a landmark committed to a wrong
        mode was trained on simulations from the wrong region, so once the
        landmark's own clique re-commits, those descendants retrain too.
        """
        var_to_clique = {}
        for clique in self.clique_nodes:
            for v in clique.frontal:
                var_to_clique[v] = clique

        affected: Set[CliqueNode] = set()
        for v in touched & self.frontal_vars:
            node = var_to_clique[v]
            while node is not None and node not in affected:
                affected.add(node)
                node = node.parent
        if deep:
            for clique in self.clique_nodes:
                if deep & clique.vars:
                    node = clique
                    while node is not None and node not in affected:
                        affected.add(node)
                        node = node.parent

        detached: Set[BayesTree] = set()
        stack = [self.root]
        while stack:
            clique = stack.pop()
            for child in clique.children:
                if child in affected:
                    stack.append(child)
                else:
                    sub_root = child.deep_copy()
                    detached.add(BayesTree(root=sub_root))
        if not affected:
            affected = {self.root}
        affected_vars = set().union(*[c.frontal for c in affected])
        return affected_vars, detached

    # ------------------------------------------------------------ patterns
    def clique_variable_pattern(self, clique: CliqueNode) -> List[Variable]:
        """[separator..., frontal...], each sorted by reverse elimination
        order (latest-eliminated first) — the flow column convention
        (reference ``clique_variable_pattern`` BayesTree.py:358)."""
        assert self.reverse_elimination_order is not None
        rank = {v: i for i, v in enumerate(self.reverse_elimination_order)}
        sep = sorted(clique.separator, key=lambda v: rank[v])
        frontal = sorted(clique.frontal, key=lambda v: rank[v])
        return sep + frontal

    def __repr__(self) -> str:
        parts = []
        for c in self.clique_ordering():
            parts.append(repr(c))
        return "BayesTree{" + "; ".join(parts) + "}"
