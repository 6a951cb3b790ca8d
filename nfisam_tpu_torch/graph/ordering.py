"""Fill-reducing elimination orderings: constrained minimum degree.

The port's copy of ``nfisam_tpu/graph/ordering.py``'s pure-Python path
(``_min_degree_python``).  The JAX package also loads a C++ build of the
same algorithm from ``native/`` when it exists, whose output is identical
(``native/ordering.cc``); the port loads nothing from ``native/``.

The constraint mirrors CCOLAMD's ``cmember``: variables of the last
constraint group are eliminated after all the others (the newest pose
stays at the Bayes-tree root).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..core.variables import Variable


def constrained_min_degree_indices(n: int, adj: List[Set[int]],
                                   cmember: np.ndarray) -> List[int]:
    """Constrained minimum degree on the variable graph: within each
    constraint group (ascending), repeatedly eliminate the vertex of least
    degree among those not yet eliminated (ties to the lowest index),
    joining its remaining neighbours into a clique."""
    adj = [set(a) for a in adj]
    remaining = set(range(n))
    order: List[int] = []
    for group in sorted(set(int(c) for c in cmember)):
        members = {i for i in remaining if cmember[i] == group}
        while members:
            v = min(members, key=lambda i: (len(adj[i] & remaining), i))
            nbrs = adj[v] & remaining
            for a in nbrs:
                adj[a] |= nbrs - {a}
                adj[a].discard(v)
            order.append(v)
            remaining.discard(v)
            members.discard(v)
    return order


def constrained_min_degree_ordering(
        variables: Sequence[Variable],
        var_neighbors: Dict[Variable, Set[Variable]],
        last_vars: Optional[Sequence[Variable]] = None) -> List[Variable]:
    """Order ``variables`` for elimination with ``last_vars`` forced last
    (the reference's ``analyze_elimination_ordering`` with a cmember)."""
    n = len(variables)
    index = {v: i for i, v in enumerate(variables)}
    adj: List[Set[int]] = [set() for _ in range(n)]
    for v, nbs in var_neighbors.items():
        if v not in index:
            continue
        for nb in nbs:
            if nb in index and nb != v:
                adj[index[v]].add(index[nb])
                adj[index[nb]].add(index[v])
    cmember = np.zeros(n, dtype=np.int32)
    for v in (last_vars or []):
        cmember[index[v]] = 1
    if cmember.all():
        cmember[:] = 0
    return [variables[i]
            for i in constrained_min_degree_indices(n, adj, cmember)]
