"""Stream-level measurement policies for incremental solves.

Counterpart of ``nfisam_tpu/io/stream_policy.py``.  ``defer_ambiguous``
(delayed hypothesis commitment) holds each k-way ambiguous mixture factor
out of the stream until every candidate landmark has ``min_plain``
committed unambiguous factors, for at most ``max_steps`` steps: a solver
that commits as it goes resolves a mixture with whatever beliefs exist on
arrival, and deferring it until its candidates are localized weights the
hypotheses against localized landmarks.  It reorders the factor stream
as a front end could and changes nothing in the solver.
"""
from typing import List, Tuple

from ..factors.mixtures import BinaryFactorMixture

__all__ = ["defer_ambiguous"]


def defer_ambiguous(batches: List[Tuple[list, list]], max_steps: int = 6,
                    min_plain: int = 2) -> List[Tuple[list, list]]:
    """Reorder an incremental batch stream so ambiguous mixture factors
    arrive only after their candidate landmarks are localized.

    ``batches`` is [(new_nodes, new_factors), ...] as
    ``group_nodes_factors_incrementally`` makes it.  Returns a new list
    with the same nodes and the same factors; only the arrival step of a
    k-way mixture (a ``BinaryFactorMixture`` over more than 2 variables)
    changes, by at most ``max_steps``; whatever is still held at the end
    arrives with the last step.
    """
    plain_count: dict = {}
    deferred: list = []     # (release_step, factor, candidate landmarks)
    out: List[Tuple[list, list]] = []
    for i, (ns, fs) in enumerate(batches):
        keep, held = [], []
        for f in fs:
            if isinstance(f, BinaryFactorMixture) and len(f.vars) > 2:
                held.append(f)
            else:
                keep.append(f)
                for v in f.vars:
                    if str(v.name).startswith("L"):
                        plain_count[v] = plain_count.get(v, 0) + 1
        release, still = [], []
        for (rel, f, lmks) in deferred:
            if i >= rel or all(plain_count.get(v, 0) >= min_plain
                               for v in lmks):
                release.append(f)
            else:
                still.append((rel, f, lmks))
        deferred = still
        for f in held:
            lmks = list(f.vars[1:])
            if all(plain_count.get(v, 0) >= min_plain for v in lmks):
                release.append(f)
            else:
                deferred.append((i + max_steps, f, lmks))
        out.append((ns, keep + release))
    if deferred:
        out[-1] = (out[-1][0], out[-1][1] + [f for _, f, _ in deferred])
    return out
