"""Adam iterations a window step runs, summed over the cliques it trained
(each clique's iteration count as the solver records it; untraced
steps)."""


def read(run):
    work = run["work"]
    if not work:
        return None
    return sum(it for w in work for _, it in w["trained"]) / len(work)
