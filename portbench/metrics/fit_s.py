"""Mean seconds a window step spends in ``fit_tree_density_models``:
simulation and training of the cliques the step changed (the harness's
``fit`` span, host clock, ended by a synchronize; untraced steps)."""


def read(run):
    rows = [r["fit"] for r in run["rows"]]
    return sum(rows) / len(rows) if rows else None
