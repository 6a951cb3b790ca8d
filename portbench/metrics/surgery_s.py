"""Mean seconds a window step spends from ``add_node`` through
``update_physical_and_working_graphs`` (the harness's ``surgery`` span,
host clock, ended by a synchronize; untraced steps)."""


def read(run):
    rows = [r["surgery"] for r in run["rows"]]
    return sum(rows) / len(rows) if rows else None
