"""Mean seconds a window step spends in ``sample_posterior``, the fused
posterior pass (the harness's ``posterior`` span, host clock, ended by a
synchronize; untraced steps)."""


def read(run):
    rows = [r["posterior"] for r in run["rows"]]
    return sum(rows) / len(rows) if rows else None
