"""Share of the traced window (the traced steps, first start to last end)
in which no operation runs on the device: 100 x (1 - busy / window), the
busy time the union of the profiler's device intervals."""
from portbench import trace


def read(run):
    t = run["trace"]
    if t is None or not t["device"]:
        return None
    lo, hi = trace.window(t)
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trace.busy_ns(t) / (hi - lo))
