"""Share of the Adam loops' wall in the traced steps in which no operation
runs on the device: the port's ``train.loop`` records inside the traced
window, each from its start to its end on the profiler's clock, against
the union of the trace's device intervals."""
from portbench import port_tracer


def read(run):
    loops = port_tracer.traced_records(run, "train.loop")
    if not loops or not run["trace"]["device"]:
        return None
    busy = run["trace"]["busy"]
    wall = sum(r.end - r.start for r in loops)
    if wall <= 0:
        return None
    idle = sum(r.end - r.start - port_tracer.busy_within(busy, r.start,
                                                           r.end)
               for r in loops)
    return 100.0 * idle / wall
