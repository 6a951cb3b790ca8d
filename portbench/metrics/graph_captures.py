"""Mean CUDA-graph captures a window step: the port's ``graph_captures``
counter (one a lone fit on a card; untraced steps)."""
from portbench import port_tracer


def read(run):
    return port_tracer.mean_count(run, "graph_captures")
