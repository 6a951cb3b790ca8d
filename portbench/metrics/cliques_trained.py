"""Mean cliques simulated and trained a window step (the ones surgery left
without a model, and none loaded from a store): the port's
``cliques_trained`` counter (untraced steps)."""
from portbench import port_tracer


def read(run):
    return port_tracer.mean_count(run, "cliques_trained")
