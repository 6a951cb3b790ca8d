"""Mean seconds a window step spends simulating cliques' training samples:
the port's ``fit.simulate`` spans (``clique_training_sampler``, host
clock, no synchronize; untraced steps)."""
from portbench import port_tracer


def read(run):
    return port_tracer.mean_seconds(run, "fit.simulate")
