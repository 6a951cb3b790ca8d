"""Mean seconds a window step spends capturing lone fits' loss and
gradient in CUDA graphs, side-stream warm-up included: the port's
``train.capture`` spans (``_GraphedLossGrad``, host clock, no
synchronize; untraced steps)."""
from portbench import port_tracer


def read(run):
    return port_tracer.mean_seconds(run, "train.capture")
