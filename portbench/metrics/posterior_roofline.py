"""The posterior draw's share of its roofline in the traced steps: the
least seconds the draw needs (each clique of the tree at its own dims,
the configuration's samples, hidden width and knots: the larger of its
FLOPs at the f32 peak and its bytes at the HBM bandwidth, ``work.py``)
over the device seconds of every operation that starts inside the
harness's ``posterior`` spans."""
from portbench import trace, work


def read(run):
    t = run["trace"]
    if t is None or not run["traced_work"]:
        return None
    device_s = trace.device_in(t, "posterior")
    if device_s <= 0:
        return None
    s = run["config"]["solver"]
    least = sum(work.posterior_least_seconds(
        s["posterior_sample_num"], w["posterior"], s["hidden_dim"],
        s["num_knots"])[0] for w in run["traced_work"])
    return 100.0 * least / device_s
