"""The whole step's model FLOPs over the card's f32 peak, in the untraced
window steps: training counts 3x the forward FLOPs of each trained
clique's flow at its own dims, times the configuration's training samples
and the clique's Adam iterations; the posterior draw counts each clique's
inverse (``work.py``); simulation is not counted.  Over the seconds of
those steps (host clock) times 67 TFLOP/s."""
from portbench import work


def read(run):
    if not run["work"]:
        return None
    s = run["config"]["solver"]
    K, hid, n = s["num_knots"], s["hidden_dim"], s["local_sample_num"]
    flops = 0.0
    for w in run["work"]:
        for d, iters in w["trained"]:
            flops += work.training_flops(n, d, work.hidden_width(d, hid), K,
                                         iters)
        flops += work.posterior_least_seconds(
            s["posterior_sample_num"], w["posterior"], hid, K)[1]
    seconds = sum(r["step"] for r in run["rows"])
    return 100.0 * flops / (seconds * work.PEAK_F32_FLOPS)
