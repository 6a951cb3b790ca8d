"""The work of a step, counted from shapes: the yardstick of the roofline
and MFU readings, frozen here so that no change to the program moves it.

One spline count serves both directions.  ``ar_inverse_work`` is a copy
of the card smoke's count of one masked AR inverse (``chip_smoke.py``,
``ar_inverse_work``): the inputs, the prefix and the weights read once,
the output written once; for each inverted dim ``i`` and sample, the
conditioner's three layers (2 FLOPs a multiply-add, W1 over the ``i``
visible inputs), their biases and tanh's, and the spline (two K-bin
softmaxes, K+1 softplus derivatives, the knots, the bin search and
select, the quadratic root), one FLOP an operation, transcendentals
included.  ``flow_forward_flops`` is the same per-dim count over every
dim, the density the training evaluates; training counts 3x it (the
forward pass and its gradient), the model FLOPs of one Adam iteration.
``profile_utilization.py``'s ``RQS_FLOPS_PER_SCALAR = 45`` is not used.

Every count is at a clique's own dims: ``d`` its variables' dims (no
padding to a bucket), ``h`` the configuration's conditioner width at that
dim (``effective_hidden_dim``: max(hidden_dim, d // 2) when it scales with
the dim), ``K`` the knots.
"""
from __future__ import annotations

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W limit:
# float32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def hidden_width(d: int, hidden_dim: int, scale_with_dim: bool = True) -> int:
    """The conditioner width at dim ``d`` (the port's
    ``solver.nfisam.effective_hidden_dim``)."""
    return max(int(hidden_dim), int(d) // 2) if scale_with_dim \
        else int(hidden_dim)


def spline_flops(K: int) -> int:
    return 2 * (5 * K) + 4 * (K + 1) + 2 * 3 * (K - 1) + 2 * K + 8 * K + 25


def dim_flops(i: int, h: int, K: int) -> int:
    """FLOPs of dim ``i`` for one sample: the conditioner on ``i``
    visible inputs and one spline."""
    p = 3 * K
    return 2 * h * i + h + 2 * h * h + 2 * h + 2 * p * h + p + spline_flops(K)


def ar_inverse_work(n: int, d: int, h: int, K: int, invert) -> tuple:
    """(bytes, FLOPs) of one flow's masked inverse of ``n`` samples at
    (d, h, K), inverting the dims where ``invert[i]`` is true."""
    p = 3 * K
    weights = d * (h * d + h + h * h + h + p * h + p)
    nbytes = 4 * (3 * n * d + weights) + d
    return nbytes, float(n * sum(dim_flops(i, h, K) for i in range(d)
                                 if invert[i]))


def flow_forward_flops(n: int, d: int, h: int, K: int) -> float:
    """FLOPs of one flow's density at ``n`` samples: every dim."""
    return float(n * sum(dim_flops(i, h, K) for i in range(d)))


def training_flops(n: int, d: int, h: int, K: int, iters: int) -> float:
    """Model FLOPs of ``iters`` Adam iterations on ``n`` samples: 3x the
    forward pass (forward and gradient)."""
    return 3.0 * iters * flow_forward_flops(n, d, h, K)


def posterior_least_seconds(n: int, cliques, hidden_dim: int, K: int,
                            scale_with_dim: bool = True) -> tuple:
    """(least seconds, FLOPs) of one posterior draw of ``n`` samples over
    ``cliques``, each (dim, separator dim): the separator's dims come
    first and the frontal ones are inverted.  A clique's least time is
    the larger of its FLOPs at the f32 peak and its bytes at the HBM
    bandwidth."""
    seconds, flops = 0.0, 0.0
    for d, sep in cliques:
        h = hidden_width(d, hidden_dim, scale_with_dim)
        nbytes, f = ar_inverse_work(n, d, h, K,
                                    [i >= sep for i in range(d)])
        seconds += max(f / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
        flops += f
    return seconds, flops
