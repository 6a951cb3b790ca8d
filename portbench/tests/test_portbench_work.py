"""The frozen work counts against values worked by hand.

At (d, h, K) the spline costs 2*5K + 4(K+1) + 2*3(K-1) + 2K + 8K + 25
FLOPs, 293 at K = 9, and dim ``i`` of one sample 2hi + h + 2h^2 + 2h +
2*3K*h + 3K + 293:

- (16, 8, 9): 16i + 904, so 16*120 + 16*904 = 16384 a sample over all 16
  dims; weights 16 * (8*16 + 8 + 64 + 8 + 27*8 + 27) = 7216 floats.
- (32, 16, 9): 32i + 1744, so 32*496 + 32*1744 = 71680 a sample over all
  32 dims, 71680 - 1744 - 1776 = 68160 with the first two dims given;
  weights 32 * (16*32 + 16 + 256 + 16 + 27*16 + 27) = 40288 floats.
"""
import pytest

from portbench import work


def test_spline_count():
    assert work.spline_flops(9) == 293


@pytest.mark.parametrize("d, h, invert, flops, nbytes", [
    (16, 8, [True] * 16, 16384 * 1000, 4 * (3 * 1000 * 16 + 7216) + 16),
    (32, 16, [True] * 32, 71680 * 1000, 4 * (3 * 1000 * 32 + 40288) + 32),
    # the card smoke's recorded case: 545184 B, 6.816e7 FLOP
    (32, 16, [i >= 2 for i in range(32)], 68160 * 1000, 545184),
])
def test_ar_inverse_work(d, h, invert, flops, nbytes):
    assert work.ar_inverse_work(1000, d, h, 9, invert) == (nbytes, flops)


@pytest.mark.parametrize("d, h, per_sample", [(16, 8, 16384),
                                              (32, 16, 71680)])
def test_training_flops_are_three_forward_passes(d, h, per_sample):
    assert work.flow_forward_flops(1000, d, h, 9) == per_sample * 1000
    assert work.training_flops(2000, d, h, 9, 500) == \
        3 * 500 * 2000 * per_sample


@pytest.mark.parametrize("d, hidden, h", [(9, 8, 8), (16, 8, 8), (20, 8, 10),
                                          (32, 8, 16), (3, 8, 8)])
def test_hidden_width(d, hidden, h):
    assert work.hidden_width(d, hidden) == h


def test_posterior_least_seconds_takes_the_larger_bound():
    # (32, 16, 9), two separator dims, n = 1000: 6.816e7 FLOP at 67 TFLOP/s
    # is 1.0173e-6 s, 545184 B at 3.35 TB/s 1.627e-7 s
    seconds, flops = work.posterior_least_seconds(1000, [(32, 2)], 8, 9)
    assert flops == 68160 * 1000
    assert seconds == pytest.approx(68160e3 / 67e12)
    # a clique of dim 5 (a pose and a landmark) inverts at h = 8
    seconds, flops = work.posterior_least_seconds(1000, [(5, 0)], 8, 9)
    by_dim = sum(2 * 8 * i + 8 + 128 + 16 + 432 + 27 + 293 for i in range(5))
    assert flops == 1000 * by_dim
