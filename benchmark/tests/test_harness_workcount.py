"""The frozen work count and the card's prices."""

import pytest

from benchmark.harness import workcount

GAUSS = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def test_prices_are_the_data_sheets():
    assert workcount.HBM_BYTES_PER_S == 3.35e12
    assert workcount.INT8_TENSOR_OPS_PER_S == 1.979e15


@pytest.mark.parametrize("taps, macs", [
    (GAUSS, 6),                                   # separable: 3 + 3
    ([[1, 1, 1], [1, 1, 1], [1, 1, 1]], 6),       # box, separable
    ([[0, 1, 0], [1, 4, 1], [0, 1, 0]], 5),       # not separable: nonzeros
    ([[1, 4, 6, 4, 1]] * 1 + [[0] * 5] * 4, 5),   # one row: its taps
    ([[0, 0, 0], [0, 1, 0], [0, 0, 0]], 1),       # identity
])
def test_least_multiply_adds(taps, macs):
    assert workcount.least_macs(taps) == macs


def test_the_reference_jobs_two_bounds():
    elems = 1920 * 2520 * 3
    assert elems == 14_515_200
    t_bytes = 2 * elems / 3.35e12
    t_ops = 6 * 2 * elems * 100 / 1.979e15
    assert t_bytes == pytest.approx(8.666e-6, rel=1e-3)
    assert t_ops == pytest.approx(8.801e-6, rel=1e-3)
    bound, which = workcount.bound_seconds(2520, 1920, 3, 100, GAUSS)
    assert which == "ops" and bound == pytest.approx(t_ops)
    bound, which = workcount.bound_seconds(5040, 1920, 1, 20, GAUSS)
    assert which == "bytes"
    assert bound == pytest.approx(2 * 9_676_800 / 3.35e12)
