"""The plain reference against hand-worked cases, and its control."""

import numpy as np
import torch

from benchmark.reference import stencil

GAUSS = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def test_a_hand_worked_rep():
    img = np.array([[0, 16, 0], [16, 160, 16], [0, 16, 0]], np.uint8)
    # centre: (4*160 + 2*4*16) / 16 = 48; edge (0, 1): (4*16 + 2*160 +
    # 16 + 16) / 16 = 26; corner: (2*16 + 2*16 + 160) / 16 = 14.
    want = np.array([[14, 26, 14], [26, 48, 26], [14, 26, 14]], np.uint8)
    np.testing.assert_array_equal(stencil.iterate(img, GAUSS, 16, 1), want)


def test_the_divide_floors_and_the_border_is_zero():
    img = np.full((3, 3), 255, np.uint8)
    # corner 255 * 9 / 16 = 143.44; edge 255 * 12 / 16 = 191.25
    want = np.array([[143, 191, 143], [191, 255, 191], [143, 191, 143]],
                    np.uint8)
    np.testing.assert_array_equal(stencil.iterate(img, GAUSS, 16, 1), want)


def test_channels_are_independent_and_reps_iterate():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    out = stencil.iterate(rgb, GAUSS, 16, 3)
    for c in range(3):
        np.testing.assert_array_equal(
            out[..., c], stencil.iterate(rgb[..., c], GAUSS, 16, 3))
    twice = stencil.iterate(stencil.iterate(rgb, GAUSS, 16, 1), GAUSS, 16, 2)
    np.testing.assert_array_equal(out, twice)
    np.testing.assert_array_equal(stencil.iterate(rgb, GAUSS, 16, 0), rgb)


def test_a_divisor_not_a_power_of_two_rounds_once():
    img = np.full((3, 3), 100, np.uint8)
    box = [[1, 1, 1]] * 3
    # centre 900 / 9 = 100; corner 400 / 9 = 44.4; edge 600 / 9 = 66.7
    want = np.array([[44, 66, 44], [66, 100, 66], [44, 66, 44]], np.uint8)
    np.testing.assert_array_equal(stencil.iterate(img, box, 9, 1), want)


def test_the_control_breaks_exactness():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 48), dtype=np.uint8)
    exact = stencil.iterate(img, GAUSS, 16, 2)
    for dt in (torch.float16, torch.bfloat16):
        assert np.count_nonzero(
            stencil.iterate(img, GAUSS, 16, 2, accumulate=dt) != exact) > 0
