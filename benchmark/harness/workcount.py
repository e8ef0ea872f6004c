"""The frozen work count of one stencil job, and the card's prices.

The least time one NVIDIA H100 could take for a job is the larger of two
bounds, counted from the job itself and never from how a program runs it:

* bytes: the input read once and the output written once, at the card's
  HBM rate;
* operations: the least multiply-adds a rep that the filter needs, two
  operations each, at the card's densest integer rate (int8 tensor cores).
  A separable filter needs its row taps plus its column taps; any other
  filter its nonzero taps.

Peaks are NVIDIA's data sheet for the H100 SXM part, dense rates, at the
full power limit of 700 W.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15


def least_macs(taps: Sequence[Sequence[float]]) -> int:
    """The least multiply-adds per output element of one rep of ``taps``:
    row taps plus column taps when the matrix is one outer product,
    else its nonzero taps."""
    t = np.asarray(taps, dtype=np.float64)
    nonzero = int(np.count_nonzero(t))
    if nonzero == 0:
        return 0
    if np.linalg.matrix_rank(t) == 1:
        rows = np.flatnonzero(np.any(t != 0, axis=1))
        cols = np.flatnonzero(np.any(t != 0, axis=0))
        return min(nonzero, len(rows) + len(cols))
    return nonzero


def bound_seconds(h: int, w: int, c: int, reps: int,
                  taps: Sequence[Sequence[float]]) -> Tuple[float, str]:
    """(seconds, "bytes" or "ops"): the least time of one job of an
    (h, w, c) uint8 image through ``reps`` reps of ``taps``."""
    elems = h * w * c
    t_bytes = 2 * elems / HBM_BYTES_PER_S
    t_ops = 2 * least_macs(taps) * elems * reps / INT8_TENSOR_OPS_PER_S
    if t_ops > t_bytes:
        return t_ops, "ops"
    return t_bytes, "bytes"
