"""The open loop's yardstick: when each request is due, and its latency
from then.

The arrival law is copied from ``tpu_stencil_torch/serve/loadgen.py``
(``run``'s bursty open loop) at commit fcf1ca9, so that a later change to
the port cannot move the yardstick: each tick due a seeded exponential
gap after the last, of mean ``1 / rate`` here, where every tick is one
request: a Poisson process. (loadgen draws these gaps only for ticks of
two or more requests, and runs a metronome for ticks of one.)

The timing is not loadgen's, which starts at submission, so a late
generator hides its stall there: here a request is timed from its due
time, and one that is shed or fails ranks slower than every answered one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def due_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, every one
    before ``seconds``: requests of an open loop at ``rate`` per second."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    period = 1.0 / rate
    # loadgen: jrng = default_rng(seed ^ 0xB5457); t_due +=
    # jrng.exponential(period * burst) at every tick after the first.
    rng = np.random.default_rng(seed ^ 0xB5457)
    n = 2 * int(np.ceil(seconds / period)) + 64
    due = np.concatenate([[0.0], np.cumsum(rng.exponential(period,
                                                           size=n - 1))])
    while due[-1] < seconds:  # a long draw of short gaps
        more = rng.exponential(period, size=n)
        due = np.concatenate([due, due[-1] + np.cumsum(more)])
    return due[due < seconds]


def p99_ms(due: Sequence[float], answered: Sequence[Optional[float]],
           close: float) -> float:
    """The nearest-rank 99th percentile of every request due, in ms.

    ``answered[i]`` is when request ``i``'s result reached host memory,
    on the clock of ``due``, or None where it was shed or failed. Such a
    request is timed to ``close``, when the run stopped waiting, and
    ranks slower than every answered one."""
    done = [a - d for d, a in zip(due, answered) if a is not None]
    slowest = max(done, default=0.0)
    failed = [max(close - d, slowest) for d, a in zip(due, answered)
              if a is None]
    lat = sorted(done) + sorted(failed)
    if not lat:
        raise ValueError("no request was due")
    return 1e3 * lat[math.ceil(0.99 * len(lat)) - 1]
