"""The open loop: its arrival law, and latency timed from the due time
with a shed request ranked last."""

import numpy as np
import pytest

from benchmark.harness import arrivals


def test_the_seeded_law_is_loadgens():
    seed, rate = 77, 50.0
    due = arrivals.due_times(rate, 2.0, seed)
    jrng = np.random.default_rng(seed ^ 0xB5457)
    want = np.cumsum([0.0] + [jrng.exponential(1 / rate) for _ in range(5)])
    np.testing.assert_allclose(due[:6], want)
    assert due[-1] < 2.0 and np.all(np.diff(due) >= 0)


def test_a_large_seed_keeps_the_rate():
    due = arrivals.due_times(60.0, 100.0, 2 ** 32 + 7)
    assert 5400 < len(due) < 6600


def test_latency_runs_from_the_due_time():
    # The generator stalled 0.3 s on request 0: requests 1 and 2, due at
    # 10 and 20 ms, were answered at once after it, and are charged from
    # their due times, not from their late submission.
    due = [0.0, 0.01, 0.02]
    answered = [0.301, 0.302, 0.303]
    assert arrivals.p99_ms(due, answered, 1.0) == pytest.approx(301.0)


def test_a_shed_request_ranks_last():
    # the p99 of four is the slowest: the shed one, timed to the close
    due = [0.0, 0.01, 0.02, 0.03]
    answered = [0.005, None, 0.025, 0.035]
    assert arrivals.p99_ms(due, answered, 0.2) == pytest.approx(190.0)
    # shed just before the close, it still ranks above every answer
    assert arrivals.p99_ms([0.0, 0.19], [0.1, None], 0.2) == pytest.approx(
        100.0)


def test_p99_ranks_failures_above_every_answer():
    due = [0.0] * 99
    lat = [0.01 * i for i in range(1, 100)]
    assert arrivals.p99_ms(due, lat, 0.0) == pytest.approx(990.0)
    assert arrivals.p99_ms(due + [0.0], lat + [None], 0.0) == pytest.approx(
        990.0)
    five = due + [0.0] * 5
    assert arrivals.p99_ms(five, lat + [None] * 5, 2.0) == pytest.approx(
        2000.0)
