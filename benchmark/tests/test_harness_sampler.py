"""The check's sampler keeps outputs by taking their buffers, so the
window copies nothing for it, and every output has the same chance."""

import numpy as np

from benchmark.harness.cell import Sampler


def _drive(sampler, n, ring):
    outs = [np.full(3, s, np.uint8) for s in range(ring)]
    for i in range(n):
        slot = i % ring
        outs[slot][:] = i % 251          # the output lands in its buffer
        nxt = sampler.offer(i, outs[slot])
        assert nxt is not None
        outs[slot] = nxt
    return outs


def test_a_kept_output_is_its_own_buffer_and_never_overwritten():
    ring, k = 4, 3
    s = Sampler(2 ** 33 + 1, ring, k)
    s.spares = [np.zeros(3, np.uint8) for _ in range(ring + k)]
    outs = _drive(s, 500, ring)
    kept = s.samples()
    assert [i for i, _ in kept[:ring]] == list(range(ring))
    assert len(kept) == ring + k
    for i, buf in kept:
        assert np.all(buf == i % 251)
    # the buffers in use and the kept ones are distinct: none is shared
    ids = [id(b) for b in outs] + [id(b) for b in s.first.values()] + [
        id(b) for _, b in s.reservoir]
    assert len(set(ids)) == len(ids) == 2 * ring + k


def test_the_reservoir_is_uniform_over_the_window():
    ring, k, n = 2, 4, 200
    hits = np.zeros(n)
    for seed in range(400):
        s = Sampler(seed, ring, k)
        s.spares = [np.zeros(1, np.uint8) for _ in range(ring + k)]
        _drive(s, n, ring)
        for i, _ in s.reservoir:
            hits[i] += 1
    share = hits[ring:].reshape(-1, 18).sum(axis=1) / (400 * k)
    np.testing.assert_allclose(share, 18 / (n - ring), atol=0.03)
