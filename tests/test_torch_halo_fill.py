"""The mesh's ghost rings pulled into a persistent slab
(``parallel/fill.py``, ``ops/halo_fill.py``, kernel ``halo_fill``).

On the CPU (the kernel's plain version, K3's plain version):

* the piece table (``halo.ring_pieces``, ``fill._State.table``) fills a
  slab's ring equal to ``halo_exchange``'s ghost-extended tiles, byte for
  byte, over grids 1x1 to 3x3, grey and RGB, depths 1, 2 and 8 and
  non-square tiles;
* the fill path's jobs equal the whole-image reference
  (``benchmark/reference/stencil.py``) over jobs that reuse one slab;
* the ordering argument of ``fill``'s docstring, on a log of every
  access, wait and record with each tile on a card of its own (or two
  tiles a card): every two accesses of one buffer region from two cards,
  one a write, are ordered by the streams and events; and the log shows a
  race when the waits are left out, or when a job copies its tiles into
  the buffer the last chunk read;
* where the path engages, the counters (``fill_counts`` moves only there,
  ``exchange_counts`` only on the strip path) and the spans.

On the card (marked ``card``; skipped without CUDA; the grid names
``cuda:0..3`` where there are four cards, else one card several times):
the kernel's ring against ``halo_exchange``, 100-rep ``run_host`` jobs
eager and replayed against the reference, the counts of a job, no copy
between cards and no ``torch.cat`` in a profiled job, and a job whose
cards are slowed unevenly. This file imports no JAX, so on a machine
with the card it runs alone: ``python -m pytest --noconftest -m card
tests/test_torch_halo_fill.py``.

Tolerance: exact bytes (integer plans).
"""

import collections

import numpy as np
import pytest
import torch

from benchmark.reference import stencil as reference
from tpu_stencil_torch import filters
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.obs import tracing
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import halo_fill
from tpu_stencil_torch.parallel import fill, halo
from tpu_stencil_torch.parallel.sharded import (ShardedRunner,
                                                build_sharded_iterate)

CPU = torch.device("cpu")
GAUSS = filters.get_filter("gaussian")


@pytest.fixture(autouse=True)
def _fresh_counts():
    halo.reset_exchange_counts()
    halo.reset_fill_counts()
    yield
    halo.reset_exchange_counts()
    halo.reset_fill_counts()


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _tiles(grid, th, tw, channels, seed, device=CPU):
    rng = np.random.default_rng(seed)
    dims = (th, tw) + ((channels,) if channels != 1 else ())
    return [[torch.from_numpy(rng.integers(0, 256, dims, np.uint8)).to(
        device) for _ in range(grid[1])] for _ in range(grid[0])]


def _plan():
    return IteratedConv2D("gaussian", backend="pallas", device=CPU).plan


def _want(img, reps, device="cpu"):
    return reference.iterate(img, GAUSS.taps, GAUSS.divisor, reps, device)


def _stitch(grid):
    return np.concatenate([np.concatenate([t.cpu().numpy() for t in row], 1)
                           for row in grid], 0)


# ---------------------------------------------------------------------------
# The piece table against the strip exchange
# ---------------------------------------------------------------------------

GRIDS = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 3), (3, 3)]


@pytest.mark.parametrize("depth", [1, 2, 8])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_ring_equals_the_strip_exchange(grid, channels, depth):
    tiles = _tiles(grid, 11, 9, channels, 100 * depth + channels)
    cards = [[CPU] * grid[1] for _ in range(grid[0])]
    st = fill._State(tiles, 8, cards)
    for i, j in st.slab.local_tiles():
        halo_fill.launch(st.table(i, j, depth))
    want = halo.halo_exchange(tiles, depth)
    for i in range(grid[0]):
        for j in range(grid[1]):
            w = want[i][j]
            assert torch.equal(st.slab.ext(i, j, depth),
                               w.reshape(w.shape[0], -1))
    assert halo.exchange_counts()["phases"] == 2
    # past the fill's depth the ring stays zero, and so does a ring with
    # no neighbour (the zero boundary); the other buffer is untouched
    g, gc = 8 - depth, (8 - depth) * channels
    for i, j in st.slab.local_tiles():
        b0, b1 = st.slab.bufs[i][j]
        assert not b1.any()
        assert not b0[:g].any() and not b0[:, :gc].any()
        assert not b0[b0.shape[0] - g:].any()
        assert not b0[:, b0.shape[1] - gc:].any()
        if i == 0:
            assert not b0[:8].any()
        if j == 0:
            assert not b0[:, :8 * channels].any()


def test_the_ring_pieces_of_a_middle_tile():
    pieces = halo.ring_pieces((3, 3), 1, 1, 10, 12, 3, 2)
    assert [p.name for p in pieces] == list(halo.RING_STEPS)
    by = {p.name: p for p in pieces}
    assert by["n"] == halo.RingPiece("n", (0, 1), (8, 10, 0, 12),
                                     (0, 2, 6, 18))
    assert by["se"] == halo.RingPiece("se", (2, 2), (0, 2, 0, 6),
                                      (12, 14, 18, 24))
    assert [p.name for p in halo.ring_pieces((2, 2), 0, 0, 10, 12, 3, 2)] == [
        "s", "e", "se"]
    assert halo.ring_pieces((1, 1), 0, 0, 10, 12, 3, 2) == []
    assert halo.ring_pieces((3, 3), 1, 1, 10, 12, 3, 0) == []
    with pytest.raises(ValueError, match="ring"):
        halo.ring_pieces((2, 2), 0, 0, 4, 12, 1, 5)


def test_a_table_takes_equal_windows_on_its_card():
    a = torch.zeros((6, 8), dtype=torch.uint8)
    t = halo_fill.Table([(a[0:2, 0:3], a[4:6, 5:8])], CPU)
    assert len(t) == 1 and t.peer_pieces == 0 and t.nbytes == 6
    with pytest.raises(ValueError, match="equal shapes"):
        halo_fill.Table([(a[0:2, 0:3], a[4:6, 4:8])], CPU)
    with pytest.raises(ValueError, match="at most 8"):
        halo_fill.Table([(a[0:1, 0:1], a[1:2, 0:1])] * 9, CPU)
    with pytest.raises(ValueError, match="unit lane stride"):
        halo_fill.Table([(a[0:2, 0:4:2], a[4:6, 0:2])], CPU)


# ---------------------------------------------------------------------------
# The fill path's jobs on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (2, 3)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_fill_path_equals_the_reference(grid, channels):
    h, w = 16 * grid[0], 18 * grid[1]
    shape = (h, w) + ((channels,) if channels != 1 else ())
    runner = ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                          device=CPU),
                           (h, w), channels, mesh_shape=grid,
                           devices=[CPU] * (grid[0] * grid[1]))
    f = fill.Filler(runner.model.plan, runner.fuse, runner._global_shape)
    held = []
    for k, reps in enumerate([9, 8, 17, 1, 0, 16]):
        img = _img(shape, 70 + k)
        out = f.run(runner.put(img), reps)
        held.append((out, _want(img, reps)))
    assert len(f._states) == 1  # one slab, kept over the jobs
    for out, want in held:  # every result outlives the later jobs
        np.testing.assert_array_equal(_stitch(out), want)


# ---------------------------------------------------------------------------
# The ordering argument on a log of the accesses
# ---------------------------------------------------------------------------


class _Logged(fill.Filler):
    """A filler on CPU tiles that names a card of its own for each tile
    (``cards``) and logs, in issue order, each copy-in, fill and K3 with
    the slab regions it reads and writes, and each record and wait, each
    on the stream ``(card, self.stream)``: a test moves the jobs to other
    streams by setting ``stream``."""

    def __init__(self, plan, fuse, global_shape, cards):
        super().__init__(plan, fuse, global_shape)
        self.grid_cards = cards
        self.stream = 0
        self.log = []

    def _cards(self, tiles):
        return self.grid_cards

    def _record(self, st, card):
        self.log.append(("record", (card, self.stream), card))

    def _wait(self, st, card, other):
        self.log.append(("wait", (card, self.stream), other))

    def _access(self, st, i, j, reads, writes):
        self.log.append(("access", (self.grid_cards[i][j], self.stream),
                         frozenset(reads), frozenset(writes)))

    def _copy_in(self, st, i, j, x):
        self._access(st, i, j, (), [((i, j), st.slab.cur, "interior")])
        super()._copy_in(st, i, j, x)

    def _fill(self, st, i, j, d):
        s = st.slab
        reads = [(p.src, s.cur, "interior") for p in halo.ring_pieces(
            s.grid, i, j, s.th, s.twc, s.channels, d)]
        if reads:
            self._access(st, i, j, reads, [((i, j), s.cur, "ring")])
        return super()._fill(st, i, j, d)

    def _k3(self, st, i, j, n, out):
        s = st.slab
        mine = s.tile2(i, j, 1 - s.cur).data_ptr() == out.data_ptr()
        self._access(st, i, j,
                     [((i, j), s.cur, "interior"), ((i, j), s.cur, "ring")],
                     [((i, j), 1 - s.cur, "interior")] if mine else [])
        super()._k3(st, i, j, n, out)


def _races(log):
    """The pairs of accesses on two streams, one a write of a region the
    other touches, that the log's records and waits leave unordered:
    vector clocks over the streams (program order on a stream, and a wait
    orders everything after it behind the last record of the card's one
    event)."""
    clock = collections.defaultdict(dict)
    last = {}
    seen = []
    for e in log:
        if e[0] == "record":
            c = clock[e[1]]
            c[e[1]] = c.get(e[1], 0) + 1
            last[e[2]] = dict(c)
        elif e[0] == "wait":
            c = clock[e[1]]
            for k, v in last.get(e[2], {}).items():
                c[k] = max(c.get(k, 0), v)
        else:
            _, unit, reads, writes = e
            c = clock[unit]
            c[unit] = c.get(unit, 0) + 1
            seen.append((unit, dict(c), reads, writes))
    by_region = collections.defaultdict(list)
    for n, a in enumerate(seen):
        for r in a[2] | a[3]:
            by_region[r].append(n)
    races = set()
    for ns in by_region.values():
        for x in ns:
            for y in ns:
                a, b = seen[x], seen[y]
                if x >= y or a[0] == b[0]:
                    continue
                if not (a[3] & (b[2] | b[3]) or b[3] & a[2]):
                    continue
                if b[1].get(a[0], 0) < a[1][a[0]]:
                    races.add((x, y))
    return races


CARD_GRIDS = {
    "2x2 four cards": [["a", "b"], ["c", "d"]],
    "1x2 two cards": [["a", "b"]],
    "2x3 six cards": [["a", "b", "c"], ["d", "e", "f"]],
    "2x2 two cards": [["a", "a"], ["b", "b"]],
    "3x3 nine cards": [["a", "b", "c"], ["d", "e", "f"], ["g", "h", "i"]],
}
# Each job's reps, and the streams it is issued on.
JOBS = [(9, 0), (8, 0), (17, 1), (1, 0), (16, 2), (9, 2), (9, 1)]


def _logged(cards, cls=_Logged):
    grid = (len(cards), len(cards[0]))
    tiles = _tiles(grid, 16, 18, 1, 5)
    glob = (16 * grid[0], 18 * grid[1])
    return cls(_plan(), 8, glob, cards), tiles


def _run_jobs(f, tiles):
    for reps, stream in JOBS:
        f.stream = stream
        f.run(tiles, reps)


@pytest.mark.parametrize("name", list(CARD_GRIDS))
def test_every_conflicting_access_is_ordered(name):
    f, tiles = _logged(CARD_GRIDS[name])
    _run_jobs(f, tiles)
    accesses = [e for e in f.log if e[0] == "access"]
    assert len(accesses) > 50
    assert _races(f.log) == set()
    # in a chunk each card waits on its neighbours' cards alone; a job
    # starts with each card waiting on its own last event
    waits = [(e[1][0], e[2]) for e in f.log if e[0] == "wait"]
    cards = {c for row in CARD_GRIDS[name] for c in row}
    assert sum(a == b for a, b in waits) == len(JOBS) * len(cards)
    if name == "2x2 four cards":
        assert {(a, b) for a, b in waits if a != b} == {
            (a, b) for a in "abcd" for b in "abcd" if a != b}


class _NoWaits(_Logged):
    def _wait(self, st, card, other):
        pass


class _NoStartWaits(_Logged):
    """Leaves out the wait of each card on its own last event."""

    def _wait(self, st, card, other):
        if card != other:
            super()._wait(st, card, other)


class _SameBuffer(_Logged):
    """Copies each job's tiles into the buffer the last chunk read."""

    def _job(self, st, tiles, depths):
        st.slab.cur = 1 - st.slab.cur
        return super()._job(st, tiles, depths)


@pytest.mark.parametrize("cls", [_NoWaits, _SameBuffer, _NoStartWaits])
def test_a_broken_order_shows_a_race(cls):
    f, tiles = _logged(CARD_GRIDS["2x2 four cards"], cls)
    _run_jobs(f, tiles)
    assert _races(f.log)


# ---------------------------------------------------------------------------
# Where it engages; the counters and spans
# ---------------------------------------------------------------------------


class _T:
    """What ``Filler.engages`` reads of a tile."""

    def __init__(self, device, shape=(20, 20)):
        self.device = torch.device(device)
        self.shape = shape


def test_it_engages_on_cards_that_reach_each_other(monkeypatch):
    asked = []

    def peer(a, b):
        asked.append((a, b))
        return (a, b) not in {(2, 3), (3, 2)}

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", peer)
    f = fill.Filler(_plan(), 8, (40, 40))
    assert f.engages([[_T("cuda:0"), _T("cuda:1")]], None)
    assert not f.engages([[_T("cuda:2"), _T("cuda:3")]], None)
    assert not f.engages([[_T("cuda:0"), _T("cuda:1")]], mask=[[1, 1]])
    assert not f.engages([[_T("cpu"), _T("cpu")]], None)
    assert not f.engages([[_T("cuda:0"), None]], None)
    assert not f.engages([[_T("cuda:0", (7, 20)), _T("cuda:1")]], None)
    asked.clear()
    assert f.engages([[_T("cuda:1")] * 2] * 2, None)  # one card
    assert asked == []
    f.engages([[_T("cuda:0"), _T("cuda:1")]], None)
    assert asked == []  # asked once a pair


def test_the_runner_builds_a_filler_only_where_it_may_engage():
    plan = _plan()

    def filler_of(**kw):
        fn = build_sharded_iterate(plan, kw.pop("needs_mask", False),
                                   global_shape=(32, 32), **kw)
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__ or ()))
        return cells["filler"].cell_contents if "filler" in cells else None

    assert isinstance(filler_of(backend="pallas", fuse=8), fill.Filler)
    assert filler_of(backend="pallas", fuse=1, needs_mask=True) is None
    assert filler_of(backend="pallas", fuse=8, peers=object()) is None
    assert filler_of(backend="xla") is None
    assert filler_of(backend="pallas", fuse=8, overlap="edge") is None


def _cpu_runner(shape=(32, 36), grid=(2, 2), overlap="off"):
    ch = 1 if len(shape) == 2 else shape[2]
    return ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                        device=CPU),
                         shape[:2], ch, mesh_shape=grid,
                         devices=[CPU] * (grid[0] * grid[1]),
                         overlap=overlap)


def test_the_strip_path_leaves_fill_counts_at_zero():
    runner = _cpu_runner()
    img = _img((32, 36), 8)
    got = runner.fetch(runner.run(runner.put(img), 9))
    np.testing.assert_array_equal(got, _want(img, 9))
    assert halo.exchange_counts()["phases"] == 4
    assert halo.fill_counts() == {"fills": 0, "pieces": 0,
                                  "peer_pieces": 0, "bytes": 0}


@pytest.mark.parametrize("overlap", ["off", "edge"])
def test_where_it_engages_it_alone_counts(overlap, monkeypatch):
    monkeypatch.setattr(fill.Filler, "engages", lambda self, t, m: True)
    runner = _cpu_runner(overlap=overlap)
    img = _img((32, 36), 9)
    got = runner.fetch(runner.run(runner.put(img), 100))
    np.testing.assert_array_equal(got, _want(img, 100))
    counts = halo.fill_counts()
    if overlap == "edge":  # the overlap schedules keep their exchange
        assert counts["fills"] == 0
        assert halo.exchange_counts()["phases"] > 0
        return
    assert halo.exchange_counts() == {"phases": 0, "strips": 0,
                                      "peer_strips": 0, "peer_bytes": 0}
    # 16 chunks (12 of 8 reps, 4 tails), one fill a tile each, 3 pieces a
    # tile of a 2x2; 8-deep rings for the chunks of 8, 1-deep for the tails
    assert counts["fills"] == 16 * 4 and counts["pieces"] == 16 * 4 * 3
    assert counts["peer_pieces"] == 0

    def ring(d):
        return d * 18 + 16 * d + d * d

    assert counts["bytes"] == 4 * (12 * ring(8) + 4 * ring(1))


def test_a_profiled_fill_records_its_span(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(fill.Filler, "engages", lambda self, t, m: True)
    runner = _cpu_runner()
    tiles = runner.put(_img((32, 36), 10))
    import time
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run(tiles, 9)
    spans = [r for r in tracing.profiled_spans(t0, time.time_ns())
             if r.name == "sharded.exchange"]
    # one a chunk, around its four tiles' fills (3 pieces each)
    assert [s.args["depth"] for s in spans] == [8, 1]
    assert all(s.args["fill"] is True and s.args["pieces"] == 12
               and s.args["peer_pieces"] == 0 for s in spans)
    assert [s.args["bytes"] for s in spans] == [
        4 * (8 * 18 + 16 * 8 + 64), 4 * (18 + 16 + 1)]
    issues = [r for r in tracing.profiled_spans(t0, time.time_ns())
              if r.name == "sharded.issue"]
    assert [s.args["reps"] for s in issues] == [8, 1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    n = torch.cuda.device_count()
    return [torch.device("cuda", k % n) for k in range(4)]


def _card_runner(cards, shape, grid):
    ch = 1 if len(shape) == 2 else shape[2]
    devs = cards[:grid[0] * grid[1]]
    runner = ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                          device=devs[0]),
                           shape[:2], ch, mesh_shape=grid, devices=devs)
    runner.prepare()
    return runner


@pytest.mark.card
@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("grid", [(2, 2), (1, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_kernel_ring_equals_the_strip_exchange(cards, grid, channels,
                                                   depth):
    devs = cards[:grid[0] * grid[1]]
    grid_cards = [devs[i * grid[1]:(i + 1) * grid[1]]
                  for i in range(grid[0])]
    rng = np.random.default_rng(depth + channels)
    dims = (37, 29) + ((channels,) if channels != 1 else ())
    tiles = [[torch.from_numpy(rng.integers(0, 256, dims, np.uint8)).to(d)
              for d in row] for row in grid_cards]
    st = fill._State(tiles, 8, grid_cards)
    for k in range(2):
        st.slab.cur = k
        for i, j in st.slab.local_tiles():
            st.slab.tile2(i, j).copy_(tiles[i][j].reshape(37, -1))
        for i, j in st.slab.local_tiles():
            halo_fill.launch(st.table(i, j, depth))
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)
        want = halo.halo_exchange(tiles, depth)
        for i, j in st.slab.local_tiles():
            w = want[i][j]
            assert torch.equal(st.slab.ext(i, j, depth).cpu(),
                               w.reshape(w.shape[0], -1).cpu())


@pytest.mark.card
@pytest.mark.parametrize("shape", [(1000, 760), (1000, 760, 3)],
                         ids=["grey", "rgb"])
@pytest.mark.parametrize("grid", [(2, 2), (1, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_card_jobs_equal_the_reference(cards, grid, shape):
    runner = _card_runner(cards, shape, grid)
    reps = 100
    src = [_img(shape, 40 + k) for k in range(3)]
    want = [_want(a, reps, cards[0]) for a in src]
    ring = [runner.host_tiles(a, pin=True) for a in src]
    out = [runner.host_tiles(pin=True) for _ in src]
    assert runner._replayable(ring[0])
    before = halo.fill_counts()["fills"]
    eager = runner._place_and_run(ring[0], reps)
    runner.fetch_into(eager, out[0])
    np.testing.assert_array_equal(_stitch(out[0]), want[0])
    tiles = len(runner.devices)
    assert halo.fill_counts()["fills"] - before == 16 * tiles
    assert halo.exchange_counts()["phases"] == 0
    for k in range(6):  # replays over rewritten inputs
        slot = k % 3
        for t, a in zip((t for row in ring[slot] for t in row),
                        (t for row in runner.host_tiles(src[slot])
                         for t in row)):
            t.copy_(a)
        y = runner.run_host(ring[slot], reps)
        for t in (t for row in ring[slot] for t in row):
            t.fill_(0xFF)  # the caller's tiles, free on return
        if k == 2:  # two results held at once
            y2 = runner._place_and_run(runner.host_tiles(src[0], pin=True),
                                       reps)
            runner.fetch_into(y2, out[2])
            np.testing.assert_array_equal(_stitch(out[2]), want[0])
        runner.fetch_into(y, out[slot])
        np.testing.assert_array_equal(_stitch(out[slot]), want[slot])
    assert halo.exchange_counts()["phases"] == 0


@pytest.mark.card
def test_a_profiled_job_crosses_no_card_by_copy(cards):
    from torch.profiler import ProfilerActivity, profile

    shape = (1000, 760)
    runner = _card_runner(cards, shape, (2, 2))
    img = _img(shape, 50)
    host = runner.host_tiles(img, pin=True)
    out = runner.host_tiles(pin=True)
    # warm: the replay, and the eager path's own slab on these streams
    runner.fetch_into(runner.run_host(host, 9), out)
    runner.fetch_into(runner._place_and_run(host, 9), out)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = runner.run_host(host, 100)
        runner.fetch_into(y, out)
    np.testing.assert_array_equal(_stitch(out), _want(img, 100, cards[0]))
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "PtoP" in n or "CatArrayBatched" in n
                or "FillFunctor" in n]
    assert sum("halo_fill_kernel" in n for n in names) == 16 * 4
    assert sum("stencil_valid_kernel" in n for n in names) == 16 * 4


@pytest.mark.card
@pytest.mark.parametrize("path", ["eager", "replay"])
def test_cards_slowed_unevenly_still_equal_the_reference(cards, path,
                                                         monkeypatch):
    real = cs.valid_fused
    slow = cards[1]

    def late(ext2, *a, **k):
        if ext2.device == slow:
            torch.cuda._sleep(2_000_000)  # ~1 ms before this card's K3
        return real(ext2, *a, **k)

    monkeypatch.setattr(cs, "valid_fused", late)
    shape = (1000, 760)
    runner = _card_runner(cards, shape, (2, 2))
    src = [_img(shape, 60 + k) for k in range(2)]
    for k in range(4):
        a = src[k % 2]
        host = runner.host_tiles(a, pin=True)
        out = runner.host_tiles(pin=True)
        y = (runner._place_and_run(host, 33) if path == "eager"
             else runner.run_host(host, 33))
        runner.fetch_into(y, out)
        np.testing.assert_array_equal(_stitch(out),
                                      _want(a, 33, cards[0]))
