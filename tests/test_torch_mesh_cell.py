"""The benchmark's mesh cell (``grey5040.mesh2x2.r100``): the upstream's
four-rank deployment, grey 1920x5040 over a 2x2 mesh, through the port's
``ShardedRunner``, and what traces it.

* ``ShardedRunner`` on a 2x2 mesh of one CPU named four times against the
  benchmark's whole-image reference (``benchmark/reference/stencil.py``),
  byte for byte: divisible and padded shapes, grey and RGB, reps that
  straddle K3's chunks of 8 and their single-rep tails, by the host
  tile-grid path (``host_tiles``, ``run_host``, ``fetch_into``) and by the
  numpy path (``put``, ``run``, ``fetch``).
* The pinned placement's order on a stubbed card: every tile's copy
  non-blocking with an event behind it, K3's launches after the copies,
  the events waited for after the launches.
* The replay of a captured job on stubbed cards: captured once after one
  eager run, the other cards forked from the first card's stream and
  joined back, each call's copies behind the last clones and before the
  one replay, the copies waited for last (also on a raise), each result a
  clone; and what does not replay (a pageable tile, an overlap schedule,
  cards without peer access, the CPU, a call under a profiler) runs the
  chunks.
* The cell on the CPU at a small size: correct given one device or four,
  and not correct with the exchange left out or one tile's chunk returned
  unchanged.
* The spans ``sharded.place``, ``sharded.exchange`` and ``sharded.issue``,
  the counter ``halo.exchange_counts()``, the spec's metrics of the cell,
  and the three new readers and the per-card alignment on synthetic
  captures.

Tolerance: exact bytes (integer plans).
"""

import contextlib
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import cell as bcell
from benchmark.harness import mesh_spans
from benchmark.harness import program_spans as ps
from benchmark.harness import spec
from benchmark.harness.trace import Capture, DeviceOp
from benchmark.reference import stencil as reference
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch import obs
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.obs import tracing
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.parallel import halo, sharded
from tpu_stencil_torch.parallel.sharded import ShardedRunner

torch.set_num_threads(1)

CELL = "grey5040.mesh2x2.r100"
CONFIG = "waterfall-grey-1920x5040-mesh2x2"
JOB_CELLS = ("rgb2520.job.r100", "grey5040.job.r100", "rgb5040edge.job.r100")
BENCH = spec.load()
SMALL = {"width": 48, "height": 40}
CPU = torch.device("cpu")
MESH = (2, 2)
JOB_METRICS = ["kernel_roofline_pct.mpx", "device_idle_pct.mpx",
               "copy_ms.mpx", "issue_ms.mpx", "idle_program_pct.mpx",
               "idle_gc_pct.mpx"]
CELL_METRICS = ["kernel_roofline_pct.mpx", "device_idle_pct.mpx",
                "copy_ms.mpx", "halo_ms.mpx", "exchange_ms.mpx",
                "idle_mesh_pct.mpx"]
NEW_READERS = ["halo_ms.mpx", "exchange_ms.mpx", "idle_mesh_pct.mpx"]


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    cs.reset_launch_counts()
    halo.reset_exchange_counts()
    yield
    obs.reset()
    cs.reset_launch_counts()
    halo.reset_exchange_counts()


def _filter():
    return spec.config(BENCH, CONFIG)["filter"]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _runner(shape, overlap="off", devices=(CPU,) * 4):
    model = IteratedConv2D(_filter()["name"], backend="pallas", device=CPU)
    ch = 1 if len(shape) == 2 else shape[2]
    return ShardedRunner(model, shape[:2], ch, mesh_shape=MESH,
                         devices=list(devices), overlap=overlap)


def _spans(name):
    return [r for r in tracing.profiled_spans(0, 1 << 62) if r.name == name]


# ---------------------------------------------------------------------------
# The configuration and the runner against the reference
# ---------------------------------------------------------------------------


def test_the_configuration_is_the_ports_gaussian_on_a_2x2_mesh():
    cfg = spec.config(BENCH, CONFIG)
    assert (cfg["width"], cfg["height"], cfg["channels"]) == (1920, 5040, 1)
    assert cfg["mesh"] == [2, 2]
    assert cfg["boundary"] == "zero" and cfg["reduced"] == []
    f = tfilters.get_filter(cfg["filter"]["name"])
    np.testing.assert_array_equal(f.taps, np.asarray(cfg["filter"]["taps"]))
    assert f.divisor == cfg["filter"]["divisor"] == 16
    # an explicit 2x2, one unpadded tile a card: the perimeter objective
    # alone would cut this tall image into four row bands
    from tpu_stencil_torch.parallel import partition
    assert partition.grid_shape(4, 5040, 1920) == (4, 1)
    assert partition.tile_shape(5040, 1920, MESH) == (2520, 960)
    runner = _runner((5040, 1920))
    assert runner.backend == "pallas" and runner.fuse == cs.DEFAULT_FUSE
    assert not runner.needs_mask and runner.overlap == "off"


PATHS = ["host", "numpy"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("reps", [1, 8, 13, 100])
@pytest.mark.parametrize("shape", [(40, 48), (37, 29), (40, 48, 3),
                                   (37, 29, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_runner_equals_the_whole_image_reference(shape, reps, path):
    f = _filter()
    img = _img(shape, 2000 + reps + sum(shape))
    runner = _runner(shape)
    if path == "host":
        out = runner.host_tiles()
        tiles = runner.host_tiles(img)
        before = [[t.clone() for t in row] for row in tiles]
        runner.fetch_into(runner.run_host(tiles, reps), out)
        got = np.concatenate([np.concatenate([t.numpy() for t in row], 1)
                              for row in out], 0)[:shape[0], :shape[1]]
        for row, brow in zip(tiles, before):  # the input is not written
            for t, b in zip(row, brow):
                assert torch.equal(t, b)
    else:
        got = runner.fetch(runner.run(runner.put(img), reps))
    want = reference.iterate(img, f["taps"], f["divisor"], reps)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_host_tiles_are_the_padded_grid():
    runner = _runner((37, 29, 3))
    img = _img((37, 29, 3), 5)
    tiles = runner.host_tiles(img)
    assert [[tuple(t.shape) for t in row] for row in tiles] == (
        [[(19, 15, 3)] * 2] * 2)
    assert all(t.is_contiguous() and t.device == CPU
               for row in tiles for t in row)
    got = torch.cat([torch.cat(row, 1) for row in tiles], 0).numpy()
    np.testing.assert_array_equal(got[:37, :29], img)
    assert not got[37:].any() and not got[:, 29:].any()
    out = runner.host_tiles()
    assert [[tuple(t.shape) for t in row] for row in out] == (
        [[(19, 15, 3)] * 2] * 2)
    with pytest.raises(ValueError):
        runner.host_tiles(_img((36, 29, 3), 5))


# ---------------------------------------------------------------------------
# The pinned placement on a stubbed card
# ---------------------------------------------------------------------------


class _Card:
    """Four cards' calls, stubbed: ``log`` holds (what, detail) in the
    order the runner made them. A host tile reads as page-locked, its
    copy to a card hands back a tensor on the ``meta`` device, which K3's
    wrapper takes down its card path to a fake library."""

    def __init__(self, monkeypatch):
        self.log = []
        card = self
        real_to = torch.Tensor.to

        def to(t, *args, **kw):
            dev = kw.get("device", args[0] if args else None)
            if isinstance(dev, (str, torch.device)) and (
                    torch.device(dev).type == "cuda"):
                card.log.append(("copy", (str(dev),
                                          bool(kw.get("non_blocking")))))
                return torch.empty(t.shape, dtype=t.dtype, device="meta")
            return real_to(t, *args, **kw)

        class Event:
            def __init__(self, dev):
                self.dev = dev

            def synchronize(self):
                card.log.append(("wait", self.dev))

        class Stream:
            cuda_stream = 0

            def __init__(self, dev):
                self.dev = dev

            def record_event(self):
                card.log.append(("record", self.dev))
                return Event(self.dev)

        class Lib:
            def stencil_valid_launch(self, *args):
                card.log.append(("launch", None))
                return 0

        monkeypatch.setattr(torch.Tensor, "to", to)
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
        monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: id(self))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: Stream(str(d)))
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(cs, "_valid_lib", lambda: Lib())
        monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)

    def kinds(self):
        return [k for k, _ in self.log]


CARDS = [torch.device("cuda", k) for k in range(4)]


def test_the_pinned_tiles_are_copied_behind_the_launches(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    card = _Card(monkeypatch)
    runner.run_host(host, 9)
    kinds = card.kinds()
    # four non-blocking copies, one to each card, each with its event
    assert [d for k, d in card.log if k == "copy"] == [
        (str(d), True) for d in CARDS]
    assert kinds[:8] == ["copy", "record"] * 4
    # K3 on every tile for the chunk of 8 and the one-rep tail, queued
    # behind the copies; the copies waited for after the last launch
    assert kinds[8:].count("launch") == 8
    assert kinds[-4:] == ["wait"] * 4
    assert {d for k, d in card.log if k == "wait"} == {str(d) for d in CARDS}
    assert max(i for i, k in enumerate(kinds) if k == "launch") < len(
        kinds) - 4


def test_the_copies_are_waited_for_when_the_run_raises(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    card = _Card(monkeypatch)

    def refused(*a, **k):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(cs, "valid_fused", refused)
    with pytest.raises(RuntimeError, match="refused"):
        runner.run_host(host, 9)
    assert card.kinds()[-4:] == ["wait"] * 4


def test_a_pageable_tile_is_placed_and_waited_for_first(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    card = _Card(monkeypatch)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: False)
    runner.run_host(host, 9)
    assert [d for k, d in card.log if k == "copy"] == [
        (str(d), False) for d in CARDS]
    assert "record" not in card.kinds() and "wait" not in card.kinds()


# ---------------------------------------------------------------------------
# The replay of a captured job on stubbed cards
# ---------------------------------------------------------------------------


class _GraphCard(_Card):
    """:class:`_Card` with the runtime a replay needs: streams that log
    their events and waits, a CUDA graph that logs its capture and
    replays, memory pools, and a copy into a card's tile (``h2d``)."""

    def __init__(self, monkeypatch, peer=True):
        super().__init__(monkeypatch)
        card = self
        log = self.log

        class Event:
            def __init__(self, dev):
                self.dev = dev

            def synchronize(self):
                log.append(("wait", self.dev))

        class Stream:
            cuda_stream = 0

            def __init__(self, dev, side=False):
                self.dev, self.side = str(dev), side

            def record_event(self):
                log.append(("record", (self.dev, self.side)))
                return Event(self.dev)

            def wait_event(self, ev):
                log.append(("stream_wait", (self.dev, self.side, ev.dev)))

        class Graph:
            def capture_begin(self, capture_error_mode="global"):
                log.append(("capture_begin", capture_error_mode))
                card.capturing = True

            def capture_end(self):
                log.append(("capture_end", None))
                card.capturing = False

            def replay(self):
                log.append(("replay", None))

        real_copy = torch.Tensor.copy_

        def copy_(x, t, non_blocking=False):
            if x.device.type == "meta" and t.device.type == "cpu":
                log.append(("h2d", bool(non_blocking)))
            return real_copy(x, t, non_blocking=non_blocking)

        self.capturing = False
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                            lambda a, b: peer)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "Stream",
                            lambda d: Stream(d, side=True))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: Stream(d))
        monkeypatch.setattr(torch.cuda, "stream",
                            lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda d=None: log.append(("sync", str(d))))
        monkeypatch.setattr(torch.cuda, "MemPool", lambda: object())
        monkeypatch.setattr(
            torch.cuda, "use_mem_pool",
            lambda pool, d: contextlib.nullcontext(
                log.append(("pool", str(d)))))
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.Tensor, "copy_", copy_)

    def calls(self):
        """The log split into the runner's calls at the ``mark`` entries a
        test appends between them."""
        out, cur = [], []
        for k, d in self.log:
            if k == "mark":
                out.append(cur)
                cur = []
            else:
                cur.append((k, d))
        return out + [cur]


def test_a_pinned_grid_on_cards_is_captured_once_and_replayed(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    card = _GraphCard(monkeypatch)
    outs = []
    for _ in range(3):
        outs.append(runner.run_host(host, 9))
        card.log.append(("mark", None))
    first, second, third = card.calls()[:3]
    kinds = [k for k, _ in first]
    # the graph's inputs placed from the first grid; one eager run of 8
    # K3 launches (a chunk of 8 and a tail of 1 on 4 tiles), then the
    # same 8 under one capture, in a pool of the graph's own on the three
    # other cards, the other cards' streams forked from the first's and
    # joined back into it
    assert [d for k, d in first if k == "copy"] == [
        (str(d), False) for d in CARDS]
    cap = kinds.index("capture_begin"), kinds.index("capture_end")
    assert kinds[:cap[0]].count("launch") == 8
    assert kinds[cap[0]:cap[1]].count("launch") == 8
    assert [d for k, d in first if k == "pool"] == [str(d)
                                                    for d in CARDS[1:]]
    assert ("capture_begin", "thread_local") in first
    waits = [d for k, d in first[cap[0]:cap[1]] if k == "stream_wait"]
    assert waits[:3] == [(str(d), True, "cuda:0") for d in CARDS[1:]]
    assert waits[-3:] == [("cuda:0", True, str(d)) for d in CARDS[1:]]
    # every call: four copies behind their cards' last clones, then one
    # replay, each output cloned behind it, the copies waited for last
    for n, call in enumerate((first, second, third)):
        tail = [k for k, _ in call]
        tail = tail[tail.index("capture_end") + 1:] if n == 0 else tail
        assert tail.count("h2d") == 4 and tail.count("replay") == 1
        assert "launch" not in tail and "copy" not in tail
        assert max(i for i, k in enumerate(tail) if k == "h2d") < (
            tail.index("replay"))
        assert tail[-4:] == ["wait"] * 4
        assert [d for k, d in call if k == "h2d"] == [True] * 4
    # from the second call on, each card's copy waits for its last clone
    assert [d for k, d in second if k == "stream_wait"][0] == (
        "cuda:0", True, "cuda:0")
    assert len(runner._replays) == 1
    rep = runner._replays[9]
    assert rep.launches == 8
    # a result is a clone, not the graph's own output
    for out in outs:
        assert all(y is not o for row, orow in zip(out, rep.outputs)
                   for y, o in zip(row, orow))


@pytest.mark.parametrize("case", ["pageable", "edge", "no_peer"])
def test_what_cannot_replay_runs_the_chunks(case, monkeypatch):
    runner = _runner((40, 48), devices=CARDS,
                     overlap="edge" if case == "edge" else "off")
    host = runner.host_tiles(_img((40, 48), 3))
    card = _GraphCard(monkeypatch, peer=case != "no_peer")
    if case == "pageable":
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: False)
    assert not runner._replayable(host)
    runner.run_host(host, 9)
    kinds = card.kinds()
    assert "capture_begin" not in kinds and "replay" not in kinds
    assert kinds.count("copy") == 4 and kinds.count("launch") >= 8


def test_a_grid_on_the_cpu_runs_the_chunks():
    runner = _runner((40, 48))
    assert not runner._replayable(runner.host_tiles(_img((40, 48), 3)))


def test_the_copies_are_waited_for_when_the_replay_raises(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    card = _GraphCard(monkeypatch)
    runner.run_host(host, 9)  # the capture

    def refused(self):
        raise RuntimeError("replay refused")

    monkeypatch.setattr(type(runner._replays[9].graph), "replay", refused)
    with pytest.raises(RuntimeError, match="refused"):
        runner.run_host(host, 9)
    assert card.kinds()[-4:] == ["wait"] * 4


def test_a_profiled_call_runs_the_chunks_with_their_spans(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    card = _GraphCard(monkeypatch)
    runner.run_host(host, 9)  # the capture
    card.log.clear()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert not runner._replayable(host)
        runner.run_host(host, 9)
    cap = Capture(t0, time.time_ns(), [], [])
    kinds = card.kinds()
    assert "replay" not in kinds and "capture_begin" not in kinds
    assert kinds.count("launch") == 8
    (place,) = _spans("sharded.place")
    assert place.args == {"bytes": 40 * 48, "cards": 4}
    assert [s.args["reps"] for s in _spans("sharded.issue")] == [8, 1]
    assert len(_spans("sharded.exchange")) == 4
    assert spec.reader("exchange_ms.mpx")(_ctx(cap, done=1)) > 0
    # and the next call, untraced, replays again
    card.log.clear()
    runner.run_host(host, 9)
    assert card.kinds().count("replay") == 1


# ---------------------------------------------------------------------------
# The cell on the CPU
# ---------------------------------------------------------------------------


def _run(devices, trace=False):
    return bcell.run_cell(CELL, 2 ** 31 + 41, 0.3, trace, devices,
                          time.perf_counter(), config_override=SMALL)


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 4],
                         ids=["one_device", "four_devices"])
def test_the_cell_is_correct_at_a_small_size(devices):
    out = _run(devices)
    assert out.correct, out.checks
    assert out.checks["mismatched_bytes"]["value"] == 0
    assert out.checks["outputs_compared"]["value"] >= 1
    assert out.checks["missing_outputs"]["value"] == 0
    assert set(out.metrics) == {"setup_s", "mpx_per_s"}
    assert out.metrics["mpx_per_s"]["value"] > 0


def _zero_ghosts(tiles, g, dims=(0, 1), boundary="zero", peers=None):
    # the exchange left out: every ghost band zero
    def pad(t):
        spec_ = (g, g, g, g) if t.dim() == 2 else (0, 0, g, g, g, g)
        return torch.nn.functional.pad(t, spec_)
    return [[pad(t) for t in row] for row in tiles]


def _first_tile_unchanged(mp):
    real = cs.valid_fused

    def fused(ext2, plan, fuse, channels, row0, col0, *a, **k):
        if row0 == 0 and col0 == 0:
            g = fuse * plan.halo
            return ext2[g:-g, g * channels:-g * channels].clone()
        return real(ext2, plan, fuse, channels, row0, col0, *a, **k)

    mp.setattr(cs, "valid_fused", fused)


FAULTS = {
    "exchange_left_out": lambda mp: mp.setattr(sharded, "halo_exchange",
                                               _zero_ghosts),
    "one_tile_unchanged": _first_tile_unchanged,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_mesh_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(["cpu"] * 4)
    assert not out.correct
    assert out.checks["mismatched_bytes"]["value"] > 0


def test_the_kind_runs_the_clis_default_overlap():
    from benchmark.kinds import mesh
    from tpu_stencil_torch.config import JobConfig

    assert mesh.overlap_default() == JobConfig.__dataclass_fields__[
        "overlap"].default


def test_the_kept_tiles_stitch_to_the_image():
    from benchmark.kinds import mesh

    runner = _runner((37, 29))
    img = _img((37, 29), 9)
    kept = mesh.Tiles(runner.host_tiles(img), img.shape)
    np.testing.assert_array_equal(np.asarray(kept), img)


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------


def test_the_spans_open_nest_and_carry_their_args():
    runner = _runner((40, 48))
    host = runner.host_tiles(_img((40, 48), 1))
    runner.run_host(host, 9)  # no profiler: no span
    assert tracing.profiled_spans(0, 1 << 62) == []
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run_host(host, 9)
    (place,) = _spans("sharded.place")
    assert place.args == {"bytes": 40 * 48, "cards": 1}
    exchanges, issues = _spans("sharded.exchange"), _spans("sharded.issue")
    # chunks of 8 and 1 reps: two phases and one issue each
    assert [(s.args["depth"], s.args["axis"]) for s in exchanges] == [
        (8, "rows"), (8, "cols"), (1, "rows"), (1, "cols")]
    th, tw = 20, 24
    for s in exchanges:
        g = s.args["depth"]
        strip = g * tw if s.args["axis"] == "rows" else (th + 2 * g) * g
        assert (s.args["strips"], s.args["peer_strips"], s.args["bytes"]) \
            == (4, 0, 4 * strip)
    assert [s.args for s in issues] == [
        {"kernel": "pallas", "reps": 8, "launches": 0},
        {"kernel": "pallas", "reps": 1, "launches": 0}]
    for s in exchanges + issues:
        assert place.start_ns <= s.start_ns <= s.end_ns <= place.end_ns
        assert s.depth == place.depth + 1 and s.tid == place.tid
    # the phases of a chunk come before its launches
    assert exchanges[1].end_ns <= issues[0].start_ns
    assert issues[0].end_ns <= exchanges[2].start_ns


def test_the_issue_span_counts_k3s_launches(monkeypatch):
    runner = _runner((40, 48), devices=CARDS)
    host = runner.host_tiles(_img((40, 48), 3))
    _Card(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run_host(host, 9)
    assert [s.args for s in _spans("sharded.issue")] == [
        {"kernel": "stencil_valid", "reps": 8, "launches": 4},
        {"kernel": "stencil_valid", "reps": 1, "launches": 4}]
    (place,) = _spans("sharded.place")
    assert place.args == {"bytes": 40 * 48, "cards": 4}
    assert [s.args["strips"] for s in _spans("sharded.exchange")] == [4] * 4


def test_the_edge_schedule_spans_each_move_inside_its_chunk():
    runner = _runner((40, 48), overlap="edge")
    assert runner.overlap == "edge" and runner.fuse == 8
    host = runner.host_tiles(_img((40, 48), 2))
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run_host(host, 9)
    issues = _spans("sharded.issue")
    assert [s.args["reps"] for s in issues] == [8, 1]
    moves = _spans("sharded.exchange")
    assert [s.args["edge"] for s in moves] == [
        "n", "s", "w", "e", "corners"] * 2
    assert [s.args["strips"] for s in moves] == [2, 2, 2, 2, 4] * 2
    for s in moves[:5]:
        assert issues[0].start_ns <= s.start_ns <= s.end_ns <= (
            issues[0].end_ns)
        assert s.depth == issues[0].depth + 1


def test_exchange_counts_move_by_the_strips_of_each_chunk():
    runner = _runner((40, 48, 3))
    tiles = runner.put(_img((40, 48, 3), 4))
    assert halo.exchange_counts() == {"phases": 0, "strips": 0,
                                      "peer_strips": 0, "peer_bytes": 0}
    runner.run(tiles, 100)  # 12 chunks of 8 and 4 single-rep tails
    chunks = len(cs.launch_schedule(100, runner.fuse))
    assert chunks == 16
    assert halo.exchange_counts() == {"phases": 2 * chunks,
                                      "strips": 8 * chunks,
                                      "peer_strips": 0, "peer_bytes": 0}
    halo.reset_exchange_counts()
    edge = _runner((40, 48, 3), overlap="edge")
    edge.run(edge.put(_img((40, 48, 3), 4)), 9)
    assert halo.exchange_counts() == {"phases": 10, "strips": 24,
                                      "peer_strips": 0, "peer_bytes": 0}


def test_a_tally_counts_the_strips_that_cross_devices():
    t = halo.Tally()
    t.add(torch.zeros((3, 5), dtype=torch.uint8), False)
    t.add(torch.zeros((2, 4, 3), dtype=torch.uint8), True)
    span = types.SimpleNamespace(recording=True, args={})
    t.close(span)
    assert span.args == {"strips": 2, "peer_strips": 1, "bytes": 39}
    assert halo.exchange_counts() == {"phases": 1, "strips": 2,
                                      "peer_strips": 1, "peer_bytes": 24}


def test_exchange_counts_hold_under_several_threads():
    runner = _runner((40, 48))
    tiles = runner.put(_img((40, 48), 6))

    def work():
        for _ in range(5):
            runner.run(tiles, 9)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert halo.exchange_counts()["strips"] == 4 * 5 * 2 * 8


# ---------------------------------------------------------------------------
# The spec and the readers
# ---------------------------------------------------------------------------


def test_the_spec_gives_the_mesh_cell_its_metrics():
    assert [m["name"] for m in spec.end_to_end_for(BENCH, CELL)] == [
        "setup_s", "mpx_per_s"]
    assert [m["name"] for m in spec.per_layer_for(BENCH, CELL)] == (
        CELL_METRICS)
    for cell in JOB_CELLS[:2]:
        assert [m["name"] for m in spec.per_layer_for(BENCH, cell)] == (
            JOB_METRICS)
    assert [m["name"] for m in spec.per_layer_for(BENCH, JOB_CELLS[2])] == (
        JOB_METRICS + ["direct_rep_us.mpx"])
    w = spec.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "mesh.r100", 4)
    traffic = spec.traffic("mesh.r100")
    assert (traffic["kind"], traffic["reps"], traffic["ring"],
            traffic["chips"]) == ("mesh", 100, 4, 4)
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) == 1


def _ctx(capture, done=5):
    return spec.MetricContext(env=None,
                              window=types.SimpleNamespace(done=done),
                              capture=capture, chips=4)


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_new_reader_reads_nothing_without_a_capture(name):
    assert spec.reader(name)(_ctx(None)) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_new_reader_reads_nothing_without_the_sink(name):
    # a capture with no copy between cards and no span of the program
    cap = Capture(0, 10_000, [DeviceOp("stencil_valid_kernel", 0, 0, 100),
                              DeviceOp("Memcpy HtoD (Pinned -> Device)", 0,
                                       100, 200)], [])
    assert spec.reader(name)(_ctx(cap)) is None


COPY_KERNEL = ("void at::native::elementwise_kernel<128, 4, at::native::"
               "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
               "at::TensorIteratorBase&)::{lambda()#3}")
CAT_KERNEL = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy"
              "_contig<at::native::(anonymous namespace)::OpaqueType<1u>")


def test_halo_ms_sums_the_copies_between_cards():
    ops = [DeviceOp("Memcpy PtoP (Device -> Device)", 0, 0, 3_000_000),
           DeviceOp("Memcpy PtoP (Device -> Device)", 1, 0, 2_000_000),
           DeviceOp("Memcpy DtoD (Device -> Device)", 2, 0, 1_000_000),
           DeviceOp(COPY_KERNEL, 2, 0, 2_000_000),
           DeviceOp(CAT_KERNEL, 1, 0, 5_000_000),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", 3, 0, 9_000_000),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", 3, 0, 9_000_000),
           DeviceOp("stencil_valid_kernel", 3, 0, 9_000_000)]
    cap = Capture(0, 10_000_000, ops, [])
    assert spec.reader("halo_ms.mpx")(_ctx(cap, done=2)) == \
        pytest.approx(4.0)


def _span(name, start, end, depth=0, tid=None):
    return tracing.ProfiledSpan(
        name, "sharded", threading.get_native_id() if tid is None else tid,
        depth, {}, start, end)


def test_the_per_card_alignment_recovers_each_cards_offset():
    # two jobs; card 0's clock runs 1000 ns behind the host's, card 1's
    # 3000 ns ahead: each card's first copy fills its place span, so its
    # offset is pinned there, and the second leaves room around it
    offsets = {0: 1000, 1: -3000}
    places = [_span("sharded.place", 10_000, 20_000),
              _span("sharded.place", 50_000, 70_000)]
    ops = []
    for dev, off in offsets.items():
        ops.append(DeviceOp("Memcpy HtoD (Pinned -> Device)", dev,
                            10_000 - off, 20_000 - off))
        ops.append(DeviceOp("stencil_valid_kernel", dev, 21_000 - off,
                            30_000 - off))
        ops.append(DeviceOp("Memcpy HtoD (Pinned -> Device)", dev,
                            52_000 - off, 55_000 - off))
        ops.append(DeviceOp("stencil_valid_kernel", dev, 56_000 - off,
                            60_000 - off))
    cap = Capture(0, 100_000, ops, [])
    got = mesh_spans.aligned(cap, places)
    assert got is not None
    moved = sorted((op.device, op.start_ns, op.end_ns) for op in got.ops)
    assert moved == sorted((dev, s, e) for dev in offsets
                           for s, e in ((10_000, 20_000), (21_000, 30_000),
                                        (52_000, 55_000), (56_000, 60_000)))
    # the job path's alignment, over both cards together, cannot pair them
    assert ps.aligned(cap, [_span("model.place", p.start_ns, p.end_ns)
                            for p in places]) is None
    # idle under the spans, on the host's clock: none in the first place
    # span (its copy fills it), 2k + 1k + 10k ns of the second on each card
    assert ps.idle_pct_under(got, places, 2, lambda n: True) == (
        pytest.approx(100.0 * 13_000 / 100_000))


def test_the_per_card_alignment_refuses_what_does_not_pair():
    places = [_span("sharded.place", 10_000, 20_000)]
    copies = [DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 11_000, 12_000),
              DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 13_000, 14_000),
              DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 15_000, 16_000)]
    # three copies on one card against one place (one card named three
    # times in the mesh): no tie
    assert mesh_spans.aligned(Capture(0, 30_000, copies, []), places) is None
    # a copy that ends before its place begins, whatever the offset
    late = [DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 0, 15_000)]
    assert mesh_spans.aligned(Capture(0, 30_000, late, []), places) is None
    # another thread's spans do not tie this thread's copies
    other = [_span("sharded.place", 10_000, 20_000, tid=-1)]
    assert mesh_spans.aligned(Capture(0, 30_000, copies[:1], []),
                              other) is None
