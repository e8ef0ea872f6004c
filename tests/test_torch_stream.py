"""The port's streaming engine against the JAX package's.

The same seeded clip goes through the JAX package's ``run_stream`` (and
its ``stream`` CLI) on the CPU and through the port's on ``--platform
cpu`` (the kernels' plain versions under ``--backend pallas``, torch ops
under ``xla``): every output byte must be equal, for gaussian, box and
edge, grey and RGB, zero and periodic boundaries, depths 1, 2 and 4, and
reps 0, 1, fuse-1 and fuse+1. These are integer plans: the tolerance is
exact. Then the engine's own contracts, mirroring ``tests/test_stream.py``
(sources and sinks, failure with the frame index, resume and the
checkpoint sidecar in the JAX package's format, the pipeline ladder in the
trace, the CLI), the ingest CRC32C (the built library against the
pure-Python table and the JAX package), the torn staging buffer, the
witness, the engine restart, and the sharded and pipelined engines running
where they once failed loudly.

No assertion here reads a wall clock: the throughput claim is measured on
the card (``chip_smoke.py`` phase ``stream_path``). Every run of the port,
every feeder thread and every queue wait has a deadline, so a hung
pipeline fails its test.
"""

import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_stencil import config as jconfig
from tpu_stencil.integrity import checksum as jchecksum
from tpu_stencil.runtime import checkpoint as jckpt
from tpu_stencil.stream import cli as jstream_cli
from tpu_stencil.stream import engine as jengine
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs
from tpu_stencil_torch.integrity import checksum
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.resilience import faults as tfaults
from tpu_stencil_torch.runtime import checkpoint as ckpt
from tpu_stencil_torch.runtime import roofline
from tpu_stencil_torch.stream import cli as stream_cli
from tpu_stencil_torch.stream import engine as stream_engine
from tpu_stencil_torch.stream import frames as frames_io
from tpu_stencil_torch.stream.engine import StreamFailure

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DEADLINE = 120.0  # seconds any one run of the port may take here


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_STENCIL_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    tfaults.clear()
    obs.reset()
    yield
    tfaults.reset()
    obs.reset()


def _bounded(fn, *args, timeout: float = DEADLINE, **kw):
    """``fn(*args, **kw)`` on a daemon thread, joined within ``timeout``:
    a hung pipeline fails the test instead of hanging the suite."""
    box = queue.Queue()

    def run():
        try:
            box.put(("ok", fn(*args, **kw)))
        except BaseException as e:  # re-raised on the test's thread
            box.put(("err", e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        kind, value = box.get(timeout=timeout)
    except queue.Empty:
        pytest.fail(f"{getattr(fn, '__name__', fn)} did not finish within "
                    f"{timeout} s")
    if kind == "err":
        raise value
    return value


def _make_clip(path, n, h, w, ch, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, h, w) if ch == 1 else (n, h, w, ch)
    clip = rng.integers(0, 256, size=shape, dtype=np.uint8)
    clip.tofile(path)
    return clip


def _jax_stream(clip_path, h, w, image_type, reps, out, **kw):
    """The JAX package's stream of the clip; returns the output bytes."""
    cfg = jconfig.StreamConfig(
        input=str(clip_path), width=w, height=h, repetitions=reps,
        image_type=jconfig.ImageType(image_type.value), output=out, **kw)
    jengine.run_stream(cfg)
    return open(out, "rb").read()


def _port_cfg(clip_path, h, w, image_type, reps, **kw):
    return tconfig.StreamConfig(
        input=str(clip_path), width=w, height=h, repetitions=reps,
        image_type=image_type, **kw)


def _port_stream(cfg, devices=(CPU,), **kw):
    return _bounded(stream_engine.run_stream, cfg, devices=list(devices),
                    **kw)


def _golden_frames(tmp_path, clip, reps, image_type, **job_kw):
    """Each frame through the port's own run_job on the CPU."""
    h, w = clip.shape[1:3]
    out = []
    for i in range(clip.shape[0]):
        src = str(tmp_path / f"golden_in_{i}.raw")
        dst = str(tmp_path / f"golden_out_{i}.raw")
        clip[i].tofile(src)
        tdriver.run_job(tconfig.JobConfig(
            image=src, width=w, height=h, repetitions=reps,
            image_type=image_type, output=dst, **job_kw), devices=[CPU])
        out.append(open(dst, "rb").read())
    return out


class _SlowSource(frames_io.FrameSource):
    """Injected per-frame read latency: a disk- or network-shaped source."""

    def __init__(self, inner, delay_s):
        self.inner, self.delay_s = inner, delay_s

    def read_into(self, buf):
        time.sleep(self.delay_s)
        return self.inner.read_into(buf)

    def skip(self, n):
        self.inner.skip(n)

    def close(self):
        self.inner.close()


class _FailingSink(frames_io.FrameSink):
    def __init__(self, fail_at):
        self.fail_at = fail_at
        self.written = []

    def write(self, index, frame):
        if index == self.fail_at:
            raise IOError("disk full (injected)")
        self.written.append(index)


# -- the port against the JAX package, byte for byte -----------------------

FUSE = cs.DEFAULT_FUSE
MATRIX = [
    (filt, itype, boundary, depth, reps)
    for filt in ("gaussian", "box", "edge")
    for itype in (tconfig.ImageType.GREY, tconfig.ImageType.RGB)
    for boundary in ("zero", "periodic")
    for depth, reps in ((1, 0), (2, 1), (4, FUSE - 1), (2, FUSE + 1))
]


@pytest.mark.parametrize("filt,image_type,boundary,depth,reps", MATRIX)
def test_stream_matches_jax(tmp_path, filt, image_type, boundary, depth,
                            reps):
    h, w, n = 18, 14, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, image_type.channels, seed=depth + reps)
    want = _jax_stream(clip_path, h, w, image_type, reps,
                       str(tmp_path / "jax.raw"), frames=n,
                       filter_name=filt, boundary=boundary,
                       pipeline_depth=depth)
    out = str(tmp_path / "port.raw")
    res = _port_stream(_port_cfg(
        clip_path, h, w, image_type, reps, output=out, frames=n,
        filter_name=filt, boundary=boundary, pipeline_depth=depth,
        backend="pallas"))
    assert res.frames == n and res.n_devices == 1
    assert open(out, "rb").read() == want
    # The kernels' plain versions ran on the zero boundary; periodic
    # runs torch ops, as in the JAX package.
    assert res.backend == ("pallas" if boundary == "zero" else "xla")


@pytest.mark.parametrize("schedule,backend,ring", [
    ("deep", "pallas", None), (None, "xla", 5), (None, "torch", None),
    (None, "cuda", 3), (None, "auto", None),
])
def test_stream_schedules_and_backends_match_jax(tmp_path, schedule,
                                                 backend, ring):
    h, w, n, reps = 20, 16, 4, 11
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=3)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    out = str(tmp_path / "port.raw")
    res = _port_stream(_port_cfg(
        clip_path, h, w, tconfig.ImageType.RGB, reps, output=out, frames=n,
        backend=backend, schedule=schedule, ring_buffers=ring))
    assert open(out, "rb").read() == want
    if schedule == "deep":
        assert res.schedule == "deep"


@pytest.mark.parametrize("image_type,boundary,depth,fuse", [
    (tconfig.ImageType.RGB, "zero", 2, None),
    (tconfig.ImageType.GREY, "zero", 1, None),
    (tconfig.ImageType.RGB, "periodic", 4, None),
    (tconfig.ImageType.GREY, "periodic", 2, 2),
    (tconfig.ImageType.RGB, "zero", 3, 1),
])
def test_stream_matches_run_job(tmp_path, image_type, boundary, depth, fuse):
    h, w, ch, reps, n = 20, 16, image_type.channels, 3, 4
    clip_path = tmp_path / "clip.raw"
    clip = _make_clip(clip_path, n, h, w, ch, seed=depth)
    golden = _golden_frames(tmp_path, clip, reps, image_type,
                            boundary=boundary, fuse=fuse)
    out = str(tmp_path / "out.raw")
    res = _port_stream(_port_cfg(
        clip_path, h, w, image_type, reps, output=out, frames=n,
        pipeline_depth=depth, boundary=boundary, fuse=fuse))
    assert res.frames == n
    blob = open(out, "rb").read()
    fb = h * w * ch
    for i in range(n):
        assert blob[i * fb:(i + 1) * fb] == golden[i], f"frame {i} differs"


def test_stream_fifo_source_and_directory_sink(tmp_path):
    # Frames through a FIFO (no size, no seek), results as per-frame
    # files, each equal to the JAX package's stream of the same clip.
    h, w, ch, reps, n = 12, 10, 3, 2, 3
    clip_path = tmp_path / "clip.raw"
    clip = _make_clip(clip_path, n, h, w, ch, seed=9)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    fifo = str(tmp_path / "feed.fifo")
    os.mkfifo(fifo)

    def feed():
        with open(fifo, "wb") as f:
            f.write(clip.tobytes())

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    sink_dir = str(tmp_path / "out_frames") + os.sep
    res = _port_stream(tconfig.StreamConfig(
        input=fifo, width=w, height=h, repetitions=reps,
        image_type=tconfig.ImageType.RGB, output=sink_dir, frames=None))
    t.join(10)
    assert not t.is_alive()
    assert res.frames == n
    fb = h * w * ch
    for i in range(n):
        name = os.path.join(sink_dir.rstrip(os.sep),
                            frames_io.FRAME_PATTERN.format(i))
        assert open(name, "rb").read() == want[i * fb:(i + 1) * fb]


def test_directory_source_matches_jax(tmp_path):
    h, w, n, reps = 8, 6, 3, 2
    d = tmp_path / "frames_in"
    d.mkdir()
    clip = _make_clip(tmp_path / "clip.raw", n, h, w, 1, seed=3)
    for i in range(n):
        clip[i].tofile(str(d / f"{i:04d}.raw"))
    src = frames_io.open_source(str(d), h * w)
    assert isinstance(src, frames_io.RawDirectorySource) and len(src) == n
    buf = np.empty(h * w, np.uint8)
    got = []
    while src.read_into(buf):
        got.append(buf.copy())
    assert [g.tobytes() for g in got] == [c.tobytes() for c in clip]
    want = _jax_stream(str(d), h, w, tconfig.ImageType.GREY, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    out = str(tmp_path / "port.raw")
    _port_stream(_port_cfg(str(d), h, w, tconfig.ImageType.GREY, reps,
                           output=out, frames=n))
    assert open(out, "rb").read() == want


def test_directory_source_wrong_size_fails_loudly(tmp_path):
    d = tmp_path / "frames_in"
    d.mkdir()
    (d / "0000.raw").write_bytes(b"\x00" * 10)
    src = frames_io.open_source(str(d), 48)
    with pytest.raises(IOError, match="10 bytes"):
        src.read_into(np.empty(48, np.uint8))


def test_null_sink_and_stream_sink_specs(tmp_path):
    assert isinstance(frames_io.open_sink("null", 4), frames_io.NullSink)
    p = str(tmp_path / "o.raw")
    s = frames_io.open_sink(p, 4)
    assert isinstance(s, frames_io.RawStreamSink)
    s.close()
    assert not frames_io.is_resumable_sink("null")
    assert not frames_io.is_resumable_sink("-")
    assert frames_io.is_resumable_sink(p)
    assert frames_io.is_resumable_sink(str(tmp_path) + os.sep)
    assert frames_io.is_restartable_source(p)
    assert not frames_io.is_restartable_source("-")


def test_read_into_fills_a_pinnable_slot_in_place(tmp_path):
    # The engine's ring slot is a host tensor and read_into fills a numpy
    # view of it: the bytes land in the tensor, no copy in between.
    p = tmp_path / "two.raw"
    p.write_bytes(bytes(range(8)))
    slot = torch.zeros(4, dtype=torch.uint8)
    view = slot.numpy()
    src = frames_io.RawStreamSource(str(p), 4)
    assert src.read_into(view) and slot.tolist() == [0, 1, 2, 3]
    assert src.read_into(view) and slot.tolist() == [4, 5, 6, 7]
    assert not src.read_into(view)


def test_source_short_final_frame_fails_with_index(tmp_path):
    p = str(tmp_path / "short.raw")
    with open(p, "wb") as f:
        f.write(b"\x01" * 10)  # 2.5 frames of 4 bytes
    src = frames_io.RawStreamSource(p, 4)
    buf = np.empty(4, np.uint8)
    assert src.read_into(buf) and src.read_into(buf)
    with pytest.raises(IOError, match="frame 2"):
        src.read_into(buf)


# -- failure / EOF semantics ---------------------------------------------

def test_eof_before_promised_frames_fails_with_index(tmp_path):
    h, w = 8, 6
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, h, w, 1)
    with pytest.raises(StreamFailure) as ei:
        _port_stream(_port_cfg(clip_path, h, w, tconfig.ImageType.GREY, 1,
                               frames=5, output=str(tmp_path / "o.raw")))
    assert ei.value.stage == "read"
    assert ei.value.frame_index == 2
    assert "--frames promised 5" in str(ei.value.__cause__)


def test_failing_sink_fails_job_with_frame_index(tmp_path):
    h, w, n = 8, 6, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1)
    sink = _FailingSink(fail_at=2)
    with pytest.raises(StreamFailure) as ei:
        _port_stream(_port_cfg(clip_path, h, w, tconfig.ImageType.GREY, 1,
                               frames=n), sink=sink)
    assert ei.value.stage == "write"
    assert ei.value.frame_index == 2
    assert sink.written == [0, 1]  # earlier frames drained and landed
    # Aborted frames never release their window slot; the teardown still
    # zeroes the gauge.
    assert obs.snapshot()["gauges"]["stream_inflight_depth"]["value"] == 0


def test_failure_with_reader_parked_on_silent_pipe(tmp_path):
    # A sink failure while the reader is blocked in read() on a FIFO that
    # never delivers another byte: the teardown must not wait on the
    # parked reader, and the failure is the sink's.
    h, w = 10, 8
    clip = np.random.default_rng(5).integers(0, 256, (1, h, w, 3), np.uint8)
    fifo = str(tmp_path / "silent.fifo")
    os.mkfifo(fifo)
    holder = {}

    def feed_one_then_hang():
        holder["fd"] = os.open(fifo, os.O_WRONLY)
        os.write(holder["fd"], clip.tobytes())  # then silence, no EOF

    t = threading.Thread(target=feed_one_then_hang, daemon=True)
    t.start()
    cfg = tconfig.StreamConfig(fifo, w, h, 1, tconfig.ImageType.RGB,
                               output="null", frames=4)
    try:
        with pytest.raises(StreamFailure) as ei:
            _port_stream(cfg, sink=_FailingSink(fail_at=0))
        assert ei.value.stage == "write"
        assert ei.value.frame_index == 0
    finally:
        if "fd" in holder:
            os.close(holder["fd"])
        t.join(10)


def test_zero_frame_stream_is_clean(tmp_path):
    p = tmp_path / "empty.raw"
    p.write_bytes(b"")
    res = _port_stream(_port_cfg(p, 8, 6, tconfig.ImageType.GREY, 1,
                                 frames=None,
                                 output=str(tmp_path / "o.raw")))
    assert res.frames == 0
    assert res.frames_per_second == 0.0


# -- resume and the sidecar ------------------------------------------------

def test_stream_resume_skips_completed_frames(tmp_path):
    h, w, ch, reps, n = 10, 8, 3, 2, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch)
    out_full = str(tmp_path / "full.raw")
    _port_stream(_port_cfg(clip_path, h, w, tconfig.ImageType.RGB, reps,
                           output=out_full, frames=n))
    out_resumed = str(tmp_path / "resumed.raw")
    cfg = _port_cfg(clip_path, h, w, tconfig.ImageType.RGB, reps,
                    output=out_resumed, frames=n, checkpoint_every=1)
    fb = h * w * ch
    with open(out_resumed, "wb") as f:
        f.write(open(out_full, "rb").read()[:2 * fb])
    ckpt.save_stream_progress(cfg, 2)
    res = _port_stream(cfg, resume=True)
    assert res.skipped == 2
    assert res.frames == n - 2
    assert open(out_resumed, "rb").read() == open(out_full, "rb").read()
    assert ckpt.restore_stream_progress(cfg) is None  # swept


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stream_sidecar_is_the_jax_packages(tmp_path, writer):
    # One on-disk format: a sidecar either package writes resumes in the
    # other, and both write the same JSON.
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 3, 8, 6, 1)
    out = str(tmp_path / "o.raw")
    tcfg = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 2, frames=3,
                     output=out)
    jcfg = jconfig.StreamConfig(str(clip_path), 6, 8, 2,
                                jconfig.ImageType.GREY, frames=3, output=out)
    side = out + ".stream.ckpt.json"
    if writer == "port":
        ckpt.save_stream_progress(tcfg, 2, mesh_devices=2, cursors=[2, 3])
        assert jckpt.restore_stream_progress(jcfg, mesh_devices=2) == 2
    else:
        jckpt.save_stream_progress(jcfg, 2, mesh_devices=2, cursors=[2, 3])
        assert ckpt.restore_stream_progress(tcfg, mesh_devices=2) == 2
    mine = json.load(open(side))
    jckpt.save_stream_progress(jcfg, 2, mesh_devices=2, cursors=[2, 3])
    assert json.load(open(side)) == mine
    with pytest.raises(ckpt.MeshCursorMismatch):
        ckpt.restore_stream_progress(tcfg, mesh_devices=1)


def test_stream_checkpoint_refuses_other_job(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    out = str(tmp_path / "o.raw")
    cfg = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 2, frames=2,
                    output=out)
    ckpt.save_stream_progress(cfg, 1)
    other = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 3, frames=2,
                      output=out)
    with pytest.raises(ValueError, match="different job"):
        ckpt.restore_stream_progress(other)
    ckpt.clear_stream_progress(cfg)


def test_stream_checkpoint_corrupt_sidecar_refused(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    out = str(tmp_path / "o.raw")
    cfg = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 2, frames=2,
                    output=out)
    ckpt.save_stream_progress(cfg, 1)
    side = out + ".stream.ckpt.json"
    text = open(side).read().replace('"frames_done": 1', '"frames_done": 2')
    open(side, "w").write(text)
    with pytest.raises(ckpt.CorruptCheckpoint, match="stream.ckpt.json"):
        ckpt.restore_stream_progress(cfg)


def test_checkpoint_needs_resumable_sink(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    with pytest.raises(ValueError, match="resumable sink"):
        _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                               output="null", frames=2, checkpoint_every=1))


def test_stream_checkpoint_sidecar_normalizes_dir_spelling(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    d = str(tmp_path / "outdir")
    cfg_slash = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                          output=d + os.sep, frames=2)
    cfg_plain = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                          output=d, frames=2)
    ckpt.save_stream_progress(cfg_slash, 1)
    assert ckpt.restore_stream_progress(cfg_plain) == 1
    ckpt.clear_stream_progress(cfg_plain)
    assert ckpt.restore_stream_progress(cfg_slash) is None


@pytest.mark.chaos
def test_engine_restart_from_checkpoint_after_compute_fault(tmp_path):
    h, w, ch, reps, n = 12, 10, 3, 2, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=4)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    out = str(tmp_path / "out.raw")
    tfaults.configure("compute:frame=3")
    res = _port_stream(_port_cfg(clip_path, h, w, tconfig.ImageType.RGB,
                                 reps, output=out, frames=n,
                                 checkpoint_every=1, backend="pallas"))
    assert res.restarts == 1 and res.skipped > 0
    assert open(out, "rb").read() == want
    snap = obs.snapshot()["counters"]
    assert snap["resilience_stream_restarts_total"] == 1


@pytest.mark.chaos
def test_compute_fault_without_checkpoint_fails_with_index(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 4, 8, 6, 1)
    tfaults.configure("compute:frame=2")
    with pytest.raises(StreamFailure) as ei:
        _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                               output=str(tmp_path / "o.raw"), frames=4))
    assert ei.value.stage == "compute" and ei.value.frame_index == 2


# -- the pipeline ladder in the trace --------------------------------------

def _spans_by_frame(tracer, name):
    return {r.args.get("frame"): r for r in tracer.spans() if r.name == name}


def test_depth2_trace_shows_pipeline_overlap(tmp_path):
    # At depth 2 frame i+1's read and h2d overlap frame i's compute: a
    # slow source (4 ms a frame) and a compute stage that outlasts it.
    h, w, n, reps = 128, 112, 4, 200
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1)
    cfg = _port_cfg(clip_path, h, w, tconfig.ImageType.GREY, reps,
                    output="null", frames=n, pipeline_depth=2)
    src = _SlowSource(
        frames_io.RawStreamSource(str(clip_path), cfg.frame_bytes), 0.004)
    tracer = obs.enable()
    try:
        _port_stream(cfg, source=src)
    finally:
        obs.disable()
    reads = _spans_by_frame(tracer, "stream.read")
    h2ds = _spans_by_frame(tracer, "stream.h2d")
    computes = _spans_by_frame(tracer, "stream.compute")
    assert set(reads) == set(range(n))
    assert set(computes) == set(range(n))

    def overlaps(a, b):
        return a is not None and b is not None and a.t0 < b.t1 and a.t1 > b.t0

    assert any(overlaps(reads.get(i + 1), computes.get(i))
               for i in range(n - 1))
    assert any(overlaps(h2ds.get(i + 1), computes.get(i))
               for i in range(n - 1))
    snap = obs.snapshot()
    assert snap["gauges"]["stream_inflight_depth"]["peak"] == 2
    assert snap["counters"]["stream_frames_total"] >= n
    assert snap["histograms"]["stream_compute_seconds"]["count"] == n


def test_depth1_serializes_stages(tmp_path):
    h, w, n, reps = 48, 40, 3, 30
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1)
    cfg = _port_cfg(clip_path, h, w, tconfig.ImageType.GREY, reps,
                    output="null", frames=n, pipeline_depth=1)
    tracer = obs.enable()
    try:
        _port_stream(cfg)
    finally:
        obs.disable()
    reads = _spans_by_frame(tracer, "stream.read")
    d2hs = _spans_by_frame(tracer, "stream.d2h")
    for i in range(n - 1):
        assert reads[i + 1].t0 >= d2hs[i].t1
    assert obs.snapshot()["gauges"]["stream_inflight_depth"]["peak"] == 1


def test_stream_spans_carry_the_frame_trace_id(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    tracer = obs.enable()
    try:
        _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                               output="null", frames=2))
    finally:
        obs.disable()
    writes = _spans_by_frame(tracer, "stream.write")
    assert {r.trace_id for r in writes.values()} == {"frame-0", "frame-1"}


# -- integrity: the CRC32C, the torn buffer, the witness -------------------

def test_crc32c_check_value_and_pure_python_oracle():
    assert checksum.crc32c(b"123456789") == 0xE3069283
    assert checksum._crc32c_py(b"123456789") == 0xE3069283
    big = b"123456789" * 1000  # over the native threshold
    assert checksum.crc32c(big) == checksum._crc32c_py(big)
    half = checksum.crc32c(big[:5000])
    assert checksum.crc32c(big[5000:], half) == checksum._crc32c_py(big)


@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4096, 4097, 24575, 24576,
                               24577, 3 * 8192 * 3 + 17, 200_003])
def test_native_crc32c_equals_the_table_and_the_jax_package(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n + 3, dtype=np.uint8)
    lib = checksum.native_library()
    for off in (0, 1, 3):  # unaligned starts
        view = data[off:off + n]
        want = checksum._crc32c_py(view.tobytes())
        assert checksum.crc32c(view) == want
        assert checksum.crc32c(view.tobytes()) == want
        assert jchecksum.crc32c(view.tobytes()) == want
        assert lib.crc32c_extend(0, view.ctypes.data, n) == want
        assert lib.crc32c_extend_portable(0, view.ctypes.data, n) == want


def test_native_crc32c_is_the_built_library(tmp_path):
    path = _build.library_path("crc32c")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert checksum.implementation() in ("sse4.2", "slicing-by-8")
    # A pinned slot's view, as the engine hands it: no copy is made.
    slot = torch.arange(256, dtype=torch.uint8).repeat(64)
    assert checksum.crc32c(slot.numpy()) == checksum._crc32c_py(
        slot.numpy().tobytes())


def test_failed_crc_build_fails_the_stream_typed(tmp_path, monkeypatch):
    # With verify_ingest on, a library that cannot be built fails the
    # stream with KernelBuildError before any frame; nothing falls back to
    # the byte loop. --no-verify-ingest needs no library.
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    monkeypatch.setattr(checksum, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "host_compiler", lambda: ["false"])
    cfg = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                    output=str(tmp_path / "o.raw"), frames=2)
    with pytest.raises(_build.KernelBuildError, match="crc32c"):
        _port_stream(cfg)
    with pytest.raises(_build.KernelBuildError):
        checksum.crc32c(np.zeros(checksum.NATIVE_MIN_BYTES, np.uint8))
    res = _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                                 output=str(tmp_path / "o.raw"), frames=2,
                                 verify_ingest=False))
    assert res.frames == 2
    rc = stream_cli.main([str(clip_path), "6", "8", "1", "grey",
                          "--frames", "2", "--platform", "cpu",
                          "--output", str(tmp_path / "o2.raw")])
    assert rc == 1


def test_stream_checksums_through_the_library_whatever_the_size(
        tmp_path, monkeypatch):
    # Frames below NATIVE_MIN_BYTES too: a verifying stream never takes
    # the byte loop.
    def loop(*a, **k):
        raise AssertionError("the pure-Python CRC ran on a stream")

    monkeypatch.setattr(checksum, "_crc32c_py", loop)
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 3, 8, 6, 1)
    assert 8 * 6 < checksum.NATIVE_MIN_BYTES
    res = _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                                 output=str(tmp_path / "o.raw"), frames=3))
    assert res.frames == 3
    assert obs.snapshot()["counters"]["integrity_ingest_verified_total"] == 3
    assert checksum.native_crc32c(b"123456789") == 0xE3069283


@pytest.mark.chaos
def test_torn_staging_buffer_fails_typed(tmp_path, capsys):
    h, w, n = 96, 64, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1)
    tfaults.configure("integrity.corrupt_ingest:frame=1")
    with pytest.raises(StreamFailure) as ei:
        _port_stream(_port_cfg(clip_path, h, w, tconfig.ImageType.GREY, 2,
                               output=str(tmp_path / "o.raw"), frames=n))
    assert ei.value.stage == "h2d" and ei.value.frame_index == 1
    assert isinstance(ei.value.__cause__, checksum.ChecksumMismatch)
    snap = obs.snapshot()["counters"]
    assert snap["integrity_ingest_failures_total"] == 1
    assert snap["integrity_ingest_verified_total"] == 1  # frame 0
    # Through the CLI: a non-zero exit naming the mismatch.
    tfaults.clear()
    rc = stream_cli.main([str(clip_path), str(w), str(h), "2", "grey",
                          "--frames", str(n), "--platform", "cpu",
                          "--output", str(tmp_path / "o2.raw"),
                          "--faults", "integrity.corrupt_ingest:frame=0"])
    assert rc == 1
    assert "ChecksumMismatch" in capsys.readouterr().err


@pytest.mark.chaos
def test_witness_catches_a_corrupt_result(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 3, 10, 8, 3)
    out = str(tmp_path / "o.raw")
    res = _port_stream(_port_cfg(clip_path, 10, 8, tconfig.ImageType.RGB, 3,
                                 output=out, frames=3, witness_rate=1.0,
                                 backend="pallas"))
    assert res.frames == 3
    assert obs.snapshot()["counters"]["integrity_witness_total"] == 3
    tfaults.configure("integrity.corrupt_result:frame=1")
    sink = _FailingSink(fail_at=99)
    with pytest.raises(StreamFailure) as ei:
        _port_stream(_port_cfg(clip_path, 10, 8, tconfig.ImageType.RGB, 3,
                               frames=3, witness_rate=1.0), sink=sink)
    assert ei.value.stage == "write" and ei.value.frame_index == 1
    assert isinstance(ei.value.__cause__, checksum.WitnessMismatch)
    assert sink.written == [0]  # the corrupt frame never reached the sink


def test_witness_is_off_past_its_rep_bound():
    from tpu_stencil_torch.integrity import witness

    cfg = tconfig.StreamConfig("x", 4, 4, witness.WITNESS_MAX_REPS + 1,
                               tconfig.ImageType.GREY, witness_rate=1.0)
    assert stream_engine.witness_sampler(cfg) is None
    assert stream_engine.witness_sampler(
        tconfig.StreamConfig("x", 4, 4, 3, tconfig.ImageType.GREY,
                             witness_rate=0.0)) is None


def test_launch_counter_is_exact_under_threads():
    # The kernels' counters are read-modify-write: counted under a lock,
    # so more threads than cores, switching as often as the interpreter
    # allows, lose no update.
    n_threads = 2 * (os.cpu_count() or 1) + 1
    cs.reset_launch_counts()

    def bump():
        for _ in range(2000):
            cs._count(cs.stencil_fused)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert cs.launch_counts()["stencil_fused"] == 2000 * n_threads
    cs.reset_launch_counts()


# -- the sharded stream and the pipeline run (tests/test_torch_shardstream.py
# and tests/test_torch_pipeline.py hold them in full) ------------------------

@pytest.mark.parametrize("kw", [
    {"shard_frames": (2, 1), "shard_min_pixels": 1},
    {"shard_frames": (0, 0), "shard_min_pixels": 1},
    {"pipe_stages": 2},
    {"pipe_stages": 0},
])
def test_shard_and_pipeline_streams_raise(tmp_path, kw):
    # Once they raised NotImplementedError; now each runs over two CPU
    # devices (the auto knobs decide for themselves) and writes the JAX
    # package's bytes.
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    want = _jax_stream(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                       str(tmp_path / "jax.raw"), frames=2)
    cfg = _port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                    output=str(tmp_path / "o.raw"), frames=2, **kw)
    res = _port_stream(cfg, devices=[CPU, CPU])
    assert res.frames == 2
    if kw.get("shard_frames") == (2, 1):
        assert res.shard_frames == (2, 1) and res.n_devices == 2
    if kw.get("pipe_stages") == 2:
        assert res.pipe_stages == 2 and res.n_devices == 2
    assert open(str(tmp_path / "o.raw"), "rb").read() == want


def test_small_frames_under_shard_frames_stay_on_one_device(tmp_path):
    # The JAX package's routing: below shard_min_pixels a frame stays on
    # one device even under an explicit --shard-frames; auto on one
    # device, too.
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    want = _jax_stream(clip_path, 8, 6, tconfig.ImageType.GREY, 2,
                       str(tmp_path / "jax.raw"), frames=2,
                       shard_frames=(2, 1))
    out = str(tmp_path / "o.raw")
    res = _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 2,
                                 output=out, frames=2, shard_frames=(2, 1)))
    assert res.shard_frames is None and open(out, "rb").read() == want
    _port_stream(_port_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 2,
                           output=out, frames=2, shard_frames=(0, 0),
                           shard_min_pixels=1))
    assert open(out, "rb").read() == want


def test_cli_shard_frames_exits_two_naming_the_slice(tmp_path, capsys):
    # Once rc 2 naming the next slice; now --pipe-stages 2 on --platform cpu
    # runs over the CPU twice over, rc 0, with the JAX package's bytes.
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 6, 1)
    want = _jax_stream(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
                       str(tmp_path / "jax.raw"), frames=2)
    out = str(tmp_path / "o.raw")
    rc = stream_cli.main([str(clip_path), "6", "8", "1", "grey",
                          "--frames", "2", "--platform", "cpu",
                          "--pipe-stages", "2", "--output", out])
    assert rc == 0
    assert "pipe-stages=2" in capsys.readouterr().out
    assert open(out, "rb").read() == want


# -- CLI ---------------------------------------------------------------------

def test_stream_cli_matches_jax_cli_and_stats_json(tmp_path, capsys):
    h, w, n = 10, 8, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3)
    args = [str(clip_path), str(w), str(h), "2", "rgb", "--frames", str(n),
            "--filter", "box"]
    jout, jstats = str(tmp_path / "j.raw"), str(tmp_path / "j.json")
    assert jstream_cli.main(args + ["--output", jout, "--stats-json",
                                    jstats]) == 0
    out, stats = str(tmp_path / "out.raw"), str(tmp_path / "stats.json")
    rc = stream_cli.main(args + ["--output", out, "--stats-json", stats,
                                 "--platform", "cpu"])
    assert rc == 0
    assert open(out, "rb").read() == open(jout, "rb").read()
    payload = json.loads(open(stats).read())
    assert set(payload) == set(json.loads(open(jstats).read()))
    assert payload["schema_version"] == 1
    assert payload["frames"] == n
    assert payload["frames_per_second"] > 0
    assert set(payload["stage_seconds"]) == {
        "read", "h2d", "compute", "d2h", "write"}
    assert "streamed 3 frame(s)" in capsys.readouterr().out


def test_stream_cli_dispatch_and_failure_rc(tmp_path, capsys):
    from tpu_stencil_torch import cli as top_cli

    h, w = 8, 6
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, h, w, 1)
    rc = top_cli.main(["stream", str(clip_path), str(w), str(h), "1",
                       "grey", "--frames", "4", "--platform", "cpu",
                       "--output", str(tmp_path / "o.raw")])
    assert rc == 1
    assert "failed at frame 2" in capsys.readouterr().err


def test_stream_cli_without_a_gpu_exits_two(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 1, 8, 6, 1)
    rc = stream_cli.main([str(clip_path), "6", "8", "1", "grey",
                          "--frames", "1", "--output", "null"])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_stream_cli_stdout_sink_is_pure_frames(tmp_path):
    h, w, n = 8, 6, 2
    clip_path = tmp_path / "clip.raw"
    clip = _make_clip(clip_path, n, h, w, 3)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", "stream",
         str(clip_path), str(w), str(h), "1", "rgb", "--frames", str(n),
         "--output", "-", "--platform", "cpu"],
        capture_output=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, 1,
                       str(tmp_path / "jax.raw"), frames=n)
    assert proc.stdout == want
    assert b"streamed 2 frame(s)" in proc.stderr


def test_stream_cli_stdout_sink_refuses_stats_json_stdout(tmp_path, capsys):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 1, 8, 6, 1)
    with pytest.raises(SystemExit):
        stream_cli.main([str(clip_path), "6", "8", "1", "grey",
                         "--frames", "1", "--output", "-",
                         "--stats-json", "-"])
    assert "owns stdout" in capsys.readouterr().err


def test_stream_cli_runtime_usage_error_is_clean(tmp_path, capsys):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 1, 8, 6, 1)
    rc = stream_cli.main([str(clip_path), "6", "8", "1", "grey",
                          "--frames", "1", "--output", "null",
                          "--checkpoint-every", "1", "--platform", "cpu"])
    assert rc == 2
    assert "resumable sink" in capsys.readouterr().err


def test_stream_cli_requires_length_contract(tmp_path, capsys):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 1, 8, 6, 1)
    with pytest.raises(SystemExit):
        stream_cli.main([str(clip_path), "6", "8", "1", "grey"])
    assert "--frames" in capsys.readouterr().err


def test_stream_cli_stdin_needs_output(capsys):
    with pytest.raises(SystemExit):
        stream_cli.main(["-", "6", "8", "1", "grey", "--until-eof"])
    assert "--output" in capsys.readouterr().err


def test_stream_cli_breakdown_renders_pipeline_table(tmp_path, capsys):
    h, w, n = 10, 8, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1)
    trace = str(tmp_path / "t.json")
    metrics = str(tmp_path / "m.txt")
    rc = stream_cli.main([
        str(clip_path), str(w), str(h), "2", "grey", "--frames", str(n),
        "--output", "null", "--breakdown", "--platform", "cpu",
        "--trace", trace, "--metrics-text", metrics,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stream pipeline: depth=2" in out
    assert "stream.compute" in out
    assert "modeled device-side bound" in out
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]
             if e.get("ph") == "X"}
    assert {"stream.read", "stream.h2d", "stream.compute", "stream.d2h",
            "stream.write"} <= names
    snap = obs.exposition.parse_text(open(metrics).read(),
                                     prefix="tpu_stencil_driver")
    assert snap["counters"]["stream_frames_total"] == n
    assert "stream_inflight_depth" in snap["gauges"]


def test_stream_cli_flightrec_dir_spools_a_torn_buffer(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.delenv("TPU_STENCIL_FLIGHTREC_DIR", raising=False)
    monkeypatch.delenv("TPU_STENCIL_TORCH_FLIGHTREC_DIR", raising=False)
    h, w, n = 96, 64, 2
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1)
    spool = tmp_path / "spool"
    rc = stream_cli.main([
        str(clip_path), str(w), str(h), "1", "grey", "--frames", str(n),
        "--output", str(tmp_path / "o.raw"), "--platform", "cpu",
        "--faults", "integrity.corrupt_ingest:frame=1",
        "--flightrec-dir", str(spool)])
    assert rc == 1
    assert spool.is_dir() and any(spool.iterdir())


# -- config and the model --------------------------------------------------

def test_stream_config_validation_matches_jax():
    good = dict(input="x.raw", width=4, height=4, repetitions=1)
    bad = [dict(pipeline_depth=0), dict(pipeline_depth=3, ring_buffers=3),
           dict(frames=-1), dict(mesh_frames=-2), dict(pipe_stages=-1),
           dict(shard_frames=(0, 2)), dict(shard_min_pixels=0),
           dict(overlap="sideways"), dict(checkpoint_every=-1),
           dict(progress_every=-1), dict(io_retries=-1),
           dict(max_engine_restarts=-1), dict(witness_rate=1.5),
           dict(mesh_frames=0, pipe_stages=2),
           dict(width=0), dict(block_h=12), dict(fuse=0)]
    for kw in bad:
        args = dict(good, **kw)
        with pytest.raises(ValueError) as te:
            tconfig.StreamConfig(image_type=tconfig.ImageType.GREY, **args)
        with pytest.raises(ValueError) as je:
            jconfig.StreamConfig(image_type=jconfig.ImageType.GREY, **args)
        assert str(te.value) == str(je.value), kw
    cfg = tconfig.StreamConfig(image_type=tconfig.ImageType.GREY, **good)
    assert cfg.ring_size == 4  # depth 2 + 2
    assert cfg.frame_shape == (4, 4)
    assert cfg.output_path.endswith("blur_x.raw")
    with pytest.raises(ValueError, match="--output"):
        tconfig.StreamConfig(**dict(good, input="-"),
                             image_type=tconfig.ImageType.GREY).output_path
    j = jconfig.StreamConfig(image_type=jconfig.ImageType.GREY, **good)
    for f in ("ring_size", "frame_shape", "frame_bytes", "output_path"):
        assert getattr(cfg, f) == getattr(j, f)


def test_stream_cli_parses_like_the_jax_cli():
    argv = ["clip.raw", "8", "6", "3", "rgb", "--until-eof", "--filter",
            "box", "--pipeline-depth", "3", "--ring", "5", "--mesh-frames",
            "2", "--checkpoint-every", "2", "--io-retries", "1",
            "--engine-restarts", "0", "--no-verify-ingest", "--witness-rate",
            "0.5", "--dispatch-timeout", "9", "--shard-min-pixels", "7",
            "--overlap", "split"]
    t = vars(stream_cli.build_parser().parse_args(argv))
    j = vars(jstream_cli.build_parser().parse_args(argv))
    assert t == j


def test_stream_roofline_model():
    fb, h = 1920 * 2520 * 3, 2520
    stages = roofline.stream_stage_seconds(fb, 40, "pallas", "gaussian", h,
                                           w_img=1920, channels=3)
    assert set(stages) == {"h2d", "compute", "d2h"}
    # The host link's 64 GB/s a direction; the compute stage at the
    # operations bound of 40 gaussian reps.
    assert stages["h2d"] == pytest.approx(fb / 64e9)
    plan = roofline._plan("gaussian")
    ms, by = roofline.bound_ms_per_rep(plan, fb, 8)
    assert by == "operations"
    assert stages["compute"] == pytest.approx(40 * ms / 1e3)
    piped = roofline.stream_frames_per_second(
        fb, 40, "pallas", "gaussian", h, pipeline_depth=2, w_img=1920,
        channels=3)
    serial = roofline.stream_frames_per_second(
        fb, 40, "pallas", "gaussian", h, pipeline_depth=1, w_img=1920,
        channels=3)
    assert piped > serial
    assert piped == pytest.approx(1.0 / max(stages.values()))
    assert serial == pytest.approx(1.0 / sum(stages.values()))
    xla = roofline.stream_stage_seconds(fb, 40, "xla", "gaussian", h)
    assert xla["compute"] >= stages["compute"]
    assert roofline.stream_stage_seconds(fb, 0, "pallas", "gaussian",
                                         h)["compute"] == 0.0


def test_run_on_uses_the_tensors_device():
    from tpu_stencil_torch.models.blur import IteratedConv2D

    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (12, 10, 3), np.uint8))
    m = IteratedConv2D("gaussian", backend="pallas", device="cpu")
    assert torch.equal(m.run_on(img, 5), m(img, 5))
    clip = img.reshape(2, 6, 10, 3)
    assert torch.equal(m.batch_on(clip, 3), m.batch(clip, 3))
