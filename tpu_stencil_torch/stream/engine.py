"""The streaming engine: read -> H2D -> compute -> D2H -> write.

The port's counterpart of the JAX package's ``stream/engine.py``.
``run_job`` is the serial shape (load, iterate, store, one image per
call); this engine pipelines a stream of frames so that its throughput is
bound by the slowest stage, not by the sum of the stages
(:func:`tpu_stencil_torch.runtime.roofline.stream_frames_per_second`).

The machine:

* **reader thread**: fills the slots of a ring of ``cfg.ring_size``
  pinned host buffers from the :class:`~.frames.FrameSource`, in place
  (``read_into`` a numpy view of the slot), CRC32Cs each filled slot
  (``verify_ingest``; the built ``crc32c`` library, which releases the
  GIL) and blocks when every slot is in flight.
* **dispatch** (the calling thread): re-verifies the slot's CRC, copies it
  to the card with ``copy_(non_blocking=True)`` on the lane's copy stream
  and waits for that copy's event before the slot goes back to the
  reader (a slot reused earlier would tear the frame still being
  copied); then launches the frame's reps on the device's compute stream,
  which it makes the thread's current stream (K1, K2 and K3 launch on the
  current stream), after the copy's event. At most ``pipeline_depth``
  frames are between the start of their read and the end of their D2H.
* **drain thread**: waits for each frame's compute event in dispatch
  order (under the dispatch watchdog), copies the result into a pinned
  output slot on the lane's D2H stream and waits for that copy's event
  (the writer never reads a slot whose copy has not landed), frees the
  frame's window slot.
* **writer thread**: writes the results in order to the
  :class:`~.frames.FrameSink`, runs the sampled witnesses, commits the
  frame-index checkpoint and the progress line.

A device tensor written on one stream and read on another is handed over
with ``record_stream``, so the caching allocator never gives its memory
out again while a kernel still reads it. Frame 0 bootstraps the engine
through :func:`tpu_stencil_torch.driver.prepare_engine` (the kernels built
and warmed up on a scratch copy of it), then runs as every other frame.
Lanes on one device share its compute stream: one K1 launch fills the
card, and K2's cooperative grid must never share the card with another
grid.

On the CPU (``--platform cpu``) the same threads run with plain host
tensors and no streams.

Failure semantics: the first failing stage records (stage, frame index,
exception) and stops the pipeline; frames already written stay written
(with ``--checkpoint-every`` the job resumes past them), and
:func:`run_stream` raises :class:`StreamFailure` naming the frame, after
restarting the engine from its checkpoint on a transient device fault.

Observability: ``stream.read|h2d|compute|d2h|write`` spans (one trace
track per thread), the ``stream_inflight_depth`` gauge, the
``stream_<stage>_seconds`` histograms, the ``stream_<stage>_busy_fraction``
gauges and the ``stream_frames_total`` counter, in the driver registry.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_stencil_torch import obs
from tpu_stencil_torch.config import StreamConfig, canonical_backend
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.integrity import witness as _witness_mod
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.obs import flight as _obs_flight
from tpu_stencil_torch.obs import tracing as _obs_tracing
from tpu_stencil_torch.resilience import deadline as _deadline
from tpu_stencil_torch.resilience import faults as _faults
from tpu_stencil_torch.resilience import retry as _retry
from tpu_stencil_torch.stream import frames as frames_io

_EOF = object()          # clean end-of-stream sentinel
_STAGES = ("read", "h2d", "compute", "d2h", "write")


class StreamFailure(RuntimeError):
    """A stage failed on a specific frame; the pipeline drained and
    stopped. ``stage`` names the failing stage, ``frame_index`` the frame
    (global index, resume-aware), ``__cause__`` the original exception."""

    def __init__(self, stage: str, frame_index: int, cause: BaseException):
        super().__init__(
            f"stream {stage} failed at frame {frame_index}: "
            f"{type(cause).__name__}: {cause}"
        )
        self.stage = stage
        self.frame_index = frame_index


@dataclasses.dataclass
class StreamResult:
    """One finished (or resumed-and-finished) streaming job."""

    frames: int              # frames processed THIS run
    skipped: int             # frames skipped by --resume
    wall_seconds: float      # whole run incl. the engine's warm-up
    frames_per_second: float  # frames / wall_seconds
    # Busy seconds per stage. On a fan the per-device stages (h2d,
    # compute, d2h) sum over the lanes; --breakdown divides them by
    # n_devices to compare them with the serial read and write.
    stage_seconds: Dict[str, float]
    backend: str             # what ran, like JobResult
    schedule: Optional[str]
    pipeline_depth: int
    output: str
    restarts: int = 0        # mid-stream engine restarts that recovered
    n_devices: int = 1       # devices the run used
    per_device_frames: Optional[list] = None  # frames per lane or group
    shard_frames: Optional[Tuple[int, int]] = None  # the RxC that ran
    pipe_stages: int = 1     # temporal stages that ran


class _Abort(Exception):
    """Internal: a sibling stage failed; unwind quietly."""


class _StageControl:
    """Stop flag, first-failure slot, abort-aware queue operations and the
    per-stage spans and clocks: the control surface both engines share
    (:class:`_Pipeline` extends it; the fan-out's lanes use it directly,
    :mod:`tpu_stencil_torch.parallel.fanout`)."""

    def __init__(self) -> None:
        self.stop = threading.Event()
        self._fail_lock = threading.Lock()
        self.failure: Optional[Tuple[str, int, BaseException]] = None
        self._stage_lock = threading.Lock()
        self.stage_seconds: Dict[str, float] = {s: 0.0 for s in _STAGES}
        self.t_start = time.perf_counter()

    def fail(self, stage: str, frame_index: int, exc: BaseException) -> None:
        with self._fail_lock:
            if self.failure is None:
                self.failure = (stage, frame_index, exc)
        self.stop.set()

    def _check(self) -> None:
        if self.stop.is_set():
            raise _Abort()

    def put(self, q: queue.Queue, item) -> None:
        """Blocking put that aborts when a sibling stage failed."""
        while True:
            self._check()
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                pass

    def get(self, q: queue.Queue):
        while True:
            self._check()
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                pass

    def stage(self, name: str, frame_index: int, t0: float = None,
              **attrs):
        """Span plus per-stage clock for one frame in one stage. ``t0``
        backdates the span's start to when the stage's work began (the
        compute stage runs from its dispatch, not from when the drain
        thread waits for it). ``attrs`` land on the span (the fan-out tags
        its per-device stages with ``dev=``)."""
        return _StageSpan(self, name, frame_index, t0, **attrs)


class _StageSpan:
    __slots__ = ("_pl", "name", "frame_index", "_span", "_t0", "_attrs",
                 "_ctx_token")

    def __init__(self, pl: _StageControl, name: str, frame_index: int,
                 t0: float = None, **attrs):
        self._pl, self.name, self.frame_index = pl, name, frame_index
        self._t0 = t0
        self._attrs = attrs

    def __enter__(self):
        # frame-<i> is the stream's trace id: the frame's records
        # correlate across stages, in the trace and in flight dumps.
        self._ctx_token = (
            _obs_ctx.push(_obs_ctx.frame_context(self.frame_index))
            if _obs_tracing.sinks_active() else None
        )
        self._span = obs.span(
            f"stream.{self.name}", "stream", frame=self.frame_index,
            **self._attrs
        )
        self._span.__enter__()
        if self._t0 is None:
            self._t0 = time.perf_counter()
        elif isinstance(self._span, obs.Span):
            self._span._t0 = self._t0  # backdate the record too
        return self._span

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        if self._ctx_token is not None:
            _obs_ctx.pop(self._ctx_token)
        with self._pl._stage_lock:
            self._pl.stage_seconds[self.name] += dt
            busy = self._pl.stage_seconds[self.name]
        obs.registry().histogram(f"stream_{self.name}_seconds").observe(dt)
        wall = time.perf_counter() - self._pl.t_start
        if wall > 0:
            obs.registry().gauge(
                f"stream_{self.name}_busy_fraction"
            ).set(min(1.0, busy / wall))


class _Slots:
    """One lane's host and device copy machinery: the ring of
    ``cfg.ring_size`` staging slots the reader fills, ``pipeline_depth +
    2`` output slots the drain fills, both pinned on a card (plain host
    tensors on the CPU), with a numpy view of each; the lane's copy and
    D2H streams and the device's compute stream (shared by every lane on
    the device)."""

    def __init__(self, cfg: StreamConfig, device: torch.device,
                 compute_stream=None) -> None:
        self.cfg = cfg
        self.device = device
        self.cuda = device.type == "cuda"
        n = cfg.frame_bytes

        def host() -> torch.Tensor:
            return torch.empty(n, dtype=torch.uint8, pin_memory=self.cuda)

        self.ring = [host() for _ in range(cfg.ring_size)]
        self.views = [t.numpy() for t in self.ring]
        self.out = [host() for _ in range(cfg.pipeline_depth + 2)]
        self.out_views = [t.numpy() for t in self.out]
        self.free_q: queue.Queue = queue.Queue()
        for i in range(len(self.ring)):
            self.free_q.put(i)
        self.out_free_q: queue.Queue = queue.Queue()
        for i in range(len(self.out)):
            self.out_free_q.put(i)
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.d2h_stream = torch.cuda.Stream(device)
            self.compute_stream = (compute_stream if compute_stream
                                   is not None else torch.cuda.Stream(device))

    def h2d(self, bi: int):
        """Slot ``bi`` on the device, as a frame-shaped tensor: copied on
        the copy stream and waited for (the slot may go back to the reader
        on return), handed to the compute stream. Returns (tensor, the
        copy's event or None)."""
        shape = self.cfg.frame_shape
        if not self.cuda:
            return self.ring[bi].clone().view(shape), None
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(self.cfg.frame_bytes, dtype=torch.uint8,
                              device=self.device)
            dev.copy_(self.ring[bi], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
        ev.synchronize()
        dev.record_stream(self.compute_stream)
        return dev.view(shape), ev

    def adopt(self, dev: torch.Tensor) -> None:
        """Hand a tensor made on the thread's default stream (frame 0's,
        placed by the warm-up) to the compute stream."""
        if self.cuda:
            dev.record_stream(self.compute_stream)

    def launch(self, launch: Callable, dev: torch.Tensor, ev=None):
        """``launch(dev)`` on the compute stream, after ``ev``. Returns
        (result, its event or None)."""
        if not self.cuda:
            return launch(dev), None
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.compute_stream):
            if ev is not None:
                self.compute_stream.wait_event(ev)
            out = launch(dev)
            done = torch.cuda.Event()
            done.record(self.compute_stream)
        return out, done

    def d2h(self, out: torch.Tensor, done, oi: int) -> np.ndarray:
        """``out`` into output slot ``oi`` on the D2H stream, after
        ``done``, waited for. Returns the slot's frame-shaped view."""
        if not self.cuda:
            self.out[oi].copy_(out.reshape(-1))
        else:
            with torch.cuda.stream(self.d2h_stream):
                self.d2h_stream.wait_event(done)
                self.out[oi].copy_(out.reshape(-1), non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.d2h_stream)
            ev.synchronize()
        return self.out_views[oi].reshape(self.cfg.frame_shape)


class _Pipeline(_StageControl):
    """Shared state of one single-device run: slots, queues, window."""

    def __init__(self, cfg: StreamConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.slots = _Slots(cfg, device)
        self.filled_q: queue.Queue = queue.Queue(maxsize=cfg.ring_size)
        self.inflight_q: queue.Queue = queue.Queue(maxsize=cfg.pipeline_depth)
        self.write_q: queue.Queue = queue.Queue(maxsize=cfg.pipeline_depth + 1)
        # A frame holds a window slot from its read start until its D2H
        # completes.
        self.window = threading.Semaphore(cfg.pipeline_depth)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._gauge = obs.registry().gauge("stream_inflight_depth")
        self.witness = witness_sampler(cfg)

    def acquire_window(self) -> None:
        while not self.window.acquire(timeout=0.05):
            self._check()
        with self._inflight_lock:
            self._inflight += 1
            self._gauge.set(self._inflight)

    def release_window(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            self._gauge.set(self._inflight)
        self.window.release()

    def zero_gauge(self) -> None:
        """Teardown: a failed run's aborted frames never pass
        release_window, and the gauge must not report them forever."""
        with self._inflight_lock:
            self._inflight = 0
            self._gauge.set(0)


def witness_sampler(cfg: StreamConfig):
    """The run's witness sampler, or None: off at rate 0 and past
    ``WITNESS_MAX_REPS`` (the witness runs one torch-ops step per rep)."""
    if (cfg.witness_rate > 0
            and cfg.repetitions <= _witness_mod.WITNESS_MAX_REPS):
        return _witness_mod.WitnessSampler(cfg.witness_rate,
                                           seed=cfg.witness_seed)
    return None


def _io_policy(cfg: StreamConfig) -> _retry.RetryPolicy:
    return dataclasses.replace(_retry.IO_POLICY, attempts=1 + cfg.io_retries)


def _make_read_frame(cfg: StreamConfig, source):
    """The per-frame read both engines share: the ``read`` fault site
    resolved once, transient failures retried under the I/O policy, but
    only when the source can rewind (``source.mark()``)."""
    fault = _faults.site("read")
    policy = _io_policy(cfg)

    def read_frame(i: int, buf) -> bool:
        def attempt() -> bool:
            if fault is not None:
                fault(i)
            return source.read_into(buf)

        restore = source.mark()
        if restore is None:
            return attempt()
        return _retry.retry_call(attempt, policy=policy,
                                 on_retry=lambda _a, _e: restore())

    return read_frame


def _make_write_frame(cfg: StreamConfig, sink):
    """The per-frame write both engines share: the ``write`` fault site
    resolved once; idempotent sinks retry transient failures, append-only
    ones fail on the first error."""
    fault = _faults.site("write")
    policy = _io_policy(cfg)
    retryable = bool(getattr(sink, "retryable_writes", False))

    def write_frame(i: int, frame) -> None:
        def attempt() -> None:
            if fault is not None:
                fault(i)
            sink.write(i, frame)

        if retryable:
            _retry.retry_call(attempt, policy=policy)
        else:
            attempt()

    return write_frame


def _stage_in(view: np.ndarray, cfg: StreamConfig, idx: int, witness,
              fault_corrupt):
    """The reader's work on a filled slot: its CRC (None without
    ``verify_ingest``), the ``integrity.corrupt_ingest`` tear of the real
    slot, and the witness's copy of the pristine input (None unless
    sampled). Returns (crc, witness copy)."""
    crc = _checksum.native_crc32c(view) if cfg.verify_ingest else None
    if fault_corrupt is not None and _checksum.fired(fault_corrupt, idx):
        _checksum.corrupt_array(view)
    wit = view.copy() if witness is not None and witness.pick() else None
    return crc, wit


def _verify_staged(buf: np.ndarray, crc, idx: int) -> None:
    """The re-verification before the copy to the card: the slot must
    still hold the bytes the reader checksummed (``crc`` None: off). A
    mismatch is a torn host buffer, raised typed
    (:class:`ChecksumMismatch`, permanent: the frame's bytes are gone)."""
    if crc is None:
        return
    try:
        _checksum.verify(buf, crc, f"stream staging ring (frame {idx})")
    except _checksum.ChecksumMismatch:
        obs.registry().counter("integrity_ingest_failures_total").inc()
        _obs_flight.trigger("checksum_mismatch", trace_id=f"frame-{idx}",
                            tier="stream", frame=idx)
        raise
    obs.registry().counter("integrity_ingest_verified_total").inc()


def _witness_frame(cfg: StreamConfig, idx: int, wit_buf: np.ndarray,
                   arr: np.ndarray, device) -> None:
    """Re-execute one sampled frame through torch ops on ``device``
    (:func:`~tpu_stencil_torch.integrity.witness.device_witness`, no hand
    kernel) and compare with the pipeline's result; a divergence raises
    :class:`WitnessMismatch` before the frame reaches the sink."""
    with obs.span("integrity.witness", "stream", frame=idx):
        want = _witness_mod.device_witness(
            wit_buf.reshape(cfg.frame_shape), cfg.filter_name,
            cfg.repetitions, cfg.boundary, device=device,
        )
    obs.registry().counter("integrity_witness_total").inc()
    if not np.array_equal(want, np.asarray(arr)):
        obs.registry().counter("integrity_witness_mismatch_total").inc()
        _obs_flight.trigger("witness_mismatch", trace_id=f"frame-{idx}",
                            tier="stream", frame=idx, reps=cfg.repetitions)
        raise _checksum.WitnessMismatch(
            f"stream frame {idx}",
            "frame withheld from the sink (two measured-equivalent "
            "programs disagree: a hardware or runtime fault)",
        )


def _commit_progress(cfg: StreamConfig, sink, done: int, save_progress):
    """Flush the sink, then record frames [0, done) in the checkpoint."""
    from tpu_stencil_torch.runtime import checkpoint as ckpt

    sink.flush()
    if save_progress is not None:
        save_progress(done)
    else:
        ckpt.save_stream_progress(cfg, done)


def _reader(pl: _Pipeline, source, start_frame: int) -> None:
    """Fill the staging ring in frame order, inside the window."""
    cfg = pl.cfg
    slots = pl.slots
    idx = start_frame
    read_frame = _make_read_frame(cfg, source)
    fault_corrupt = _faults.site("integrity.corrupt_ingest")
    try:
        while cfg.frames is None or idx < cfg.frames:
            pl.acquire_window()
            bi = pl.get(slots.free_q)
            with pl.stage("read", idx):
                ok = read_frame(idx, slots.views[bi])
            if not ok:
                if cfg.frames is not None:
                    raise IOError(
                        f"stream ended after {idx} frame(s); "
                        f"--frames promised {cfg.frames}"
                    )
                slots.free_q.put(bi)
                pl.release_window()
                break
            crc, wit = _stage_in(slots.views[bi], cfg, idx, pl.witness,
                                 fault_corrupt)
            pl.put(pl.filled_q, (idx, bi, crc, wit))
            idx += 1
        pl.put(pl.filled_q, _EOF)
    except _Abort:
        pass
    except BaseException as e:
        pl.fail("read", idx, e)


def _drain(pl: _Pipeline) -> None:
    """Wait for each frame's compute in dispatch order (under the
    watchdog), copy it into an output slot, free its window slot, hand it
    to the writer."""
    idx, stage = -1, "compute"
    slots = pl.slots
    fault_d2h = _faults.site("d2h")
    fault_corrupt = _faults.site("integrity.corrupt_result")
    timeout_s = _deadline.resolve(pl.cfg.dispatch_timeout_s)
    try:
        while True:
            item = pl.get(pl.inflight_q)
            if item is _EOF:
                pl.put(pl.write_q, _EOF)
                return
            idx, out, done, t_disp, wit = item
            stage = "compute"
            with pl.stage("compute", idx, t0=t_disp):
                _deadline.fence(out if done is None else done, timeout_s,
                                f"stream.compute[frame={idx}]")
            stage = "d2h"
            oi = pl.get(slots.out_free_q)
            with pl.stage("d2h", idx):
                if fault_d2h is not None:
                    fault_d2h(idx)
                arr = slots.d2h(out, done, oi)
            del out
            if fault_corrupt is not None and _checksum.fired(
                    fault_corrupt, idx):
                _checksum.corrupt_array(arr)
            pl.release_window()
            pl.put(pl.write_q, (idx, oi, wit))
    except _Abort:
        pass
    except BaseException as e:
        pl.fail(stage, max(idx, 0), e)


def _writer(pl: _Pipeline, sink, done: list, save_progress=None) -> None:
    """Write the results in order; witness, checkpoint, progress.
    ``done[0]`` tracks the frames fully written. ``save_progress(n)``
    commits the progress sidecar (None: the single-device record; the
    sharded stream's records its topology)."""
    cfg = pl.cfg
    slots = pl.slots
    idx = -1
    write_frame = _make_write_frame(cfg, sink)
    try:
        while True:
            item = pl.get(pl.write_q)
            if item is _EOF:
                return
            idx, oi, wit = item
            arr = slots.out_views[oi].reshape(cfg.frame_shape)
            if wit is not None:
                _witness_frame(cfg, idx, wit, arr, slots.device)
            with pl.stage("write", idx):
                write_frame(idx, arr)
            slots.out_free_q.put(oi)
            done[0] = idx + 1
            obs.registry().counter("stream_frames_total").inc()
            if cfg.checkpoint_every and done[0] % cfg.checkpoint_every == 0:
                _commit_progress(cfg, sink, done[0], save_progress)
            if cfg.progress_every and done[0] % cfg.progress_every == 0:
                print(f"stream: frame {done[0]}", file=sys.stderr, flush=True)
    except _Abort:
        pass
    except BaseException as e:
        pl.fail("write", max(idx, 0), e)


def build_launch(model, cfg: StreamConfig):
    """The per-frame step, ``launch(dev) -> result`` on the device ``dev``
    lies on (:meth:`IteratedConv2D.run_on`: the job's plans, schedules and
    geometry), with the (backend, schedule) it runs."""
    backend, schedule = model.resolved_config((cfg.height, cfg.width),
                                              cfg.channels)
    reps = cfg.repetitions

    def launch(dev: torch.Tensor) -> torch.Tensor:
        return model.run_on(dev, reps)

    return launch, backend, schedule


def _dispatch(pl: _Pipeline, model, eng: dict) -> None:
    """The dispatch loop on the calling thread: bootstrap the engine on
    frame 0 (the kernels built and warmed up while the reader prefetches
    the next frames), then copy and launch each filled frame inside the
    window. Publishes ``backend``/``schedule`` into ``eng``."""
    from tpu_stencil_torch import driver

    cfg = pl.cfg
    slots = pl.slots
    idx, stage = -1, "compute"
    fault_h2d = _faults.site("h2d")
    fault_compute = _faults.site("compute")
    try:
        first = pl.get(pl.filled_q)
        if first is _EOF:
            pl.put(pl.inflight_q, _EOF)
            return
        idx, b0, crc0, wit0 = first
        # prepare_engine places a copy of frame 0 (its h2d fault point is
        # checked there) and warms the kernels up on a scratch copy of it,
        # fenced; the placed frame is frame 0's input. The staged CRC is
        # re-verified first: a torn slot fails before the warm-up.
        stage = "h2d"
        _verify_staged(slots.views[b0], crc0, idx)
        engine = driver.prepare_engine(
            model, slots.views[b0].reshape(cfg.frame_shape),
            calls=[cfg.repetitions],
            timeout_s=_deadline.resolve(cfg.dispatch_timeout_s))
        launch, eng["backend"], eng["schedule"] = build_launch(model, cfg)
        slots.free_q.put(b0)
        slots.adopt(engine.img_dev)
        stage = "compute"
        if fault_compute is not None:
            fault_compute(idx)
        t_disp = time.perf_counter()
        out, done = slots.launch(launch, engine.img_dev)
        del engine
        pl.put(pl.inflight_q, (idx, out, done, t_disp, wit0))
        del out
        while True:
            item = pl.get(pl.filled_q)
            if item is _EOF:
                break
            idx, bi, crc, wit = item
            stage = "h2d"
            if fault_h2d is not None:
                fault_h2d(idx)
            _verify_staged(slots.views[bi], crc, idx)
            with pl.stage("h2d", idx):
                dev, ev = slots.h2d(bi)
            slots.free_q.put(bi)  # the copy has landed
            stage = "compute"
            if fault_compute is not None:
                fault_compute(idx)
            t_disp = time.perf_counter()
            out, done = slots.launch(launch, dev, ev)
            del dev
            pl.put(pl.inflight_q, (idx, out, done, t_disp, wit))
            del out
        pl.put(pl.inflight_q, _EOF)
    except _Abort:
        pass
    except BaseException as e:
        pl.fail(stage, max(idx, 0), e)


def run_stream(
    cfg: StreamConfig,
    devices: Optional[List[torch.device]] = None,
    resume: bool = False,
    source: Optional[frames_io.FrameSource] = None,
    sink: Optional[frames_io.FrameSink] = None,
) -> StreamResult:
    """Run one streaming job end to end; returns :class:`StreamResult` or
    raises :class:`StreamFailure`. ``devices``: the devices the job may
    use (None: every visible CUDA device, raising when there is none; a
    device may repeat). ``source``/``sink`` override the config's specs
    (tests and benchmarks inject synthetic stages).

    Engine restarts: when a transient failure hits a device stage (h2d,
    compute, d2h), the job checkpoints (``checkpoint_every``) and its
    source can re-serve consumed frames (a regular file or a directory),
    the pipeline is torn down, the engine re-prepared, and the run resumes
    from the frame checkpoint, up to ``cfg.max_engine_restarts`` times.
    I/O failures are retried inside the pipeline and never restart it;
    injected sources and sinks never restart.

    ``--mesh-frames``, ``--shard-frames`` and ``--pipe-stages``: the fan
    width (:func:`tpu_stencil_torch.parallel.fanout.resolve_mesh_frames`),
    the RxC shard (:func:`tpu_stencil_torch.stream.sharded.
    resolve_shard_frames`) and the stage count
    (:func:`tpu_stencil_torch.parallel.pipeline.resolve_pipe_stages`)
    resolve once per call, and every restart runs the same topology, so
    the checkpoint's record of it stays aligned. A run with stages, or a
    fan of sharded groups, runs the composed engine
    (:mod:`tpu_stencil_torch.stream.pipelined`); the config makes a
    composed topology explicit on every axis, so no auto probe resolves
    one axis while another is live."""
    from tpu_stencil_torch.devices import resolve_devices

    if devices is None:
        devices = resolve_devices()
    devices = [torch.device(d) for d in devices]
    if cfg.verify_ingest:
        # The checksum library is built before any thread starts; a failed
        # build fails the stream typed (KernelBuildError), before a frame.
        _checksum.native_library()
    restarts = 0
    n_mesh = None
    pipe = None
    shard = _UNRESOLVED
    while True:
        try:
            if shard is _UNRESOLVED:
                shard = _resolve_shard_frames(cfg, devices)
            if pipe is None:
                pipe = _resolve_pipe_stages(cfg, devices)
            if n_mesh is None:
                if shard is not None or pipe > 1:
                    # Composed: mesh_frames is explicit (the config
                    # refuses a composed auto), the group count.
                    n_mesh = max(1, cfg.mesh_frames)
                else:
                    n_mesh = _resolve_mesh_frames(cfg, devices)
            result = _run_stream_once(cfg, devices, resume, source, sink,
                                      n_mesh=n_mesh, shard=shard, pipe=pipe)
            result.restarts = restarts
            return result
        except StreamFailure as e:
            restartable = (
                restarts < cfg.max_engine_restarts
                and source is None and sink is None
                and cfg.checkpoint_every > 0
                and e.stage in ("h2d", "compute", "d2h")
                and e.__cause__ is not None
                and _retry.is_transient(e.__cause__)
                and frames_io.is_restartable_source(cfg.input)
            )
            if not restartable:
                raise
            restarts += 1
            obs.registry().counter("resilience_stream_restarts_total").inc()
            print(
                f"stream: engine fault at {e.stage}[frame "
                f"{e.frame_index}] ({type(e.__cause__).__name__}); "
                f"re-preparing engine and resuming from checkpoint "
                f"(restart {restarts}/{cfg.max_engine_restarts})",
                file=sys.stderr, flush=True,
            )
            resume = True  # honour whatever progress the checkpoint holds


def _finish_result(cfg: StreamConfig, resume: bool, t_start: float,
                   start_frame: int, frames: int, stage_seconds: Dict,
                   backend: str, schedule, out_spec: str,
                   n_devices: int = 1,
                   per_device_frames: Optional[list] = None,
                   shard_frames: Optional[Tuple[int, int]] = None,
                   pipe_stages: int = 1) -> StreamResult:
    """The run epilogue every engine ends in: sweep the progress sidecar
    of a completed run, then assemble the :class:`StreamResult`."""
    if cfg.checkpoint_every or resume:
        from tpu_stencil_torch.runtime import checkpoint as ckpt

        ckpt.clear_stream_progress(cfg)
    wall = time.perf_counter() - t_start
    return StreamResult(
        frames=frames,
        skipped=start_frame,
        wall_seconds=wall,
        frames_per_second=frames / wall if wall > 0 else 0.0,
        stage_seconds=stage_seconds,
        backend=backend,
        schedule=schedule if backend == "pallas" else None,
        pipeline_depth=cfg.pipeline_depth,
        output=out_spec,
        n_devices=n_devices,
        per_device_frames=per_device_frames,
        shard_frames=shard_frames,
        pipe_stages=pipe_stages,
    )


def _resolve_mesh_frames(cfg: StreamConfig, devices) -> int:
    if cfg.mesh_frames == 1:
        return 1
    from tpu_stencil_torch.parallel import fanout

    return fanout.resolve_mesh_frames(cfg, devices)


# Distinct from None: a shard resolves to None (one device), and the
# restart loop must not pay the probe again for it.
_UNRESOLVED = object()


def _resolve_shard_frames(cfg: StreamConfig, devices
                          ) -> Optional[Tuple[int, int]]:
    if cfg.shard_frames is None:
        return None
    from tpu_stencil_torch.stream import sharded

    return sharded.resolve_shard_frames(cfg, devices)


def _resolve_pipe_stages(cfg: StreamConfig, devices) -> int:
    if cfg.pipe_stages == 1:
        return 1
    from tpu_stencil_torch.parallel import pipeline

    return pipeline.resolve_pipe_stages(cfg, devices)


def probe_seconds(cfg: StreamConfig, devices) -> float:
    """One arm of an auto knob's A/B: ``cfg.frames`` copies of a seeded
    random frame to a null sink, once warm and once timed; the timed
    run's seconds. The caller holds a scratch registry around it."""
    frame = np.random.default_rng(0).integers(0, 256, cfg.frame_bytes,
                                              dtype=np.uint8)
    def run() -> None:
        run_stream(cfg, devices=list(devices),
                   source=frames_io.RepeatSource(frame, cfg.frames),
                   sink=frames_io.NullSink())

    run()  # warm: the kernels built, the runners cached
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _close_io(own_source, source, own_sink, sink, failed: bool) -> None:
    """Close what the run opened: a source close error never masks the
    recorded failure (it can race a reader parked in read()); a sink close
    error on a clean run raises (buffered frames were lost)."""
    if own_source:
        try:
            source.close()
        except OSError:
            pass
    if own_sink and sink is not None:
        try:
            sink.close()
        except OSError:
            if not failed:
                raise


def _run_stream_once(
    cfg: StreamConfig,
    devices: List[torch.device],
    resume: bool = False,
    source: Optional[frames_io.FrameSource] = None,
    sink: Optional[frames_io.FrameSink] = None,
    n_mesh: int = 1,
    shard: Optional[Tuple[int, int]] = None,
    pipe: int = 1,
) -> StreamResult:
    """One pipeline lifetime (:func:`run_stream` owns the restart loop
    around it): resume, the source and sink, then the engine: the composed
    one (:mod:`~tpu_stencil_torch.stream.pipelined`) for ``pipe`` > 1 or a
    fan of sharded groups, the sharded one
    (:mod:`~tpu_stencil_torch.stream.sharded`) for a ``shard``, the fan's
    (:mod:`~tpu_stencil_torch.parallel.fanout`) for ``n_mesh`` > 1, else
    the single-device engine."""
    from tpu_stencil_torch.models.blur import IteratedConv2D

    obs.registry().counter("stream_jobs_total").inc()
    t_start = time.perf_counter()
    composed = pipe > 1 or (n_mesh > 1 and shard is not None)
    r, c = shard if shard else (1, 1)
    devices = devices[:n_mesh * pipe * r * c]
    model = IteratedConv2D(cfg.filter_name, backend=cfg.backend,
                           schedule=cfg.schedule, boundary=cfg.boundary,
                           block_h=cfg.block_h, fuse=cfg.fuse,
                           device=devices[0])
    # What ran in THIS run, on every path.
    obs.registry().gauge("stream_mesh_devices").set(n_mesh)
    obs.registry().gauge("stream_shard_devices").set(r * c if shard else 0)
    obs.registry().gauge("stream_pipe_stages").set(pipe if pipe > 1 else 0)

    start_frame = 0
    if resume:
        from tpu_stencil_torch.runtime import checkpoint as ckpt

        restored = ckpt.restore_stream_progress(
            cfg, mesh_devices=n_mesh, shard_frames=shard, pipe_stages=pipe)
        if restored is not None:
            start_frame = restored
    elif cfg.checkpoint_every:
        # A run that does not resume starts over: a stale sidecar of a
        # killed earlier run is invalidated now, or a restart before this
        # run's first commit would adopt its progress.
        from tpu_stencil_torch.runtime import checkpoint as ckpt

        ckpt.clear_stream_progress(cfg)
    if cfg.frames is not None and start_frame > cfg.frames:
        raise ValueError(
            f"checkpoint records {start_frame} frames done but --frames "
            f"is {cfg.frames}"
        )
    out_spec = cfg.output_path if sink is None else "<injected>"
    if cfg.checkpoint_every and sink is None and (
        not frames_io.is_resumable_sink(out_spec)
    ):
        raise ValueError(
            f"--checkpoint-every needs a resumable sink (a file or "
            f"directory), not {out_spec!r}"
        )

    own_source = source is None
    own_sink = sink is None
    if own_source:
        source = frames_io.open_source(cfg.input, cfg.frame_bytes)
    try:
        if start_frame:
            source.skip(start_frame)
        if own_sink:
            sink = frames_io.open_sink(out_spec, cfg.frame_bytes, start_frame)
    except BaseException:
        if own_source:
            source.close()
        raise

    if composed or shard is not None or n_mesh > 1:
        if composed:
            from tpu_stencil_torch.stream import pipelined

            def engine():
                return pipelined.run_pipelined_stream(
                    cfg, devices, n_mesh, pipe, shard, model, source, sink,
                    start_frame)
        elif shard is not None:
            from tpu_stencil_torch.stream import sharded

            def engine():
                return sharded.run_shard_stream(cfg, devices, shard, model,
                                                source, sink, start_frame)
        else:
            from tpu_stencil_torch.parallel import fanout

            def engine():
                return fanout.run_mesh_frames(cfg, devices, n_mesh, model,
                                              source, sink, start_frame)
        failed = False
        try:
            ran = engine()
        except BaseException:
            failed = True
            raise
        finally:
            _close_io(own_source, source, own_sink, sink, failed)
        return _finish_result(
            cfg, resume, t_start, start_frame, ran["frames"],
            ran["stage_seconds"], ran["backend"], ran["schedule"],
            out_spec, n_devices=ran.get("n_devices", n_mesh),
            per_device_frames=ran.get("per_device_frames"),
            shard_frames=shard, pipe_stages=pipe,
        )

    try:
        pl = _Pipeline(cfg, devices[0])
    except BaseException:
        _close_io(own_source, source, own_sink, sink, True)
        raise
    done = [start_frame]
    eng: dict = {}
    threads = [
        threading.Thread(target=_reader, args=(pl, source, start_frame),
                         name="stream-reader", daemon=True),
        threading.Thread(target=_drain, args=(pl,),
                         name="stream-drain", daemon=True),
        threading.Thread(target=_writer, args=(pl, sink, done),
                         name="stream-writer", daemon=True),
    ]
    try:
        for t in threads:
            t.start()
        _dispatch(pl, model, eng)
        # Clean runs end by the sentinel cascade, failed ones by the stop
        # flag; a reader parked in a blocking read() on a silent pipe is
        # never waited on indefinitely.
        for t in threads:
            while t.is_alive() and not pl.stop.is_set():
                t.join(timeout=0.1)
    finally:
        pl.stop.set()
        for t in threads:
            t.join(timeout=1.0)
        pl.zero_gauge()
        _close_io(own_source, source, own_sink, sink,
                  pl.failure is not None)

    if pl.failure is not None:
        stage, frame_index, cause = pl.failure
        raise StreamFailure(stage, frame_index, cause) from cause

    # No frame ran: the backend asked for (nothing was resolved).
    backend = eng.get("backend", canonical_backend(cfg.backend))
    return _finish_result(
        cfg, resume, t_start, start_frame, done[0] - start_frame,
        dict(pl.stage_seconds), backend, eng.get("schedule"), out_spec,
    )
