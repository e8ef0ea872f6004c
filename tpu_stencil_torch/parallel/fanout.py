"""Mesh fan-out: frames of one stream dealt over several devices.

The port's counterpart of the JAX package's ``parallel/fanout.py``. Frames
are independent, so the program over several devices is pure data
parallelism: frame ``i`` goes to lane ``(i - start) % n`` and the only
coupling between devices is the writer's in-order drain.

The machine:

* **one reader thread**: the source is single-consumer (pipes and stdin
  are strictly sequential), so one thread reads the frames in order into
  the staging slots of each frame's lane. Each lane owns its pinned
  staging ring (``cfg.ring_size`` slots), output slots, copy and D2H
  streams (:class:`~tpu_stencil_torch.stream.engine._Slots`) and its
  window of ``cfg.pipeline_depth`` frames, so backpressure is per device.
* **a dispatch thread per lane**: the copy to its device, waited for
  before the slot returns to the reader, then the frame's reps on the
  device's compute stream (the step ``run_job`` and ``run_stream`` run,
  :func:`~tpu_stencil_torch.stream.engine.build_launch`). Lanes on one
  device share its compute stream (``[cuda:0] * 2`` runs their kernels
  one after another: K2's cooperative grid never shares the card).
* **a drain thread per lane**: waits for the compute event in that lane's
  order (under the dispatch watchdog), copies the result into an output
  slot and waits for that copy.
* **one writer thread**: takes frame ``i`` from lane ``(i - start) % n``
  (each lane delivers in its own order, so the global order needs no
  reordering buffer), writes it, and commits the frame checkpoint with
  the device count and the per-device cursors.

The model's kernels are built (and its configuration resolved) once on
the calling thread before any lane starts. A resume re-deals the frames
that remain round-robin from the checkpoint; a ``--resume`` under another
device count fails typed
(:class:`~tpu_stencil_torch.runtime.checkpoint.MeshCursorMismatch`).
Failure semantics, fault sites, stage spans and the restart loop are the
single-device engine's (:func:`~tpu_stencil_torch.stream.engine.
run_stream` owns the loop around this module).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpu_stencil_torch import obs
from tpu_stencil_torch.config import StreamConfig
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.resilience import deadline as _deadline
from tpu_stencil_torch.resilience import faults as _faults
from tpu_stencil_torch.stream import engine as _sengine
from tpu_stencil_torch.stream import frames as frames_io

_EOF = object()

# Frames per arm of the auto (--mesh-frames 0) measured A/B.
PROBE_FRAMES = 3

_Control = _sengine._StageControl


class _InflightMeter:
    """The ``stream_inflight_depth`` gauge of a fan: frames between
    read-complete and D2H-complete over all lanes."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()
        self._gauge = obs.registry().gauge("stream_inflight_depth")

    def inc(self) -> None:
        with self._lock:
            self._n += 1
            self._gauge.set(self._n)

    def dec(self) -> None:
        with self._lock:
            self._n -= 1
            self._gauge.set(self._n)

    def zero(self) -> None:
        """Teardown: aborted frames never pass :meth:`dec`."""
        with self._lock:
            self._n = 0
            self._gauge.set(0)


class _Lane:
    """One device's slots and queues: host memory O(ring) frames, device
    memory O(pipeline_depth) frames, per device."""

    def __init__(self, cfg: StreamConfig, device: torch.device,
                 compute_stream) -> None:
        self.slots = _sengine._Slots(cfg, device, compute_stream)
        self.filled_q: queue.Queue = queue.Queue(maxsize=cfg.ring_size)
        self.inflight_q: queue.Queue = queue.Queue(
            maxsize=cfg.pipeline_depth)
        self.done_q: queue.Queue = queue.Queue(
            maxsize=cfg.pipeline_depth + 1)
        self.frames = 0  # frames this lane fully wrote (writer-owned)


def device_cursors(frames_done: int, start_frame: int, n: int) -> List[int]:
    """The per-device cursors at global progress ``frames_done``:
    ``cursors[d]`` is the next frame lane ``d`` would receive under the
    current run's deal ``frame i -> lane (i - start_frame) % n``. The
    checkpoint records them as the picture of where the fan stood; a
    resume re-deals from ``frames_done`` and never adopts them."""
    base = max(frames_done, start_frame)
    off = (base - start_frame) % n
    return [base + ((d - off) % n) for d in range(n)]


def _reader(ctrl: _Control, cfg: StreamConfig, source, lanes: List[_Lane],
            start_frame: int, meter: _InflightMeter, witness=None) -> None:
    """Read frame ``i`` into a staging slot of lane ``(i - start) % n``,
    with the single-device reader's CRC, tear site and witness copy."""
    n = len(lanes)
    idx = start_frame
    read_frame = _sengine._make_read_frame(cfg, source)
    fault_corrupt = _faults.site("integrity.corrupt_ingest")
    try:
        while cfg.frames is None or idx < cfg.frames:
            lane = lanes[(idx - start_frame) % n]
            bi = ctrl.get(lane.slots.free_q)
            with ctrl.stage("read", idx):
                ok = read_frame(idx, lane.slots.views[bi])
            if not ok:
                if cfg.frames is not None:
                    raise IOError(
                        f"stream ended after {idx} frame(s); "
                        f"--frames promised {cfg.frames}"
                    )
                lane.slots.free_q.put(bi)
                break
            crc, wit = _sengine._stage_in(lane.slots.views[bi], cfg, idx,
                                          witness, fault_corrupt)
            meter.inc()
            ctrl.put(lane.filled_q, (idx, bi, crc, wit))
            idx += 1
        for lane in lanes:
            ctrl.put(lane.filled_q, _EOF)
    except _sengine._Abort:
        pass
    except BaseException as e:
        ctrl.fail("read", idx, e)


def _dispatcher(ctrl: _Control, cfg: StreamConfig, lane: _Lane,
                launch: Callable, dev_index: int) -> None:
    """One lane's copy and launch loop, bounded by its in-flight queue."""
    idx, stage = -1, "h2d"
    slots = lane.slots
    fault_h2d = _faults.site("h2d")
    fault_compute = _faults.site("compute")
    try:
        while True:
            item = ctrl.get(lane.filled_q)
            if item is _EOF:
                ctrl.put(lane.inflight_q, _EOF)
                return
            idx, bi, crc, wit = item
            stage = "h2d"
            if fault_h2d is not None:
                fault_h2d(idx)
            _sengine._verify_staged(slots.views[bi], crc, idx)
            with ctrl.stage("h2d", idx, dev=dev_index):
                dev, ev = slots.h2d(bi)
            slots.free_q.put(bi)  # the copy has landed
            stage = "compute"
            if fault_compute is not None:
                fault_compute(idx)
            t_disp = time.perf_counter()
            out, done = slots.launch(launch, dev, ev)
            del dev
            ctrl.put(lane.inflight_q, (idx, out, done, t_disp, wit))
            del out
    except _sengine._Abort:
        pass
    except BaseException as e:
        ctrl.fail(stage, max(idx, 0), e)


def _drainer(ctrl: _Control, cfg: StreamConfig, lane: _Lane,
             dev_index: int, meter: _InflightMeter) -> None:
    """Wait for one lane's compute in its order (watchdogged), copy the
    result into an output slot, hand it to the writer's merge."""
    idx, stage = -1, "compute"
    slots = lane.slots
    fault_d2h = _faults.site("d2h")
    fault_corrupt = _faults.site("integrity.corrupt_result")
    timeout_s = _deadline.resolve(cfg.dispatch_timeout_s)
    try:
        while True:
            item = ctrl.get(lane.inflight_q)
            if item is _EOF:
                ctrl.put(lane.done_q, _EOF)
                return
            idx, out, done, t_disp, wit = item
            stage = "compute"
            with ctrl.stage("compute", idx, t0=t_disp, dev=dev_index):
                _deadline.fence(
                    out if done is None else done, timeout_s,
                    f"stream.compute[frame={idx},dev={dev_index}]",
                )
            stage = "d2h"
            oi = ctrl.get(slots.out_free_q)
            with ctrl.stage("d2h", idx, dev=dev_index):
                if fault_d2h is not None:
                    fault_d2h(idx)
                arr = slots.d2h(out, done, oi)
            del out
            if fault_corrupt is not None and _checksum.fired(
                    fault_corrupt, idx):
                _checksum.corrupt_array(arr)
            meter.dec()
            ctrl.put(lane.done_q, (idx, oi, wit))
    except _sengine._Abort:
        pass
    except BaseException as e:
        ctrl.fail(stage, max(idx, 0), e)


def _writer(ctrl: _Control, cfg: StreamConfig, sink, lanes: List[_Lane],
            start_frame: int, done: list) -> None:
    """Frame ``i`` from lane ``(i - start) % n``, written in order, counted
    and checkpointed with the per-device cursors. ``done[0]`` tracks the
    frames fully written (global index)."""
    n = len(lanes)
    idx = start_frame
    write_frame = _sengine._make_write_frame(cfg, sink)
    try:
        while True:
            lane = lanes[(idx - start_frame) % n]
            item = ctrl.get(lane.done_q)
            if item is _EOF:
                return
            got, oi, wit = item
            assert got == idx, (got, idx)  # per-lane FIFO + round-robin
            arr = lane.slots.out_views[oi].reshape(cfg.frame_shape)
            if wit is not None:
                _sengine._witness_frame(cfg, idx, wit, arr,
                                        lane.slots.device)
            with ctrl.stage("write", idx):
                write_frame(idx, arr)
            lane.slots.out_free_q.put(oi)
            lane.frames += 1
            done[0] = idx + 1
            obs.registry().counter("stream_frames_total").inc()
            if cfg.checkpoint_every and done[0] % cfg.checkpoint_every == 0:
                from tpu_stencil_torch.runtime import checkpoint as ckpt

                _sengine._commit_progress(
                    cfg, sink, done[0],
                    lambda k: ckpt.save_stream_progress(
                        cfg, k, mesh_devices=n,
                        cursors=device_cursors(k, start_frame, n)))
            if cfg.progress_every and done[0] % cfg.progress_every == 0:
                print(f"stream: frame {done[0]}", file=sys.stderr,
                      flush=True)
            idx += 1
    except _sengine._Abort:
        pass
    except BaseException as e:
        ctrl.fail("write", max(idx, start_frame), e)


def _compute_streams(devices) -> dict:
    """One compute stream per distinct CUDA device (lanes on a device
    share it); nothing on the CPU."""
    return {d: torch.cuda.Stream(d) for d in dict.fromkeys(devices)
            if d.type == "cuda"}


def run_mesh_frames(cfg: StreamConfig, devices, n: int, model,
                    source, sink, start_frame: int) -> dict:
    """One fan pipeline lifetime over ``n`` devices. The caller
    (:func:`tpu_stencil_torch.stream.engine._run_stream_once`) owns the
    source and sink, resume and the result; this returns ``{"frames",
    "stage_seconds", "per_device_frames", "backend", "schedule"}`` or
    raises :class:`~tpu_stencil_torch.stream.engine.StreamFailure`."""
    devices = [torch.device(d) for d in list(devices)[:n]]
    if len(devices) < n:
        raise ValueError(
            f"--mesh-frames asks for {n} devices, have {len(devices)}"
        )
    # Resolved and built once, here, before any lane starts.
    model.prepare((cfg.height, cfg.width), cfg.channels)
    launch, backend, schedule = _sengine.build_launch(model, cfg)
    ctrl = _Control()
    streams = _compute_streams(devices)
    lanes = [_Lane(cfg, d, streams.get(d)) for d in devices]
    done = [start_frame]
    meter = _InflightMeter()
    witness = _sengine.witness_sampler(cfg)
    threads = [
        threading.Thread(
            target=_reader,
            args=(ctrl, cfg, source, lanes, start_frame, meter, witness),
            name="fanout-reader", daemon=True,
        ),
        threading.Thread(
            target=_writer,
            args=(ctrl, cfg, sink, lanes, start_frame, done),
            name="fanout-writer", daemon=True,
        ),
    ]
    for d, lane in enumerate(lanes):
        threads.append(threading.Thread(
            target=_dispatcher, args=(ctrl, cfg, lane, launch, d),
            name=f"fanout-dispatch-{d}", daemon=True,
        ))
        threads.append(threading.Thread(
            target=_drainer, args=(ctrl, cfg, lane, d, meter),
            name=f"fanout-drain-{d}", daemon=True,
        ))
    try:
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive() and not ctrl.stop.is_set():
                t.join(timeout=0.1)
    finally:
        ctrl.stop.set()
        for t in threads:
            t.join(timeout=1.0)
        meter.zero()
    if ctrl.failure is not None:
        stage, frame_index, cause = ctrl.failure
        raise _sengine.StreamFailure(stage, frame_index, cause) from cause
    return {
        "frames": done[0] - start_frame,
        "stage_seconds": dict(ctrl.stage_seconds),
        "per_device_frames": [lane.frames for lane in lanes],
        "backend": backend,
        "schedule": schedule,
    }


def measure_fanout_ab(cfg: StreamConfig, devices,
                      frames: int = PROBE_FRAMES) -> Tuple[float, float]:
    """The measured one-device-against-fan A/B behind ``--mesh-frames 0``:
    a synthetic stream (seeded random frames, null sink) once warm and
    once timed at ``cfg.pipeline_depth`` on 1 device and on
    ``len(devices)``, over the same frame count (at least one per device).
    Returns ``(single_seconds, mesh_seconds)``. Its counters and spans go
    to a scratch registry."""
    frames = max(frames, len(devices))
    frame = np.random.default_rng(0).integers(0, 256, cfg.frame_bytes,
                                              dtype=np.uint8)

    class _Synth(frames_io.FrameSource):
        def __init__(self, k: int) -> None:
            self._left = k

        def read_into(self, buf) -> bool:
            if self._left <= 0:
                return False
            np.copyto(buf, frame)
            self._left -= 1
            return True

    def one(n_dev: int) -> float:
        pcfg = dataclasses.replace(
            cfg, frames=frames, mesh_frames=max(1, n_dev), output="null",
            checkpoint_every=0, progress_every=0,
        )
        _sengine.run_stream(pcfg, devices=list(devices),
                            source=_Synth(frames), sink=frames_io.NullSink())
        t0 = time.perf_counter()
        _sengine.run_stream(pcfg, devices=list(devices),
                            source=_Synth(frames), sink=frames_io.NullSink())
        return time.perf_counter() - t0

    with obs.scratch_registry():
        return one(1), one(len(devices))


def resolve_mesh_frames(cfg: StreamConfig, devices,
                        measure: Optional[Callable] = None) -> int:
    """``cfg.mesh_frames`` resolved to the device count that runs: an
    explicit ``N > 1`` (failing loudly when fewer devices exist); ``0``
    (auto) runs the measured A/B (:func:`measure_fanout_ab`, or the
    injected ``measure``) and fans only when the fan measured strictly
    faster. The real probe's verdict persists in the autotune cache
    (:func:`tpu_stencil_torch.runtime.autotune.cached_stream_verdict`), so
    a warm cache decides with zero probe frames; an injected ``measure``
    bypasses the cache both ways."""
    n_avail = len(devices)
    if cfg.mesh_frames == 1:
        return 1
    if cfg.mesh_frames > 1:
        if n_avail < cfg.mesh_frames:
            raise ValueError(
                f"--mesh-frames asks for {cfg.mesh_frames} devices, "
                f"have {n_avail}"
            )
        return cfg.mesh_frames
    if n_avail < 2:
        return 1
    from tpu_stencil_torch.runtime import autotune

    geometry = (cfg.height, cfg.width, cfg.channels)
    topo = f"ndev{n_avail}"
    token = autotune.stream_cfg_token(cfg)
    if measure is None:
        hit = autotune.cached_stream_verdict(
            "fanout", geometry, cfg.repetitions, cfg.pipeline_depth,
            topo, token, device=devices[0],
        )
        if hit is not None and 1 <= int(hit["pick"]) <= n_avail:
            pick = int(hit["pick"])
            print(
                f"stream: --mesh-frames auto verdict from warm cache -> "
                f"{'fan-out ' + str(pick) if pick > 1 else 'single-device'}"
                f" (zero probe frames)",
                file=sys.stderr, flush=True,
            )
            return pick
    t_single, t_mesh = (measure or measure_fanout_ab)(cfg, devices)
    pick = n_avail if t_mesh < t_single else 1
    if measure is None:
        autotune.store_stream_verdict(
            "fanout", geometry, cfg.repetitions, cfg.pipeline_depth, topo,
            {"pick": pick, "single_us": round(t_single * 1e6, 2),
             "mesh_us": round(t_mesh * 1e6, 2)},
            token, device=devices[0],
        )
    print(
        f"stream: --mesh-frames auto measured single={t_single:.3f}s "
        f"mesh[{n_avail}]={t_mesh:.3f}s -> "
        f"{'fan-out ' + str(n_avail) if pick > 1 else 'single-device'}",
        file=sys.stderr, flush=True,
    )
    return pick
