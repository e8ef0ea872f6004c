"""Pipelined frame streaming: the three-axis composed engine.

The port's counterpart of the JAX package's ``stream/pipelined.py``. It
drives :class:`tpu_stencil_torch.parallel.pipeline.PipelineRunner` from
the stream and composes the three placement axes in one run:

* **frame lanes** (``--mesh-frames G``): G independent pipeline groups,
  frame ``i`` to group ``(i - start) % G``, merged in order by one writer;
* **temporal stages** (``--pipe-stages K``): each group's rep loop split
  into K stages, one frame per stage, one hand-off per tick;
* **spatial shards** (``--shard-frames RxC``): each stage an R x C grid of
  tiles running the sharded path's torch-ops step.

A group takes ``K * R * C`` devices, the run ``G * K * R * C``. ``K == 1``
with ``G > 1`` and ``R * C > 1`` is the fan of sharded groups: the
pipeline with no fill.

The machine:

* **one reader thread**: the fan-out's
  (:func:`tpu_stencil_torch.parallel.fanout._reader`): frames dealt to the
  groups' lanes, CRC'd at ingest, witness-sampled.
* **a dispatch thread per group**: owns the fill and drain. It scatters
  the staged frame into stage 0's tiles (pad zeroed once), copies each
  tile to its device under its own ``stream.h2d`` span, and runs one tick
  on the compute streams. Pending frame indices map ticks to finished
  frames: the frame fed at tick ``t`` leaves the last stage at tick ``t +
  K - 1``, so once ``K`` ticks have run each tick hands the oldest pending
  frame to the drain; after the lane's end, zero-input ticks run until
  none is pending, so a stream of fewer than K frames gives every frame.
* **a drain thread per group**: waits for the tick (the dispatch
  watchdog), copies back the last stage's shards only, under a ``d2h``
  span each, and crops the pad off into an output slot.
* **one writer thread**: the fan-out's, committing the full (G, K, RxC)
  topology into the progress sidecar, so a ``--resume`` under any other
  fails typed (``MeshCursorMismatch``).

Failure semantics, fault sites, stage spans and the restart loop are the
engines' shared ones (:mod:`tpu_stencil_torch.stream.engine` owns the
loop around this module).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import torch

from tpu_stencil_torch import obs
from tpu_stencil_torch.config import StreamConfig
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.parallel import fanout as _fanout
from tpu_stencil_torch.resilience import deadline as _deadline
from tpu_stencil_torch.resilience import faults as _faults
from tpu_stencil_torch.stream import engine as _sengine
from tpu_stencil_torch.stream import sharded as _shardstream

_EOF = _fanout._EOF
_Control = _fanout._Control
_Lane = _fanout._Lane


class _GroupPlumbing:
    """One group's device side: the cached runner, and the tile copies of
    stage 0 (in) and of the last stage (out), laid out from the runner's
    own tile grid (every stage shares the spatial layout)."""

    def __init__(self, cfg: StreamConfig, runner, slots) -> None:
        self.runner = runner
        self.streams = _shardstream.device_streams(runner.devices, slots)
        self.io = _shardstream.TileIO(
            cfg, _shardstream.grid_specs(runner.tile, runner.shard_shape),
            runner.stage0_devices, runner.last_devices, self.streams)

    def launch(self, fn):
        """``fn()`` on every device's compute stream of the group."""
        return _shardstream.launch(self.streams, fn)


def _dispatch(ctrl: _Control, cfg: StreamConfig, lane: _Lane,
              pb: _GroupPlumbing, g: int) -> None:
    """One group's tick loop, owning the fill and drain."""
    runner, io = pb.runner, pb.io
    slots = lane.slots
    k = runner.stages
    nsp = len(runner.stage0_devices)
    reps = cfg.repetitions
    idx, stage = -1, "compute"
    fault_h2d = _faults.site("h2d")
    fault_compute = _faults.site("compute")
    try:
        carry, _ = pb.launch(lambda: runner.warm(reps))
        zero = runner.zero_input()
        pending: deque = deque()
        ticks = 0

        def tick(inp):
            nonlocal carry, ticks
            (carry, out), done = pb.launch(
                lambda: runner.tick(carry, inp, reps))
            ticks += 1
            if ticks >= k:
                fidx, fwit, ft = pending.popleft()
                ctrl.put(lane.inflight_q, (fidx, out, done, ft, fwit))

        while True:
            item = ctrl.get(lane.filled_q)
            if item is _EOF:
                break
            idx, bi, crc, wit = item
            stage = "h2d"
            if fault_h2d is not None:
                fault_h2d(idx)
            _sengine._verify_staged(slots.views[bi], crc, idx)
            tiles = io.scatter.scatter(slots.views[bi])
            slots.free_q.put(bi)  # the scatter consumed the slot
            tile_crcs = ([_checksum.native_crc32c(t) for t in tiles]
                         if cfg.verify_ingest else [None] * len(tiles))
            xs = []
            for d, tile in enumerate(tiles):
                _sengine._verify_staged(tile, tile_crcs[d], idx)
                with ctrl.stage("h2d", idx, dev=g * nsp + d):
                    xs.append(io.h2d(d))
            stage = "compute"
            if fault_compute is not None:
                fault_compute(idx)
            pending.append((idx, wit, time.perf_counter()))
            inp = runner.assemble_input(xs)
            del xs
            tick(inp)
            del inp
        # The lane ended: zero-input ticks until every fed frame has left
        # the last stage (K - 1 of them after a long stream).
        stage = "compute"
        while pending:
            tick(zero)
        ctrl.put(lane.inflight_q, _EOF)
    except _sengine._Abort:
        pass
    except BaseException as e:
        ctrl.fail(stage, max(idx, 0), e)


def _drainer(ctrl: _Control, cfg: StreamConfig, lane: _Lane,
             pb: _GroupPlumbing, g: int,
             meter: "_fanout._InflightMeter") -> None:
    """Wait for one group's ticks in order (watchdogged), copy back the
    last stage's shards, crop the pad off into an output slot, hand the
    frame to the writer's merge."""
    idx, stage = -1, "compute"
    slots, io = lane.slots, pb.io
    nsp = len(io.out_devices)
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
            with ctrl.stage("compute", idx, t0=t_disp, dev=g):
                _deadline.fence(
                    out if done is None else done, timeout_s,
                    f"stream.compute[frame={idx},pipe-group={g}]")
            stage = "d2h"
            oi = ctrl.get(slots.out_free_q)
            frame = slots.out_views[oi].reshape(cfg.frame_shape)
            for d, t in enumerate(_shardstream.flat_tiles(out)):
                with ctrl.stage("d2h", idx, dev=g * nsp + d):
                    if fault_d2h is not None:
                        fault_d2h(idx)
                    piece = io.d2h(d, t, done)
                io.scatter.gather_into(frame, [(d, piece)])
            del out
            if fault_corrupt is not None and _checksum.fired(
                    fault_corrupt, idx):
                _checksum.corrupt_array(frame)
            meter.dec()
            ctrl.put(lane.done_q, (idx, oi, wit))
    except _sengine._Abort:
        pass
    except BaseException as e:
        ctrl.fail(stage, max(idx, 0), e)


def run_pipelined_stream(cfg: StreamConfig, devices, groups: int,
                         stages: int, shard: Optional[Tuple[int, int]],
                         model, source, sink, start_frame: int) -> dict:
    """One pipelined-stream lifetime over ``groups`` x ``stages`` x RxC.
    The caller (:func:`tpu_stencil_torch.stream.engine._run_stream_once`)
    owns the source and sink, resume and the result; this returns
    ``{"frames", "stage_seconds", "per_device_frames", "backend",
    "schedule", "n_devices"}`` or raises :class:`~tpu_stencil_torch.
    stream.engine.StreamFailure`. Each group's runner comes from the
    process-shared runner cache."""
    from tpu_stencil_torch.parallel import pipeline as _ppipe
    from tpu_stencil_torch.runtime import checkpoint as ckpt

    r, c = shard if shard else (1, 1)
    per_group = stages * r * c
    need = groups * per_group
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(
            f"pipelined topology {groups} group(s) x {stages} stage(s) x "
            f"{r}x{c} shard needs {need} devices, have {len(devices)}"
        )
    runners = []
    for g in range(groups):
        runner = _ppipe.shared_pipeline_runner(
            model, (cfg.height, cfg.width), cfg.channels, stages,
            shard_shape=(r, c),
            devices=devices[g * per_group:(g + 1) * per_group],
            registry=obs.registry(),
        )
        if runner is None:
            raise ValueError(
                f"--pipe-stages {stages} with shard {r}x{c} cannot serve a "
                f"{cfg.height}x{cfg.width} frame: the per-device tile is "
                f"smaller than the filter halo (or the boundary refuses "
                f"padding); use a smaller shard grid or a larger frame"
            )
        runners.append(runner)
    ctrl = _Control()
    streams = _fanout._compute_streams(
        [rn.stage0_devices[0] for rn in runners])
    lanes = [_Lane(cfg, rn.stage0_devices[0],
                   streams.get(rn.stage0_devices[0])) for rn in runners]
    plumbing: List[_GroupPlumbing] = [
        _GroupPlumbing(cfg, rn, lane.slots)
        for rn, lane in zip(runners, lanes)]
    done = [start_frame]
    meter = _fanout._InflightMeter()
    witness = _sengine.witness_sampler(cfg)

    def save_progress(frames_done: int) -> None:
        ckpt.save_stream_progress(
            cfg, frames_done, mesh_devices=groups,
            cursors=(_fanout.device_cursors(frames_done, start_frame, groups)
                     if groups > 1 else None),
            shard_frames=shard, pipe_stages=stages,
        )

    threads = [
        threading.Thread(
            target=_fanout._reader,
            args=(ctrl, cfg, source, lanes, start_frame, meter, witness),
            name="pipelined-reader", daemon=True),
        threading.Thread(
            target=_fanout._writer,
            args=(ctrl, cfg, sink, lanes, start_frame, done, save_progress),
            name="pipelined-writer", daemon=True),
    ]
    for g, (lane, pb) in enumerate(zip(lanes, plumbing)):
        threads.append(threading.Thread(
            target=_dispatch, args=(ctrl, cfg, lane, pb, g),
            name=f"pipelined-dispatch-{g}", daemon=True))
        threads.append(threading.Thread(
            target=_drainer, args=(ctrl, cfg, lane, pb, g, meter),
            name=f"pipelined-drain-{g}", daemon=True))
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
        "backend": runners[0].backend,
        "schedule": runners[0].schedule,
        "n_devices": need,
    }
