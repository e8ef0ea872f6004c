"""Spatially sharded frames inside the stream (``--shard-frames RxC``).

The port's counterpart of the JAX package's ``stream/sharded.py``. The fan
(``--mesh-frames``) deals whole frames over devices, so one device must
still hold a frame; here every frame in flight is cut over an R x C mesh
of devices and runs through the sharded runner
(:class:`tpu_stencil_torch.parallel.sharded.ShardedRunner`, K3 under every
``--overlap`` mode), so a frame too large for one device streams, byte for
byte as on one device (the reference's MPI variant exists for this: one
worker cannot hold the whole image).

The machine:

* **reader thread**: the single-device engine's
  (:func:`tpu_stencil_torch.stream.engine._reader`): whole frames into the
  pinned staging ring, CRC'd at ingest, witness-sampled.
* **dispatch** (the calling thread): re-verifies the ring slot's CRC,
  scatters the slot into one pinned host tile per mesh position
  (:class:`~tpu_stencil_torch.stream.frames.TileScatter`: pad zeroed once,
  each tile rewritten only after its previous copy to the card landed),
  CRCs each tile and re-verifies it just before its upload, copies each
  tile to its device on the copy stream under its own ``stream.h2d`` span
  (``dev=`` the tile), then runs the runner on the compute stream (made
  the current stream of every device of the mesh).
* **drain thread**: waits for the frame's compute (the dispatch
  watchdog), copies each shard back on the D2H stream under its own
  ``stream.d2h`` span, and crops the pad off into an output slot.
* **writer thread**: the single-device engine's, committing the RxC shard
  topology into the progress sidecar, so a ``--resume`` under another
  topology fails typed (``MeshCursorMismatch``).

The runner comes from the process-shared runner cache
(:func:`tpu_stencil_torch.parallel.sharded.shared_runner`), under the
routing of the JAX package: a frame below ``shard_min_pixels`` runs on one
device. ``--shard-frames 0`` (auto) shards without a probe when the frame
cannot stream on one device (:func:`tpu_stencil_torch.runtime.roofline.
hbm_frame_feasible`), else decides by a measured A/B
(:func:`measure_shard_ab`) and shards only on a measured win; the verdict
persists in the autotune cache.

Streams and slots: a tile's device copy is made on the copy stream and
read on the compute stream, and each output tile (under ``edge`` a view
of the slab the runner builds per call) is made on the compute stream and
its side streams and read on the D2H stream: ``record_stream`` hands each
over, and the drain holds a frame's output until its D2H landed, so two
frames in flight never share a slab. On the CPU the same threads run with
plain host tensors and no streams.
"""

from __future__ import annotations

import contextlib
import dataclasses
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

_EOF = _sengine._EOF

# Frames per arm of the auto (--shard-frames 0) measured A/B.
PROBE_FRAMES = 3


def resolve_shard_frames(cfg: StreamConfig, devices,
                         measure: Optional[Callable] = None
                         ) -> Optional[Tuple[int, int]]:
    """``cfg.shard_frames`` resolved to the RxC that runs, or None (one
    device). A frame below ``shard_min_pixels`` stays on one device even
    under an explicit RxC; an explicit RxC above it runs (failing when
    fewer than R*C devices exist); ``(0, 0)`` (auto) shards without a
    probe when one device cannot hold the frame's working set, else runs
    the measured A/B (:func:`measure_shard_ab`, or the injected
    ``measure``) and shards only when the sharded arm was strictly faster.
    The real probe's verdict persists in the autotune cache; an injected
    ``measure`` bypasses the cache both ways."""
    if cfg.shard_frames is None:
        return None
    if cfg.width * cfg.height < cfg.shard_min_pixels:
        print(
            f"stream: --shard-frames: {cfg.width}x{cfg.height} frame is "
            f"below the routing threshold ({cfg.shard_min_pixels} px) "
            f"-> single-device",
            file=sys.stderr, flush=True,
        )
        return None
    n_avail = len(devices)
    if cfg.shard_frames != (0, 0):
        r, c = cfg.shard_frames
        if r * c > n_avail:
            raise ValueError(
                f"--shard-frames {r}x{c} asks for {r * c} devices, "
                f"have {n_avail}"
            )
        return (r, c)
    if n_avail < 2:
        return None
    from tpu_stencil_torch.parallel import partition
    from tpu_stencil_torch.runtime import autotune, roofline

    mesh_shape = tuple(partition.grid_shape(n_avail, cfg.height, cfg.width))
    if not roofline.hbm_frame_feasible(cfg.frame_bytes, cfg.pipeline_depth):
        print(
            f"stream: --shard-frames auto: frame working set exceeds the "
            f"per-device memory bound ({roofline.device_hbm_bytes()} "
            f"bytes) -> shard {mesh_shape[0]}x{mesh_shape[1]} (no probe: "
            f"the single-device arm cannot run)",
            file=sys.stderr, flush=True,
        )
        return mesh_shape
    geometry = (cfg.height, cfg.width, cfg.channels)
    topo = f"mesh{mesh_shape[0]}x{mesh_shape[1]}"
    token = autotune.stream_cfg_token(cfg)
    if measure is None:
        hit = autotune.cached_stream_verdict(
            "shardstream", geometry, cfg.repetitions, cfg.pipeline_depth,
            topo, token, device=devices[0])
        if hit is not None and (
            hit["pick"] == 0
            or (isinstance(hit["pick"], list) and len(hit["pick"]) == 2
                and hit["pick"][0] * hit["pick"][1] <= n_avail)
        ):
            pick = None if hit["pick"] == 0 else tuple(hit["pick"])
            print(
                f"stream: --shard-frames auto verdict from warm cache -> "
                f"{'shard ' + topo[4:] if pick else 'single-device'}"
                f" (zero probe frames)",
                file=sys.stderr, flush=True,
            )
            return pick
    t_single, t_shard = (measure or measure_shard_ab)(cfg, devices,
                                                       mesh_shape)
    pick = mesh_shape if t_shard < t_single else None
    if measure is None:
        autotune.store_stream_verdict(
            "shardstream", geometry, cfg.repetitions, cfg.pipeline_depth,
            topo,
            {"pick": list(pick) if pick else 0,
             "single_us": round(t_single * 1e6, 2),
             "shard_us": round(t_shard * 1e6, 2)},
            token, device=devices[0])
    print(
        f"stream: --shard-frames auto measured single={t_single:.3f}s "
        f"shard[{mesh_shape[0]}x{mesh_shape[1]}]={t_shard:.3f}s -> "
        f"{'shard ' + topo[4:] if pick else 'single-device'}",
        file=sys.stderr, flush=True,
    )
    return pick


def measure_shard_ab(cfg: StreamConfig, devices,
                     mesh_shape: Tuple[int, int],
                     frames: int = PROBE_FRAMES) -> Tuple[float, float]:
    """The measured one-device-against-sharded A/B behind
    ``--shard-frames 0``: a synthetic stream (seeded random frames, null
    sink) once warm and once timed at ``cfg.pipeline_depth``, on one
    device and sharded over ``mesh_shape``. Returns ``(single_seconds,
    shard_seconds)``. Its counters and spans go to a scratch registry."""
    def one(shard) -> float:
        return _sengine.probe_seconds(dataclasses.replace(
            cfg, frames=frames, shard_frames=shard, shard_min_pixels=1,
            output="null", checkpoint_every=0, progress_every=0), devices)

    with obs.scratch_registry():
        return one(None), one(tuple(mesh_shape))


class _Events:
    """The completion of one launch over the devices of a mesh: one CUDA
    event per distinct device."""

    def __init__(self, events: dict) -> None:
        self.events = events

    def synchronize(self) -> None:
        for ev in self.events.values():
            ev.synchronize()


def device_streams(devices, slots: "_sengine._Slots") -> dict:
    """``{device: (copy, compute, d2h)}`` per distinct CUDA device of
    ``devices`` (``slots``' own streams for its device); empty on the
    CPU."""
    streams = {}
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type != "cuda":
            continue
        if slots.cuda and dev == slots.device:
            streams[dev] = (slots.copy_stream, slots.compute_stream,
                            slots.d2h_stream)
        else:
            streams[dev] = tuple(torch.cuda.Stream(dev) for _ in range(3))
    return streams


def launch(streams: dict, fn: Callable):
    """``fn()`` with every device's compute stream of ``streams`` as its
    current stream. Returns (its value, an :class:`_Events` of its
    completion, or None on the CPU)."""
    if not streams:
        return fn(), None
    with contextlib.ExitStack() as stack:
        for _, compute, _ in streams.values():
            stack.enter_context(torch.cuda.stream(compute))
        out = fn()
        events = {}
        for dev, (_, compute, _) in streams.items():
            events[dev] = torch.cuda.Event()
            events[dev].record(compute)
    return out, _Events(events)


class TileIO:
    """The copies of a frame cut into tiles, one per mesh position: the
    pinned staging tiles (:class:`~tpu_stencil_torch.stream.frames.
    TileScatter`) that tile ``d`` goes from to ``in_devices[d]``, and one
    pinned host tile per shard that shard ``d``'s result comes back into
    from ``out_devices[d]``, on the devices' streams (:func:`device_streams`).
    The sharded stream holds one; each group of the temporal pipeline one,
    stage 0 in and the last stage out."""

    def __init__(self, cfg: StreamConfig, specs, in_devices, out_devices,
                 streams: dict) -> None:
        self.in_devices = [torch.device(d) for d in in_devices]
        self.out_devices = [torch.device(d) for d in out_devices]
        self.streams = streams
        self.cuda = bool(streams)
        self.scatter = frames_io.TileScatter(cfg.frame_shape, specs,
                                             pin=self.cuda)
        self.host = ([torch.empty(t.shape, dtype=torch.uint8,
                                  pin_memory=True)
                      for t in self.scatter.tensors] if self.cuda else [])

    def h2d(self, d: int) -> torch.Tensor:
        """Staging tile ``d`` on its device, the copy landed (the caller's
        span holds it); handed to the compute stream."""
        src = self.scatter.tensors[d]
        if not self.cuda:
            return src.clone()
        dev = self.in_devices[d]
        copy, compute, _ = self.streams[dev]
        with torch.cuda.stream(copy):
            x = torch.empty(src.shape, dtype=torch.uint8, device=dev)
            x.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy)
        self.scatter.uploaded(d, ev)
        ev.synchronize()
        x.record_stream(compute)
        return x

    def d2h(self, d: int, t: torch.Tensor, done) -> np.ndarray:
        """Shard ``d``'s result ``t`` on the host, after ``done``, the copy
        waited for."""
        if not self.cuda:
            return t.numpy()
        dev = self.out_devices[d]
        d2h = self.streams[dev][2]
        t.record_stream(d2h)
        with torch.cuda.stream(d2h):
            d2h.wait_event(done.events[dev])
            self.host[d].copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(d2h)
        ev.synchronize()
        return self.host[d].numpy()


def grid_specs(tile: Tuple[int, int], grid: Tuple[int, int]) -> list:
    """The ``(rows, cols)`` windows of the padded canvas, row-major, of a
    ``grid`` of ``tile``-sized tiles."""
    (th, tw), (r, c) = tile, grid
    return [(slice(i * th, (i + 1) * th), slice(j * tw, (j + 1) * tw))
            for i in range(r) for j in range(c)]


def as_grid(flat: list, grid: Tuple[int, int]) -> list:
    r, c = grid
    return [flat[i * c:(i + 1) * c] for i in range(r)]


def flat_tiles(grid) -> List[torch.Tensor]:
    return [x for row in grid for x in row]


class _ShardPlumbing:
    """The device side of one sharded stream: the cached runner and the
    tile copies laid out from the runner's own tile grid (the staging
    views cannot drift from what the runner expects)."""

    def __init__(self, cfg: StreamConfig, runner, slots) -> None:
        self.runner = runner
        self.grid = runner.mesh_shape
        self.streams = device_streams(runner.devices, slots)
        self.io = TileIO(cfg, grid_specs(runner.tile, self.grid),
                         runner.devices, runner.devices, self.streams)


def _dispatch(pl, cfg: StreamConfig, pb: _ShardPlumbing) -> None:
    """The dispatch loop on the calling thread: build K3 and warm the
    runner up on zero tiles (one chunk of each depth the frames run),
    then scatter, copy and launch each filled frame inside the window."""
    from tpu_stencil_torch.obs.tracing import fence

    runner, io, slots = pb.runner, pb.io, pl.slots
    idx, stage = -1, "compute"
    fault_h2d = _faults.site("h2d")
    fault_compute = _faults.site("compute")
    try:
        runner.prepare()
        depths = runner.warm_reps([cfg.repetitions])

        def warm():
            zeros = [torch.zeros(t.shape, dtype=torch.uint8, device=dev)
                     for t, dev in zip(io.scatter.tensors, io.in_devices)]
            return runner.warmup(as_grid(zeros, pb.grid), depths)

        fence(launch(pb.streams, warm)[0])
        while True:
            item = pl.get(pl.filled_q)
            if item is _EOF:
                break
            idx, bi, crc, wit = item
            stage = "h2d"
            if fault_h2d is not None:
                fault_h2d(idx)
            # The ring slot's re-verification, then each tile's: CRC'd at
            # the scatter and re-verified just before its own upload.
            _sengine._verify_staged(slots.views[bi], crc, idx)
            tiles = io.scatter.scatter(slots.views[bi])
            slots.free_q.put(bi)  # the scatter consumed the slot
            tile_crcs = ([_checksum.native_crc32c(t) for t in tiles]
                         if cfg.verify_ingest else [None] * len(tiles))
            xs = []
            for d, tile in enumerate(tiles):
                _sengine._verify_staged(tile, tile_crcs[d], idx)
                with pl.stage("h2d", idx, dev=d):
                    xs.append(io.h2d(d))
            stage = "compute"
            if fault_compute is not None:
                fault_compute(idx)
            t_disp = time.perf_counter()
            grid = as_grid(xs, pb.grid)
            del xs
            out, done = launch(pb.streams,
                               lambda: runner.run(grid, cfg.repetitions))
            del grid
            pl.put(pl.inflight_q, (idx, out, done, t_disp, wit))
            del out
        pl.put(pl.inflight_q, _EOF)
    except _sengine._Abort:
        pass
    except BaseException as e:
        pl.fail(stage, max(idx, 0), e)


def _drain(pl, cfg: StreamConfig, pb: _ShardPlumbing) -> None:
    """Wait for each frame's compute in dispatch order (watchdogged), copy
    each shard back under its own span, crop the pad off into an output
    slot, free the window slot, hand the frame to the writer."""
    idx, stage = -1, "compute"
    slots, io = pl.slots, pb.io
    fault_d2h = _faults.site("d2h")
    fault_corrupt = _faults.site("integrity.corrupt_result")
    timeout_s = _deadline.resolve(cfg.dispatch_timeout_s)
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
                                f"stream.compute[frame={idx},shard]")
            stage = "d2h"
            oi = pl.get(slots.out_free_q)
            frame = slots.out_views[oi].reshape(cfg.frame_shape)
            for d, t in enumerate(flat_tiles(out)):
                with pl.stage("d2h", idx, dev=d):
                    if fault_d2h is not None:
                        fault_d2h(idx)
                    piece = io.d2h(d, t, done)
                io.scatter.gather_into(frame, [(d, piece)])
            del out
            if fault_corrupt is not None and _checksum.fired(
                    fault_corrupt, idx):
                _checksum.corrupt_array(frame)
            pl.release_window()
            pl.put(pl.write_q, (idx, oi, wit))
    except _sengine._Abort:
        pass
    except BaseException as e:
        pl.fail(stage, max(idx, 0), e)


def run_shard_stream(cfg: StreamConfig, devices, shard: Tuple[int, int],
                     model, source, sink, start_frame: int) -> dict:
    """One sharded-stream pipeline lifetime over the ``shard`` = (R, C)
    mesh. The caller (:func:`tpu_stencil_torch.stream.engine.
    _run_stream_once`) owns the source and sink, resume and the result;
    this returns ``{"frames", "stage_seconds", "backend", "schedule",
    "n_devices"}`` or raises :class:`~tpu_stencil_torch.stream.engine.
    StreamFailure`."""
    from tpu_stencil_torch.parallel import sharded as _psharded
    from tpu_stencil_torch.runtime import checkpoint as ckpt

    r, c = shard
    devices = [torch.device(d) for d in devices]
    if r * c > len(devices):
        raise ValueError(
            f"--shard-frames {r}x{c} asks for {r * c} devices, "
            f"have {len(devices)}"
        )
    runner = _psharded.shared_runner(
        model, (cfg.height, cfg.width), cfg.channels, mesh_shape=(r, c),
        devices=devices, overlap=cfg.overlap, registry=obs.registry(),
    )
    if runner is None:
        # No path to fall back to mid-stream: a topology the mesh cannot
        # serve fails, naming the constraint.
        raise ValueError(
            f"--shard-frames {r}x{c} cannot serve a {cfg.height}x"
            f"{cfg.width} frame: the per-device tile is smaller than the "
            f"filter halo (or the boundary refuses padding); use a smaller "
            f"mesh or a larger frame"
        )
    pl = _sengine._Pipeline(cfg, devices[0])
    pb = _ShardPlumbing(cfg, runner, pl.slots)
    done = [start_frame]

    def save_progress(frames_done: int) -> None:
        ckpt.save_stream_progress(cfg, frames_done, shard_frames=shard)

    threads = [
        threading.Thread(target=_sengine._reader,
                         args=(pl, source, start_frame),
                         name="shardstream-reader", daemon=True),
        threading.Thread(target=_drain, args=(pl, cfg, pb),
                         name="shardstream-drain", daemon=True),
        threading.Thread(target=_sengine._writer,
                         args=(pl, sink, done, save_progress),
                         name="shardstream-writer", daemon=True),
    ]
    try:
        for t in threads:
            t.start()
        _dispatch(pl, cfg, pb)
        for t in threads:
            while t.is_alive() and not pl.stop.is_set():
                t.join(timeout=0.1)
    finally:
        pl.stop.set()
        for t in threads:
            t.join(timeout=1.0)
        pl.zero_gauge()
    if pl.failure is not None:
        stage, frame_index, cause = pl.failure
        raise _sengine.StreamFailure(stage, frame_index, cause) from cause
    return {
        "frames": done[0] - start_frame,
        "stage_seconds": dict(pl.stage_seconds),
        "backend": runner.backend,
        "schedule": runner.schedule,
        "n_devices": r * c,
    }

