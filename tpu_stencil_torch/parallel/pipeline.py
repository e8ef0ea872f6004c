"""Temporal pipeline parallelism: frames flow through stages of the rep
loop (``--pipe-stages K``).

The port's counterpart of the JAX package's ``parallel/pipeline.py``. The
rep loop is split into K contiguous stages, each on its own slice of the
device list, and frames move through them one stage per tick: per tick
every stage runs its share of the reps (:func:`stage_rep_counts`) on the
frame it holds, then each stage's result is copied into the next stage's
carry (the JAX package's ``lax.ppermute``: a device-to-device copy, or a
copy within the card when the stages share it). At steady state K frames
are in flight and a frame's device time per tick is ``~reps / K`` of the
loop plus one hand-off.

The placement is three-axis: (frame lane) x (temporal stage) x (spatial
shard). Each stage is an R x C grid of tiles running the sharded path's
torch-ops step (:func:`tpu_stencil_torch.parallel.sharded._local_step`:
the halo exchange over the grid, the plan's step, the pad re-zero); at
1 x 1 the exchange is a zero pad. As in the JAX package, whose stage body
is the XLA step, ``backend`` reports ``"xla"``: a stage body through the
hand-written kernels is a future extension in both packages. Frame lanes
(``--mesh-frames``) ride above this module
(:mod:`tpu_stencil_torch.stream.pipelined`).

Exactness: the stage counts partition ``reps`` exactly and every stage
runs the same step, so K stages apply the same operator sequence as one
device. The JAX package runs the remainder rep on every stage and masks
it (every device keeps the same collective sequence); the port has no
collective inside a stage and runs each stage's own count, which moves
the same bytes. Fill and drain are the caller's: F frames take ``F + K -
1`` ticks, the first ``K - 1`` outputs are dropped and zero-input ticks
flush the tail.

Buffers: the carry is written in place every tick, so it never shares
storage with the cached zero tiles (the drain ticks' input) nor with the
tile a tick returns (the finished frame the drain copies back while the
next tick runs).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_stencil_torch.obs.tracing import fence
from tpu_stencil_torch.parallel import partition
from tpu_stencil_torch.parallel.halo import Grid
from tpu_stencil_torch.parallel.sharded import (
    _local_step,
    _map,
    cached_runner,
    runner_key,
)

# Probe stream length of the auto A/B: long enough for a K-stage pipeline
# to reach its steady state (resolve_pipe_stages widens it to 2 * K).
PROBE_FRAMES = 4


def stage_rep_counts(reps: int, stages: int) -> Tuple[int, ...]:
    """The contiguous per-stage rep partition: ``reps // K`` everywhere,
    the first ``reps % K`` stages one more. Sums to ``reps`` for every
    (reps, K); with reps < K the trailing stages run zero reps (a pass
    through)."""
    base, extra = divmod(reps, stages)
    return tuple(base + (1 if s < extra else 0) for s in range(stages))


class PipelineRunner:
    """The stage grids, padding geometry, masks, zero tiles and the tick
    of one (image shape, K, R x C): the temporal sibling of
    :class:`~tpu_stencil_torch.parallel.sharded.ShardedRunner`. Stage ``s``
    holds ``devices[s*R*C:(s+1)*R*C]`` row-major; a device may repeat
    (``[cuda:0] * K`` puts every stage on one card)."""

    def __init__(self, model, image_shape: Tuple[int, int], channels: int,
                 stages: int, shard_shape: Tuple[int, int] = (1, 1),
                 devices: Optional[Sequence] = None) -> None:
        if stages < 1:
            raise ValueError(f"pipe stages must be >= 1, got {stages}")
        self.model = model
        self.h, self.w = image_shape
        self.channels = channels
        self.stages = stages
        r, c = shard_shape
        self.shard_shape = (r, c)
        need = stages * r * c
        if devices is None:
            from tpu_stencil_torch.devices import resolve_devices

            devices = resolve_devices()
        devices = [torch.device(d) for d in devices]
        if len(devices) < need:
            raise ValueError(
                f"pipeline topology {stages} stage(s) x {r}x{c} shard "
                f"needs {need} devices, have {len(devices)}"
            )
        self.grids = [[devices[s * r * c + i * c:s * r * c + (i + 1) * c]
                       for i in range(r)] for s in range(stages)]
        ph, pw = partition.pad_amounts(self.h, self.w, (r, c))
        self.padded_shape = (self.h + ph, self.w + pw)
        self.tile = partition.tile_shape(self.h, self.w, (r, c))
        self.boundary = model.boundary
        if self.boundary == "periodic" and (ph or pw):
            # The pad would wrap into the opposite edge: wrong output.
            raise NotImplementedError(
                f"periodic boundaries need the image ({self.h}x{self.w}) "
                f"to divide the shard grid {r}x{c}; pick a grid that "
                "divides the image or run unsharded stages"
            )
        halo = model.plan.halo
        if (r > 1 or c > 1) and min(self.tile) < halo:
            raise ValueError(
                f"per-device tile {self.tile[0]}x{self.tile[1]} is smaller "
                f"than the filter halo ({halo}); use a smaller shard grid "
                "for this image"
            )
        self.backend = "xla"
        self.schedule = None
        self.needs_mask = bool(ph or pw)
        self.local_shape = self.tile + ((channels,) if channels != 1 else ())
        self.stage0_devices = [d for row in self.grids[0] for d in row]
        self.last_devices = [d for row in self.grids[-1] for d in row]
        self._masks = [None] * stages
        if self.needs_mask:
            mask = np.zeros(self.padded_shape, np.uint8)
            mask[: self.h, : self.w] = 1
            if channels != 1:
                mask = np.repeat(mask[..., None], channels, axis=-1)
            self._masks = [self._split(mask, s) for s in range(stages)]
        # Stage 0's input on drain ticks. Never written: the carry and a
        # tick's output are buffers of their own. Fenced: the ticks read
        # it on other streams.
        self._zero = fence(self._zeros(0))

    def _split(self, padded: np.ndarray, s: int) -> Grid:
        th, tw = self.tile
        return [[torch.from_numpy(np.ascontiguousarray(
            padded[i * th:(i + 1) * th, j * tw:(j + 1) * tw])).to(dev)
            for j, dev in enumerate(row)] for i, row in enumerate(
                self.grids[s])]

    def _zeros(self, s: int) -> Grid:
        return [[torch.zeros(self.local_shape, dtype=torch.uint8, device=d)
                 for d in row] for row in self.grids[s]]

    @property
    def devices(self) -> List[torch.device]:
        return [d for g in self.grids for row in g for d in row]

    def zero_input(self) -> Grid:
        """Stage 0's all-zero input (drain ticks): cached, never written."""
        return self._zero

    def fresh_carry(self) -> List[Grid]:
        """An all-zero carry, one tile grid per stage (stage 0's is never
        read: it adopts the fed frame), of buffers of its own."""
        return [self._zeros(s) for s in range(self.stages)]

    def assemble_input(self, stage0_tiles: Sequence[torch.Tensor]) -> Grid:
        """The fed tick's input: stage 0's tiles, row-major, as a grid."""
        c = self.shard_shape[1]
        return [list(stage0_tiles[i * c:(i + 1) * c])
                for i in range(self.shard_shape[0])]

    def tick(self, carry: List[Grid], inp: Grid,
             repetitions: int) -> Tuple[List[Grid], Grid]:
        """One tick: stage 0 runs its reps on ``inp``, every other stage on
        its carry; then each stage's result is copied into the next
        stage's carry, in place. Returns ``(carry, out)``: ``out`` is the
        last stage's result (the finished frame once K ticks have run),
        never a carry buffer."""
        plan = self.model.plan
        outs = []
        for s, n in enumerate(stage_rep_counts(int(repetitions),
                                               self.stages)):
            tiles = inp if s == 0 else carry[s]
            for _ in range(n):
                tiles = _local_step(tiles, plan, self._masks[s],
                                    self.boundary)
            outs.append(tiles)
        out = outs[-1]
        if self.stages > 1 and out is carry[-1]:
            out = _map(torch.clone, out)  # a pass-through last stage
        # Last stage first: a pass-through stage's result is its own
        # carry, read here before the stage behind it overwrites it.
        for s in range(self.stages - 2, -1, -1):
            for dst_row, src_row in zip(carry[s + 1], outs[s]):
                for dst, src in zip(dst_row, src_row):
                    dst.copy_(src)
        return carry, out

    def warm(self, repetitions: int) -> List[Grid]:
        """One tick on zero frames, fenced; returns the carry the stream
        starts from."""
        carry, out = self.tick(self.fresh_carry(), self.zero_input(),
                               repetitions)
        fence(out)
        return carry


def pipeline_runner_key(model, image_shape, channels, stages, shard_shape,
                        devices):
    """The runner cache's identity of one pipeline: :func:`runner_key`
    with the stage count as its ``pipe_stages``, so two stage counts over
    the same devices never share an entry."""
    return runner_key(model, image_shape, channels, shard_shape, devices,
                      "off", pipe_stages=stages)


def shared_pipeline_runner(model, image_shape, channels, stages,
                           shard_shape=(1, 1), devices=None,
                           registry=None) -> Optional[PipelineRunner]:
    """The cached :class:`PipelineRunner` of this topology, or None when
    the geometry cannot serve it, from the one process-shared runner cache
    (:func:`~tpu_stencil_torch.parallel.sharded.cached_runner`)."""
    if devices is None:
        from tpu_stencil_torch.devices import resolve_devices

        devices = resolve_devices()
    r, c = shard_shape
    devs = [torch.device(d) for d in devices][: stages * r * c]
    key = pipeline_runner_key(model, tuple(image_shape), channels, stages,
                              (r, c), devs)

    def build():
        return PipelineRunner(model, tuple(image_shape), channels, stages,
                              shard_shape=(r, c), devices=devs)

    return cached_runner(key, build, registry=registry)


# --- --pipe-stages resolution (explicit, auto A/B) -------------------------

def measure_pipeline_ab(cfg, devices, stages: int,
                        frames: int = PROBE_FRAMES) -> Tuple[float, float]:
    """The measured A/B behind ``--pipe-stages 0``: ``frames`` (at least
    2 * K) seeded random frames through the single-device engine and
    through the K-stage pipeline (same geometry, reps and depth), one warm
    run then one timed run each (:func:`~tpu_stencil_torch.stream.engine.
    probe_seconds`), under a scratch registry. Returns ``(t_single,
    t_pipe)`` in seconds."""
    from tpu_stencil_torch import obs
    from tpu_stencil_torch.stream import engine as _sengine

    frames = max(frames, 2 * stages)

    def arm(pipe: int) -> float:
        with obs.scratch_registry():
            return _sengine.probe_seconds(dataclasses.replace(
                cfg, frames=frames, pipe_stages=pipe, mesh_frames=1,
                shard_frames=None, output="null", checkpoint_every=0,
                progress_every=0), devices)

    return arm(1), arm(stages)


def resolve_pipe_stages(cfg, devices, measure=None) -> int:
    """``cfg.pipe_stages`` resolved to the stage count that runs.

    An explicit K runs, failing when the composed device budget
    (``mesh_frames * K * R * C``) exceeds the devices. 0 (auto, a sole
    multi-device axis by the config) takes every device as a stage: first
    the roofline gate (a modelled loss or tie never pays the probe), then
    the measured A/B (:func:`measure_pipeline_ab`, or the injected
    ``measure``), which enables the pipeline only when strictly faster;
    the real probe's verdict persists (kind ``"pipeline"``), so a warm
    cache pays zero probe frames."""
    if cfg.pipe_stages == 1:
        return 1
    devices = list(devices)
    n_avail = len(devices)
    r, c = cfg.shard_frames if cfg.shard_frames else (1, 1)
    groups = cfg.mesh_frames if cfg.mesh_frames > 1 else 1
    if cfg.pipe_stages > 1:
        need = groups * cfg.pipe_stages * r * c
        if need > n_avail:
            raise ValueError(
                f"--pipe-stages {cfg.pipe_stages} with mesh_frames={groups} "
                f"and shard {r}x{c} needs {need} devices, have {n_avail}"
            )
        return cfg.pipe_stages
    if n_avail < 2:
        return 1
    stages = n_avail
    from tpu_stencil_torch.runtime import autotune, roofline

    geometry = (cfg.height, cfg.width, cfg.channels)
    topo = f"pipe{stages}"
    token = autotune.stream_cfg_token(cfg)
    hit = None
    if measure is None:
        hit = autotune.cached_stream_verdict(
            "pipeline", geometry, cfg.repetitions, cfg.pipeline_depth, topo,
            token, device=devices[0])
    if hit is not None:
        pick = int(hit["pick"])
        print(
            f"tpu_stencil_torch stream: --pipe-stages auto verdict from "
            f"warm cache: {'pipeline ' + str(pick) if pick > 1 else 'single'}"
            " (zero probe frames)",
            file=sys.stderr, flush=True,
        )
        return pick if pick > 1 else 1
    one_card = len({str(torch.device(d)) for d in devices}) == 1
    single_fps = roofline.stream_frames_per_second(
        cfg.frame_bytes, cfg.repetitions, "xla", cfg.filter_name,
        cfg.height, pipeline_depth=cfg.pipeline_depth,
    )
    pipe_fps = roofline.pipeline_stream_frames_per_second(
        cfg.frame_bytes, cfg.repetitions, "xla", cfg.filter_name,
        cfg.height, pipe_stages=stages, frames=cfg.frames,
        pipeline_depth=cfg.pipeline_depth, one_card=one_card,
    )
    if not pipe_fps > single_fps:
        # A modelled loss or tie: no probe, and nothing persisted (a later
        # run with more reps at this geometry decides for itself).
        print(
            f"tpu_stencil_torch stream: --pipe-stages auto: roofline model "
            f"predicts no gain at reps={cfg.repetitions} (pipe "
            f"{pipe_fps:.1f} <= single {single_fps:.1f} fps modeled); "
            "staying single-device, probe skipped",
            file=sys.stderr, flush=True,
        )
        return 1
    t_single, t_pipe = (measure or measure_pipeline_ab)(cfg, devices,
                                                        stages)
    pick = stages if t_pipe < t_single else 1
    if measure is None:
        autotune.store_stream_verdict(
            "pipeline", geometry, cfg.repetitions, cfg.pipeline_depth, topo,
            {"pick": pick, "single_us": round(t_single * 1e6, 1),
             "pipe_us": round(t_pipe * 1e6, 1)},
            token, device=devices[0])
    print(
        f"tpu_stencil_torch stream: --pipe-stages auto measured "
        f"single={t_single * 1e3:.1f}ms pipe({stages})="
        f"{t_pipe * 1e3:.1f}ms -> "
        f"{'pipeline ' + str(stages) if pick > 1 else 'single'}",
        file=sys.stderr, flush=True,
    )
    return pick if pick > 1 else 1
