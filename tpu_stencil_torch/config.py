"""Job configuration and CLI-compatible argument parsing.

The reference's positional CLI (``Usage`` at ``mpi/mpi_convolution.c:328-348``):
``image width height repetitions {grey,rgb}``. Width/height are supplied by
the user because ``.raw`` is headerless. On top of that the job subset of
the JAX package's flags is accepted with the same names and the same
validation messages, so one command line runs on both packages:
``--filter --backend --mesh --boundary --schedule --block-h --fuse
--frames --output --time --platform``, the hardening flags ``--faults
--fallback-backend --dispatch-timeout --checkpoint-every --resume`` and
the observability flags ``--trace --breakdown --hlo-dump --metrics-text
--profile``. :class:`StreamConfig`, :class:`ServeConfig` and
:class:`NetConfig`, :class:`FedConfig` and :class:`CtrlConfig` are the
``stream``, ``serve``, ``net``, ``fed`` and ``ctrl`` subcommands'
configurations, field for field the JAX package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
from typing import Optional, Tuple

# The JAX package's schedule names, all accepted. On Hopper every name but
# "deep" runs the one fused kernel (the TPU schedules are lowerings of the
# same integers); "deep" runs the resident kernel when the image fits the
# L2 budget, else the fused kernel at the deep depth.
PALLAS_SCHEDULES = ("pad", "shrink", "strips", "pack", "pack_strips", "deep")

# Interior/border overlap schedules of the sharded path, the JAX
# package's vocabulary (tpu_stencil_torch/parallel/overlap.py imports it):
# "off" exchanges then computes; "split"/"fused-split" compute the
# ghost-free interior on a side stream while the ghosts are copied and
# finish four border bands after one join; "edge" copies each edge on its
# own and finishes each border piece after its own edge; "auto" resolves
# from measured probes (runtime/autotune.best_overlap), cached.
OVERLAP_MODES = ("auto", "split", "fused-split", "edge", "off")

# The JAX package's backend names plus the port's own spellings:
# "cuda" = "pallas" (the hand-written kernels), "torch" = "xla" (torch ops).
BACKENDS = ("auto", "xla", "pallas", "reference", "autotune", "cuda", "torch")
_BACKEND_ALIASES = {"cuda": "pallas", "torch": "xla"}


def canonical_backend(name: str) -> str:
    """The JAX package's name for a backend spelling (reports use it)."""
    return _BACKEND_ALIASES.get(name, name)


def _validate_common(cfg) -> None:
    """The geometry/backend/filter field checks, with the JAX package's
    messages."""
    if cfg.width <= 0 or cfg.height <= 0:
        raise ValueError(
            f"width/height must be positive, got {cfg.width}x{cfg.height}"
        )
    if cfg.repetitions < 0:
        raise ValueError(f"repetitions must be >= 0, got {cfg.repetitions}")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.schedule is not None and cfg.schedule not in PALLAS_SCHEDULES:
        raise ValueError(
            f"unknown schedule {cfg.schedule!r}; expected one of "
            f"{'|'.join(PALLAS_SCHEDULES)}"
        )
    if cfg.boundary not in ("zero", "periodic"):
        raise ValueError(
            f"unknown boundary {cfg.boundary!r}; expected zero|periodic"
        )
    if cfg.block_h is not None and (cfg.block_h < 8 or cfg.block_h % 8):
        nearest = max(8, -(-cfg.block_h // 8) * 8)
        raise ValueError(
            f"block_h must be a positive multiple of 8 (Pallas DMA row "
            f"windows are sublane-aligned), got {cfg.block_h}; nearest "
            f"valid value is {nearest}"
        )
    if cfg.fuse is not None and cfg.fuse < 1:
        raise ValueError(
            f"fuse must be a positive rep count (reps per HBM "
            f"round-trip), got {cfg.fuse}"
        )
    if cfg.overlap not in OVERLAP_MODES:
        raise ValueError(
            f"unknown overlap mode {cfg.overlap!r}; expected one of "
            f"{'|'.join(OVERLAP_MODES)}"
        )
    if cfg.dispatch_timeout_s < 0:
        raise ValueError(
            f"dispatch_timeout_s must be >= 0 (0 = off / env default), "
            f"got {cfg.dispatch_timeout_s}"
        )


class ImageType(enum.Enum):
    """Pixel layout of a headerless raw image (1 or 3 bytes per pixel)."""

    GREY = "grey"
    RGB = "rgb"

    @property
    def channels(self) -> int:
        return 1 if self is ImageType.GREY else 3


@dataclasses.dataclass(frozen=True)
class JobConfig:
    """Everything needed to run one iterated-convolution job."""

    image: str
    width: int
    height: int
    repetitions: int
    image_type: ImageType
    filter_name: str = "gaussian"
    backend: str = "auto"  # auto | xla | pallas | reference | autotune (+ aliases)
    mesh_shape: Optional[Tuple[int, int]] = None  # (rows, cols); None = auto
    output: Optional[str] = None  # None -> blur_<basename> beside input
    frames: int = 1  # >1: batched video mode (N concatenated raw frames)
    schedule: Optional[str] = None  # kernel schedule (None = default)
    boundary: str = "zero"  # zero (reference semantics) | periodic
    # Kernel geometry (None = defaults): rows per tile and fused reps per
    # device-memory round trip.
    block_h: Optional[int] = None
    fuse: Optional[int] = None
    # Dispatch watchdog window in seconds around every fence of the timed
    # window (resilience.deadline): past it, work still queued on the card
    # raises a typed DispatchTimeout instead of hanging. 0 = off, unless
    # TPU_STENCIL_TORCH_DISPATCH_TIMEOUT arms an env default.
    dispatch_timeout_s: float = 0.0
    # "cpu": the fallback ladder's last rung is the CPU's torch ops. Only
    # a job on the CPU walks past the kernel rungs; a card job refuses it
    # (resilience.fallback.job_ladder).
    fallback_backend: Optional[str] = None
    # Interior/border overlap schedule of a sharded run (OVERLAP_MODES);
    # single-device runs have no exchange and ignore it.
    overlap: str = "off"

    def __post_init__(self) -> None:
        _validate_common(self)
        if self.mesh_shape is not None and (
            len(self.mesh_shape) != 2 or any(d < 1 for d in self.mesh_shape)
        ):
            raise ValueError(f"mesh_shape must be two positive ints, got {self.mesh_shape}")
        if self.frames < 1:
            raise ValueError(f"frames must be >= 1, got {self.frames}")
        if self.fallback_backend not in (None, "cpu"):
            raise ValueError(
                f"unknown fallback backend {self.fallback_backend!r}; "
                f"expected cpu (or omit)"
            )

    @property
    def channels(self) -> int:
        return self.image_type.channels

    @property
    def output_path(self) -> str:
        """Reference-compatible output naming: ``blur_<input basename>``
        (``mpi/mpi_convolution.c:244-247``), placed beside the input."""
        if self.output is not None:
            return self.output
        d, base = os.path.split(self.image)
        return os.path.join(d, f"blur_{base}")

    @property
    def nbytes(self) -> int:
        return self.width * self.height * self.channels * self.frames


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Configuration of the streaming engine (:mod:`tpu_stencil_torch.
    stream`), field for field and check for check the JAX package's, so a
    command line parses the same in both packages.

    The geometry/filter/backend vocabulary is :class:`JobConfig`'s: the
    engine runs the job's model step, so plans, filters, schedules and
    kernel geometry apply unchanged. ``pipeline_depth`` bounds the frames
    in flight between the reader and the writer (1 = the serial stage
    chain); ``ring_buffers`` bounds the pinned host staging slots the
    reader fills (None = ``pipeline_depth + 2``). Host memory is
    ``O(ring_buffers)`` frames, device memory ``O(pipeline_depth)``.

    ``mesh_frames``: 1 = one device; N > 1 deals frames round-robin over N
    devices (:mod:`tpu_stencil_torch.parallel.fanout`), failing when fewer
    exist; 0 = a measured single-against-fan A/B decides. ``shard_frames``
    ((R, C), or (0, 0) for auto) cuts every frame over an R x C mesh
    (:mod:`tpu_stencil_torch.stream.sharded`; frames below
    ``shard_min_pixels`` stay on one device; ``overlap`` is the mesh's
    schedule); ``pipe_stages`` splits the reps into K stages
    (:mod:`tpu_stencil_torch.stream.pipelined`; 0 = auto). Two or more
    multi-device axes compose, each explicit.
    """

    input: str               # stream file | FIFO | '-' (stdin) | frame dir
    width: int
    height: int
    repetitions: int
    image_type: ImageType
    filter_name: str = "gaussian"
    backend: str = "auto"    # same vocabulary as JobConfig.backend
    output: Optional[str] = None  # path | dir | '-' (stdout) | 'null'
    frames: Optional[int] = None  # exact frame count; None = until EOF
    schedule: Optional[str] = None
    boundary: str = "zero"
    block_h: Optional[int] = None
    fuse: Optional[int] = None
    pipeline_depth: int = 2  # frames in flight (1 = serial stages)
    ring_buffers: Optional[int] = None  # host staging slots (None = depth+2)
    mesh_frames: int = 1     # fan width: 1 single, N explicit, 0 auto
    shard_frames: Optional[Tuple[int, int]] = None  # (R, C) | (0, 0) auto
    shard_min_pixels: int = 1 << 20
    overlap: str = "edge"
    pipe_stages: int = 1     # temporal stages: 1 off, K explicit, 0 auto
    checkpoint_every: int = 0  # frame-index checkpoint period (0 = off)
    progress_every: int = 0    # stderr frame-index heartbeat (0 = off)
    # Watchdog window (seconds) around the drain's compute fence, as
    # JobConfig.dispatch_timeout_s.
    dispatch_timeout_s: float = 0.0
    # Transient-I/O retries per frame read/write (rewindable sources and
    # idempotent sinks only).
    io_retries: int = 2
    # Mid-stream engine restarts after a transient h2d/compute/d2h fault:
    # re-prepare the engine and resume from the frame checkpoint (needs
    # checkpoint_every and a regular-file or directory source). 0 = off.
    max_engine_restarts: int = 1
    # CRC32C each frame as the reader stages it and re-verify it before
    # its copy to the card (the built crc32c library; a failed build fails
    # the stream typed).
    verify_ingest: bool = True
    # The fraction of frames re-executed through torch ops in the writer
    # and compared bit for bit before the write (0 = off; never past
    # integrity.witness.WITNESS_MAX_REPS reps).
    witness_rate: float = 1.0 / 256.0
    witness_seed: int = 0

    def __post_init__(self) -> None:
        _validate_common(self)
        if self.frames is not None and self.frames < 0:
            raise ValueError(
                f"frames must be >= 0 (None = until EOF), got {self.frames}"
            )
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.mesh_frames < 0:
            raise ValueError(
                f"mesh_frames must be >= 0 (0 = auto, 1 = single-device, "
                f"N = fan width), got {self.mesh_frames}"
            )
        if self.shard_frames is not None:
            sf = tuple(self.shard_frames)
            if len(sf) != 2 or any(
                not isinstance(d, int) or d < 0 for d in sf
            ) or (0 in sf and sf != (0, 0)):
                raise ValueError(
                    f"shard_frames must be (rows, cols) positive ints, or "
                    f"(0, 0) for auto, got {self.shard_frames}"
                )
            object.__setattr__(self, "shard_frames", sf)
        if self.pipe_stages < 0:
            raise ValueError(
                f"pipe_stages must be >= 0 (0 = auto, 1 = off, K = stage "
                f"count), got {self.pipe_stages}"
            )
        # A composed topology (two or more multi-device axes) must be
        # explicit on every active axis.
        active = (
            int(self.mesh_frames != 1)
            + int(self.shard_frames is not None)
            + int(self.pipe_stages != 1)
        )
        if active >= 2:
            autos = []
            if self.mesh_frames == 0:
                autos.append("mesh_frames=0")
            if self.shard_frames == (0, 0):
                autos.append("shard_frames=(0, 0)")
            if self.pipe_stages == 0:
                autos.append("pipe_stages=0")
            if autos:
                raise ValueError(
                    "composed topologies must be explicit on every active "
                    "axis (auto resolves only a sole multi-device axis); "
                    "auto on: " + ", ".join(autos)
                )
        if self.shard_min_pixels < 1:
            raise ValueError(
                f"shard_min_pixels must be >= 1, got "
                f"{self.shard_min_pixels}"
            )
        if self.ring_buffers is not None and (
            self.ring_buffers < self.pipeline_depth + 1
        ):
            raise ValueError(
                f"ring_buffers must be >= pipeline_depth + 1 "
                f"(= {self.pipeline_depth + 1}), got {self.ring_buffers}"
            )
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}"
            )
        if self.progress_every < 0:
            raise ValueError(
                f"progress_every must be >= 0, got {self.progress_every}"
            )
        if self.io_retries < 0:
            raise ValueError(
                f"io_retries must be >= 0, got {self.io_retries}"
            )
        if self.max_engine_restarts < 0:
            raise ValueError(
                f"max_engine_restarts must be >= 0, got "
                f"{self.max_engine_restarts}"
            )
        if not 0.0 <= self.witness_rate <= 1.0:
            raise ValueError(
                f"witness_rate must be in [0, 1], got {self.witness_rate}"
            )

    @property
    def channels(self) -> int:
        return self.image_type.channels

    @property
    def frame_bytes(self) -> int:
        return self.width * self.height * self.channels

    @property
    def frame_shape(self) -> Tuple[int, ...]:
        """(H, W) grey, (H, W, C) otherwise."""
        if self.channels == 1:
            return (self.height, self.width)
        return (self.height, self.width, self.channels)

    @property
    def ring_size(self) -> int:
        return (
            self.ring_buffers if self.ring_buffers is not None
            else self.pipeline_depth + 2
        )

    @property
    def output_path(self) -> str:
        """``blur_<input basename>`` beside the input, as
        :attr:`JobConfig.output_path`; stdin has no "beside", so it needs
        an explicit ``--output``."""
        if self.output is not None:
            return self.output
        if self.input == "-":
            raise ValueError(
                "stdin streams have no default output path; pass --output"
            )
        d, base = os.path.split(self.input.rstrip(os.sep))
        return os.path.join(d, f"blur_{base}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration of the in-process serving engine
    (:mod:`tpu_stencil_torch.serve`), field for field and check for check
    the JAX package's. Torch-free, so the ``serve`` CLI validates its
    flags before any device is touched.

    The queue bound is the backpressure contract: ``submit`` on a full
    queue raises, it never buffers unboundedly. ``max_batch`` bounds one
    scheduler dispatch; ``pipeline_depth`` bounds the batches in flight
    (H2D double-buffered against compute), so peak memory is
    ``O(max_queue + pipeline_depth * max_batch)`` frames.
    """

    filter_name: str = "gaussian"
    backend: str = "auto"      # same vocabulary as JobConfig.backend
    boundary: str = "zero"
    max_queue: int = 256       # pending requests before reject-with-error
    max_batch: int = 8         # requests per micro-batch dispatch
    pipeline_depth: int = 2    # in-flight batches (2 = double buffering)
    max_executables: int = 64  # LRU cap on cached bucket programs
    # Shape-bucket ladder override (ascending edge sizes); None = the
    # serve default (serve.bucketing.DEFAULT_EDGES). Requests above the
    # top edge pad to the next top-edge multiple.
    bucket_edges: Optional[Tuple[int, ...]] = None
    # Interior/border overlap schedule, JobConfig.overlap's vocabulary.
    # "off" keeps every request on the single-device bucket route; any
    # other mode routes requests of at least ``shard_min_pixels`` true
    # pixels through the sharded runner (K3) under this schedule, keyed
    # into their own request bucket so small requests never share a batch
    # with a sharded dispatch. Byte-equal to the bucket route.
    overlap: str = "off"
    shard_min_pixels: int = 1 << 20
    # Device-memory sampler period (seconds): a background thread gauges
    # the allocator into the server registry. 0 disables; the CPU never
    # starts the thread.
    mem_sample_interval_s: float = 0.5
    # Default per-request deadline (seconds; 0 = none): a request whose
    # deadline expires while queued fails typed (DeadlineExceeded).
    request_timeout_s: float = 0.0
    # Pin every bucket dispatch to cuda:<device_index>; None = the
    # server's device (the card by default). The replica-fleet knob.
    device_index: Optional[int] = None
    # Witness re-execution: this fraction of completed requests (seeded
    # Bernoulli) re-runs through torch ops and is compared byte for byte.
    witness_rate: float = 0.0
    witness_seed: int = 0

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.device_index is not None and self.device_index < 0:
            raise ValueError(
                f"device_index must be >= 0 (None = default device), got "
                f"{self.device_index}"
            )
        if self.boundary not in ("zero", "periodic"):
            raise ValueError(f"unknown boundary {self.boundary!r}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.max_executables < 1:
            raise ValueError(
                f"max_executables must be >= 1, got {self.max_executables}"
            )
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(
                f"unknown overlap mode {self.overlap!r}; expected one of "
                f"{'|'.join(OVERLAP_MODES)}"
            )
        if self.shard_min_pixels < 1:
            raise ValueError(
                f"shard_min_pixels must be >= 1, got "
                f"{self.shard_min_pixels}"
            )
        if self.mem_sample_interval_s < 0:
            raise ValueError(
                f"mem_sample_interval_s must be >= 0 (0 = off), got "
                f"{self.mem_sample_interval_s}"
            )
        if self.request_timeout_s < 0:
            raise ValueError(
                f"request_timeout_s must be >= 0 (0 = none), got "
                f"{self.request_timeout_s}"
            )
        if not 0.0 <= self.witness_rate <= 1.0:
            raise ValueError(
                f"witness_rate must be in [0, 1], got {self.witness_rate}"
            )
        if self.bucket_edges is not None:
            object.__setattr__(
                self, "bucket_edges", _normalize_bucket_edges(self.bucket_edges)
            )


def _normalize_bucket_edges(edges) -> Tuple[int, ...]:
    """The bucket-ladder rule: strictly ascending positive ints."""
    out = tuple(edges)
    if not out or any(e < 1 for e in out) or list(out) != sorted(set(out)):
        raise ValueError(
            "bucket_edges must be strictly ascending positive ints, "
            f"got {edges!r}"
        )
    return out


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Configuration of the network serving tier
    (:mod:`tpu_stencil_torch.net`): the HTTP frontend, the replica fleet
    and the router's admission knobs, field for field and check for check
    the JAX package's. Torch-free, so ``python -m tpu_stencil_torch net``
    validates its flags before any device is touched.

    One :class:`ServeConfig` is derived per replica (:meth:`serve_config`),
    so each replica keeps the in-process engine's backpressure and
    deadline contracts; the net tier adds placement, admission and drain.
    """

    host: str = "127.0.0.1"
    port: int = 8080           # 0 = ephemeral (the bound port is printed)
    replicas: int = 0          # engines in the fleet; 0 = one per device
    filter_name: str = "gaussian"
    backend: str = "auto"      # same vocabulary as ServeConfig.backend
    max_queue: int = 256       # per-replica bounded-queue depth
    max_batch: int = 8         # per-replica micro-batch bound
    # Shape-bucket ladder shared by every replica (None = the serve
    # default), so a shape warmed on one replica has the same program key
    # on the others.
    bucket_edges: Optional[Tuple[int, ...]] = None
    # Load-shedding watermark: a request that would push the router's
    # tracked in-flight bytes (request + response buffers) past this is
    # shed with 503 + Retry-After before it touches a replica queue.
    # 0 disables the watermark (the bounded queues still answer 429).
    max_inflight_mb: float = 256.0
    # Default per-request deadline (seconds; 0 = none), forwarded to each
    # replica; X-Request-Timeout overrides it. Expired requests map to
    # HTTP 504 (DeadlineExceeded).
    request_timeout_s: float = 0.0
    # Graceful-drain budget (seconds): on SIGTERM every replica gets
    # close(timeout=) within it; one whose worker does not join is
    # reported abandoned instead of hanging the shutdown.
    drain_timeout_s: float = 30.0
    # Shared program-cache warming: the first time the router sees a new
    # (filter, bucket, channels, reps) key it fires one discarded
    # zero-frame warm request at every other replica.
    warm_fleet: bool = True
    # The integrity layer: X-Content-Crc32c claims validated (mismatch ->
    # typed 400), every 200 stamped X-Result-Crc32c, witness_rate of the
    # completed requests re-executed through torch ops per replica. Off
    # turns all of it off (quarantine then trips only by the admin path).
    integrity: bool = True
    # Fraction of requests witnessed per replica (seeded per replica
    # index). K mismatches within the window quarantine the replica; N
    # consecutive clean background probes re-admit it.
    witness_rate: float = 1.0 / 256.0
    quarantine_after: int = 3
    quarantine_window_s: float = 60.0
    readmit_after: int = 3
    # Background re-verify probe period for quarantined replicas (seconds;
    # 0 disables the prober).
    probe_interval_s: float = 1.0
    # Flight recorder spool of anomaly dumps (TPU_STENCIL_TORCH_FLIGHTREC_DIR
    # overrides); None disables the spool (the ring still records).
    flightrec_dir: Optional[str] = "flightrec"
    # Slow-request anomaly threshold (seconds; 0 disables): a 200 slower
    # than this triggers a flight-recorder dump.
    flight_latency_threshold_s: float = 0.0
    # Router-level continuous batching: admitted requests sharing a
    # (filter, shape bucket, channels, reps) key are held up to this many
    # microseconds so concurrent arrivals stack onto one replica submit.
    # A full group or a member whose deadline falls inside the window
    # dispatches at once. 0 = off (the library default; the CLI's is 300).
    coalesce_window_us: float = 0.0
    # Zero-copy ingest: request bodies are read into pooled per-bucket
    # staging buffers (readinto, CRC in place) and handed to the engine
    # owned. Off = every body is buffered through fresh bytes objects.
    ingest_arena: bool = True
    # Content-addressed result cache of this many MB of true result bytes
    # keyed by (body BLAKE2b-160, filter, reps, geometry, boundary), with
    # single-flight collapse and synchronous invalidation on replica
    # distrust. 0 = off (the default).
    result_cache_mb: float = 0.0
    # Live telemetry: a sampler thread snapshots the registry every
    # sample_interval_s into a ring serving GET /debug/timeseries. 0
    # disables the sampler and the SLO engine that runs on its ticks.
    sample_interval_s: float = 1.0
    # SLO burn-rate engine: the error budget of the stock error-ratio
    # objective (0 disables the engine); a breach flips /healthz to
    # "degraded" (200), emits slo.breach and triggers a flight dump.
    slo_error_budget: float = 0.05
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_fast_burn: float = 6.0
    slo_slow_burn: float = 3.0
    # Optional latency objective: requests slower than this burn a 1%
    # budget (0 = objective off).
    slo_latency_p99_s: float = 0.0
    # On-demand profiler spool (POST /debug/prof?seconds=N); None disables
    # the endpoint (404).
    prof_dir: Optional[str] = "profspool"

    def __post_init__(self) -> None:
        if not self.host:
            raise ValueError("host must be non-empty")
        if not 0 <= self.port <= 65535:
            raise ValueError(
                f"port must be in [0, 65535] (0 = ephemeral), got {self.port}"
            )
        if self.replicas < 0:
            raise ValueError(
                f"replicas must be >= 0 (0 = one per local device), got "
                f"{self.replicas}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_inflight_mb < 0:
            raise ValueError(
                f"max_inflight_mb must be >= 0 (0 = no shed watermark), "
                f"got {self.max_inflight_mb}"
            )
        if self.request_timeout_s < 0:
            raise ValueError(
                f"request_timeout_s must be >= 0 (0 = none), got "
                f"{self.request_timeout_s}"
            )
        if self.drain_timeout_s <= 0:
            raise ValueError(
                f"drain_timeout_s must be > 0, got {self.drain_timeout_s}"
            )
        if not 0.0 <= self.witness_rate <= 1.0:
            raise ValueError(
                f"witness_rate must be in [0, 1], got {self.witness_rate}"
            )
        if self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {self.quarantine_after}"
            )
        if self.quarantine_window_s <= 0:
            raise ValueError(
                f"quarantine_window_s must be > 0, got "
                f"{self.quarantine_window_s}"
            )
        if self.readmit_after < 1:
            raise ValueError(
                f"readmit_after must be >= 1, got {self.readmit_after}"
            )
        if self.probe_interval_s < 0:
            raise ValueError(
                f"probe_interval_s must be >= 0 (0 = no background "
                f"prober), got {self.probe_interval_s}"
            )
        if self.flight_latency_threshold_s < 0:
            raise ValueError(
                f"flight_latency_threshold_s must be >= 0 (0 = no "
                f"slow-request trigger), got "
                f"{self.flight_latency_threshold_s}"
            )
        if self.coalesce_window_us < 0:
            raise ValueError(
                f"coalesce_window_us must be >= 0 (0 = no request "
                f"coalescing), got {self.coalesce_window_us}"
            )
        if self.result_cache_mb < 0:
            raise ValueError(
                f"result_cache_mb must be >= 0 (0 = no result cache), "
                f"got {self.result_cache_mb}"
            )
        _validate_telemetry(self)
        # Torch-free (the filter bank is numpy): a typo'd --filter dies as
        # a usage error, not as a tier that answers 500 to every request.
        from tpu_stencil_torch import filters as _filters

        try:
            _filters.get_filter(self.filter_name)
        except KeyError as e:
            raise ValueError(str(e)) from None
        if self.bucket_edges is not None:
            object.__setattr__(
                self, "bucket_edges", _normalize_bucket_edges(self.bucket_edges)
            )

    @property
    def max_inflight_bytes(self) -> int:
        return int(self.max_inflight_mb * (1 << 20))

    @property
    def coalesce_window_s(self) -> float:
        return self.coalesce_window_us / 1e6

    @property
    def result_cache_bytes(self) -> int:
        return int(self.result_cache_mb * (1 << 20))

    def serve_config(self, device_index: int) -> ServeConfig:
        """The per-replica engine config, forwarding exactly what the JAX
        package's forwards: ``overlap`` is not forwarded, so every replica
        keeps ``"off"`` and serves on the bucket route (K1). The
        device-memory sampler stays off per replica (the fleet's merged
        exposition is the scrape surface); witness sampling is seeded per
        replica so replicas never sample in lockstep. The fleet replaces
        ``device_index`` with its replica's device."""
        return ServeConfig(
            filter_name=self.filter_name,
            backend=self.backend,
            max_queue=self.max_queue,
            max_batch=self.max_batch,
            bucket_edges=self.bucket_edges,
            request_timeout_s=self.request_timeout_s,
            device_index=device_index,
            mem_sample_interval_s=0.0,
            witness_rate=self.witness_rate if self.integrity else 0.0,
            witness_seed=device_index,
        )


def _validate_telemetry(cfg) -> None:
    """The sampler and SLO knobs' validation (the JAX package's rule)."""
    if cfg.sample_interval_s < 0:
        raise ValueError(
            f"sample_interval_s must be >= 0 (0 = sampler off), got "
            f"{cfg.sample_interval_s}"
        )
    if not 0.0 <= cfg.slo_error_budget <= 1.0:
        raise ValueError(
            f"slo_error_budget must be in [0, 1] (0 = SLO engine off), "
            f"got {cfg.slo_error_budget}"
        )
    if cfg.slo_fast_window_s <= 0 or cfg.slo_slow_window_s <= 0:
        raise ValueError(
            f"slo windows must be > 0, got fast={cfg.slo_fast_window_s} "
            f"slow={cfg.slo_slow_window_s}"
        )
    if cfg.slo_slow_window_s < cfg.slo_fast_window_s:
        raise ValueError(
            f"slo_slow_window_s must be >= slo_fast_window_s "
            f"({cfg.slo_fast_window_s}), got {cfg.slo_slow_window_s}"
        )
    if cfg.slo_fast_burn <= 0 or cfg.slo_slow_burn <= 0:
        raise ValueError(
            f"slo burn thresholds must be > 0, got "
            f"fast={cfg.slo_fast_burn} slow={cfg.slo_slow_burn}"
        )
    if cfg.slo_latency_p99_s < 0:
        raise ValueError(
            f"slo_latency_p99_s must be >= 0 (0 = no latency "
            f"objective), got {cfg.slo_latency_p99_s}"
        )


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Configuration of the federation front-router tier
    (:mod:`tpu_stencil_torch.fed`): health-checked membership, per-host
    circuit breakers, hedged forwarding, and federation-scope admission
    with per-tenant quotas, field for field and check for check the JAX
    package's. The tier never touches a device: it moves routing metadata
    plus the one forwarded body per request.

    Membership timing is a *suspicion window*, not a single timeout:
    ``suspect_after`` consecutive missed heartbeats demote a member to
    suspect (routed only after every healthy host), ``evict_after``
    misses evict it. A member whose ``/healthz`` answers 503 (draining)
    is removed from routing immediately — before its requests would
    start failing.
    """

    host: str = "127.0.0.1"
    port: int = 8090           # 0 = ephemeral (the bound port is printed)
    members: Tuple[str, ...] = ()  # seed member URLs; more register live
    # Membership / heartbeats.
    heartbeat_interval_s: float = 1.0
    suspect_after: int = 2     # consecutive misses -> suspect
    evict_after: int = 5       # consecutive misses -> evicted
    # Per-host circuit breaker: this many consecutive transport-level
    # forward failures open the breaker (typed HostUnavailable); after
    # the cooldown one half-open probe request is let through — success
    # closes it, failure re-opens for another cooldown.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 2.0
    # Hedged requests: a forward still pending past the observed p99
    # forward latency (floored by hedge_min_s) fires ONE hedge at the
    # next least-outstanding member; first response wins, the loser is
    # cancelled typed.
    hedge: bool = True
    hedge_min_s: float = 0.05
    # Per-attempt member socket timeout (connect + response): past it
    # the attempt classifies as a member timeout (breaker counts, the
    # request reroutes). Matches the net handler's read-side guard.
    forward_timeout_s: float = 120.0
    # Re-offer window when EVERY routable member answers backpressure:
    # transient all-busy blips re-offer (resilience.retry.reoffer_call)
    # for up to this long before the typed 429/503 surfaces. 0 = off.
    reoffer_s: float = 0.5
    # Federation-scope load shed: past this many MB of tracked
    # in-flight request+response bytes, standard-class requests are
    # shed 503 + Retry-After before any forward; premium tenants get
    # PREMIUM_HEADROOM more before shedding. 0 disables.
    max_inflight_mb: float = 512.0
    # Per-tenant quota (X-Tenant header; absent = tenant "anon"): max
    # outstanding requests per standard tenant — the hot client
    # degrades to ITS quota, never the fleet. Premium tenants (listed
    # in premium_tenants) get quota * premium_quota_factor.
    tenant_quota: int = 32
    premium_tenants: Tuple[str, ...] = ()
    premium_quota_factor: int = 4
    # Graceful-drain budget (seconds): on SIGTERM, admission stops and
    # every member gets this long for its outstanding forwarded
    # requests to bleed to zero; a member still busy past it is
    # reported abandoned (rc 1), mirroring the net CLI's discipline.
    drain_timeout_s: float = 30.0
    # Flight recorder, same contract as NetConfig: anomaly dumps (slow
    # request / deadline / breaker open / eviction) spool here;
    # TPU_STENCIL_TORCH_FLIGHTREC_DIR overrides; None disables the spool.
    flightrec_dir: Optional[str] = "flightrec"
    # Slow-request trigger threshold (seconds; 0 = off).
    flight_latency_threshold_s: float = 0.0
    # Digest-affinity placement (cache.affinity): healthy
    # members are ranked by rendezvous hash of the request body's
    # BLAKE2b-160 digest, so repeated content concentrates on the
    # member whose result cache already holds it. Suspect members,
    # breakers, drains and hedging behave exactly as before; off =
    # pure least-outstanding placement.
    digest_affinity: bool = True
    # Live telemetry plane, same contract as NetConfig: local-registry
    # sampler (0 = off, which also disables the SLO engine) feeding
    # GET /debug/timeseries (the fed endpoint additionally fans the
    # query to live members and merges), and the SLO error budget
    # (0 = engine off) for the fed tier's own response mix.
    sample_interval_s: float = 1.0
    slo_error_budget: float = 0.05
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_fast_burn: float = 6.0
    slo_slow_burn: float = 3.0
    slo_latency_p99_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.host:
            raise ValueError("host must be non-empty")
        if not 0 <= self.port <= 65535:
            raise ValueError(
                f"port must be in [0, 65535] (0 = ephemeral), got {self.port}"
            )
        object.__setattr__(self, "members", tuple(self.members))
        for url in self.members:
            if not url.startswith(("http://", "https://")):
                raise ValueError(
                    f"member URL must start with http:// or https://, "
                    f"got {url!r}"
                )
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                f"heartbeat_interval_s must be > 0, got "
                f"{self.heartbeat_interval_s}"
            )
        if self.suspect_after < 1:
            raise ValueError(
                f"suspect_after must be >= 1, got {self.suspect_after}"
            )
        if self.evict_after < self.suspect_after:
            raise ValueError(
                f"evict_after must be >= suspect_after "
                f"({self.suspect_after}), got {self.evict_after}"
            )
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}"
            )
        if self.breaker_cooldown_s <= 0:
            raise ValueError(
                f"breaker_cooldown_s must be > 0, got "
                f"{self.breaker_cooldown_s}"
            )
        if self.hedge_min_s < 0:
            raise ValueError(
                f"hedge_min_s must be >= 0, got {self.hedge_min_s}"
            )
        if self.forward_timeout_s <= 0:
            raise ValueError(
                f"forward_timeout_s must be > 0, got "
                f"{self.forward_timeout_s}"
            )
        if self.reoffer_s < 0:
            raise ValueError(
                f"reoffer_s must be >= 0 (0 = no re-offer window), got "
                f"{self.reoffer_s}"
            )
        if self.max_inflight_mb < 0:
            raise ValueError(
                f"max_inflight_mb must be >= 0 (0 = no shed watermark), "
                f"got {self.max_inflight_mb}"
            )
        if self.tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1, got {self.tenant_quota}"
            )
        object.__setattr__(
            self, "premium_tenants", tuple(self.premium_tenants)
        )
        if self.premium_quota_factor < 1:
            raise ValueError(
                f"premium_quota_factor must be >= 1, got "
                f"{self.premium_quota_factor}"
            )
        if self.drain_timeout_s <= 0:
            raise ValueError(
                f"drain_timeout_s must be > 0, got {self.drain_timeout_s}"
            )
        if self.flight_latency_threshold_s < 0:
            raise ValueError(
                f"flight_latency_threshold_s must be >= 0 (0 = no "
                f"slow-request trigger), got "
                f"{self.flight_latency_threshold_s}"
            )
        _validate_telemetry(self)

    @property
    def max_inflight_bytes(self) -> int:
        return int(self.max_inflight_mb * (1 << 20))


@dataclasses.dataclass(frozen=True)
class CtrlConfig:
    """Configuration of the elastic control plane
    (:mod:`tpu_stencil_torch.ctrl`): the loop that polls the federation's
    live capacity signals, runs them through the hysteresis planner, and
    actuates scale-out / scale-in / replacement through a host provider,
    field for field the JAX package's. The controller never touches a
    device; it only reads scrapes and starts and stops member processes.

    The planner mirrors the SLO engine's fast+slow enter/hold
    discipline: scale-out requires EVERY sample in the fast window
    and a majority of the slow window to show pressure (utilization
    past ``scale_out_utilization`` or time-to-saturation under
    ``saturation_horizon_s``); once entered, pressure holds until the
    fast window's mean utilization falls below ``hold_utilization``.
    Scale-in is the slow symmetric case: every slow-window sample
    idle. A decision is never taken from one sample, and each
    actuation arms a ``cooldown_samples``-poll cooldown so the fleet
    resizes at most once per observed settling window. Replacement
    (an owned host's process died, or a member was preempted) is a
    discrete event and bypasses hysteresis entirely."""

    fed_url: str = "http://127.0.0.1:8090"
    poll_interval_s: float = 1.0
    capacity_window_s: float = 10.0  # window= passed to /debug/capacity
    # Fleet bounds (owned hosts, not counting hand-registered members).
    min_hosts: int = 1
    max_hosts: int = 4
    # Hysteresis windows, in SAMPLES (polls), not wall seconds — the
    # planner is deterministic under synthetic signal feeds.
    fast_samples: int = 3
    slow_samples: int = 9
    scale_out_utilization: float = 0.85
    hold_utilization: float = 0.70
    scale_in_utilization: float = 0.30
    saturation_horizon_s: float = 30.0
    cooldown_samples: int = 5
    # Actuation budgets.
    launch_timeout_s: float = 120.0
    drain_timeout_s: float = 60.0
    # Subprocess provider knobs (the CI/bench provider; real fleets
    # implement ctrl.actuator.HostProvider instead). member_platform None
    # runs the members on the card (a member without one fails its
    # launch, counted); "cpu" asks for the CPU.
    member_platform: Optional[str] = None
    replicas_per_host: int = 1
    # Warm-start: launched members pull /admin/warmstate from this URL
    # (default: the fed front itself) before flipping ready; None
    # launches them cold.
    warm_from: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.fed_url.startswith(("http://", "https://")):
            raise ValueError(
                f"fed_url must start with http:// or https://, got "
                f"{self.fed_url!r}"
            )
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, got {self.poll_interval_s}"
            )
        if self.capacity_window_s <= 0:
            raise ValueError(
                f"capacity_window_s must be > 0, got "
                f"{self.capacity_window_s}"
            )
        if self.min_hosts < 0:
            raise ValueError(
                f"min_hosts must be >= 0, got {self.min_hosts}"
            )
        if self.max_hosts < max(1, self.min_hosts):
            raise ValueError(
                f"max_hosts must be >= max(1, min_hosts="
                f"{self.min_hosts}), got {self.max_hosts}"
            )
        if self.fast_samples < 1:
            raise ValueError(
                f"fast_samples must be >= 1, got {self.fast_samples}"
            )
        if self.slow_samples < self.fast_samples:
            raise ValueError(
                f"slow_samples must be >= fast_samples "
                f"({self.fast_samples}), got {self.slow_samples}"
            )
        if not (0.0 < self.scale_in_utilization
                < self.hold_utilization
                <= self.scale_out_utilization <= 1.0):
            raise ValueError(
                f"utilization thresholds must satisfy 0 < scale_in "
                f"< hold <= scale_out <= 1, got "
                f"scale_in={self.scale_in_utilization} "
                f"hold={self.hold_utilization} "
                f"scale_out={self.scale_out_utilization}"
            )
        if self.saturation_horizon_s < 0:
            raise ValueError(
                f"saturation_horizon_s must be >= 0 (0 = ignore "
                f"time-to-saturation), got {self.saturation_horizon_s}"
            )
        if self.cooldown_samples < 0:
            raise ValueError(
                f"cooldown_samples must be >= 0, got "
                f"{self.cooldown_samples}"
            )
        if self.launch_timeout_s <= 0:
            raise ValueError(
                f"launch_timeout_s must be > 0, got "
                f"{self.launch_timeout_s}"
            )
        if self.drain_timeout_s <= 0:
            raise ValueError(
                f"drain_timeout_s must be > 0, got {self.drain_timeout_s}"
            )
        if self.member_platform not in (None, "cpu", "gpu"):
            raise ValueError(
                f"member_platform must be None (the card), 'cpu' or "
                f"'gpu', got {self.member_platform!r}"
            )
        if self.replicas_per_host < 1:
            raise ValueError(
                f"replicas_per_host must be >= 1, got "
                f"{self.replicas_per_host}"
            )
        if self.warm_from is not None and not self.warm_from.startswith(
                ("http://", "https://")):
            raise ValueError(
                f"warm_from must start with http:// or https://, got "
                f"{self.warm_from!r}"
            )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch",
        description=(
            "Iterated image convolution on an NVIDIA GPU (PyTorch + "
            "hand-written CUDA kernels). Positional arguments are "
            "compatible with the reference CLI: image width height "
            "repetitions {grey,rgb}."
        ),
    )
    p.add_argument(
        "image",
        help="input image: headerless .raw, or any standard format "
             "(png/jpg/ppm/bmp/tiff/...) decoded via its header",
    )
    p.add_argument(
        "width", type=int,
        help="image width in pixels (0 = from header, non-raw formats only)",
    )
    p.add_argument(
        "height", type=int,
        help="image height in pixels (0 = from header, non-raw formats only)",
    )
    p.add_argument("repetitions", type=int, help="number of filter applications")
    p.add_argument(
        "image_type", choices=[t.value for t in ImageType],
        help="grey (1 byte/px) or rgb (3 interleaved bytes/px)",
    )
    p.add_argument(
        "--filter", dest="filter_name", default="gaussian",
        help="filter name (box|gaussian|edge|gaussian5|gaussian7|...); default gaussian",
    )
    p.add_argument(
        "--backend", default="auto", choices=list(BACKENDS),
        help="compute backend: pallas (alias cuda) runs the hand-written "
             "CUDA kernels, xla (alias torch) runs torch ops, reference "
             "the float32 plan in torch ops; auto and autotune measure "
             "backend, schedule and kernel geometry once per (card, filter, "
             "shape) on the GPU, cache the verdict on disk and run it; on "
             "the CPU they run torch ops",
    )
    p.add_argument(
        "--mesh", default=None,
        help="device mesh as RxC (e.g. 2x4); default: perimeter-minimizing grid "
             "over all local devices. With --frames > 1 there is no spatial "
             "sharding: RxC only selects R*C devices for batch-axis sharding",
    )
    p.add_argument("--output", default=None, help="output path (default blur_<input>)")
    p.add_argument(
        "--frames", type=int, default=1, metavar="N",
        help="batched video mode: the raw input holds N concatenated frames "
             "(frames never mix). Raw-only",
    )
    p.add_argument(
        "--boundary", default="zero", choices=["zero", "periodic"],
        help="edge semantics: zero (the reference's calloc'd ghost ring) "
             "or periodic (wraparound). Periodic runs torch ops",
    )
    p.add_argument(
        "--schedule", default=None, choices=list(PALLAS_SCHEDULES),
        help="kernel schedule: 'deep' keeps the whole image in L2 across "
             "the rep loop in one cooperative launch when it fits (else the "
             "fused kernel at the deep depth); every other name runs the "
             "fused kernel",
    )
    p.add_argument(
        "--block-h", dest="block_h", type=int, default=None, metavar="ROWS",
        help="force the fused kernel's tile height (a positive multiple "
             "of 8; clamped to the image and to shared memory)",
    )
    p.add_argument(
        "--fuse", type=int, default=None, metavar="REPS",
        help="force the fused kernel's reps per device-memory round trip "
             "(clamped to block_h/(2*halo) and to shared memory; reps %% "
             "fuse remainder runs as single-rep launches)",
    )
    p.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="cpu runs the torch-ops and plain versions of the kernels on "
             "the CPU; default (or gpu) runs on the first CUDA device and "
             "fails when there is none",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace (CPU and CUDA activity) of the "
             "compute window to DIR as Chrome trace JSON",
    )
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="phase-level span tracing: write a Chrome trace-event JSON to "
             "PATH (load in Perfetto / chrome://tracing). The rep loop "
             "runs one fenced launch per rep so per-rep time is "
             "attributed; the sharded runner adds one exchange-only and "
             "one K3-only probe outside the window",
    )
    p.add_argument(
        "--breakdown", action="store_true",
        help="print a per-phase time table (load/place/compile/iterate/"
             "fetch/store) with roofline-achieved GB/s for the iterate "
             "phase, the kernel instances the warm-up launched, the "
             "resilience counters and the device memory; implies span "
             "tracing for this run",
    )
    p.add_argument(
        "--metrics-text", default=None, metavar="PATH",
        help="write the driver-side metrics registry as Prometheus-style "
             "text exposition to PATH ('-' = stdout)",
    )
    p.add_argument(
        "--hlo-dump", default=None, metavar="DIR",
        help="accepted for the JAX package's command lines: arms kernel "
             "introspection and writes nothing (hand-written CUDA kernels "
             "have no HLO)",
    )
    p.add_argument(
        "--dispatch-timeout", dest="dispatch_timeout_s", type=float,
        default=0.0, metavar="SECONDS",
        help="watchdog window around every fence of the compute window: "
             "work still pending past it raises a typed DispatchTimeout "
             "instead of hanging. 0 = off, unless "
             "TPU_STENCIL_TORCH_DISPATCH_TIMEOUT sets an env default",
    )
    p.add_argument(
        "--fallback-backend", default=None, choices=["cpu"],
        help="opt-in last rung of the fallback ladder (deep -> default "
             "kernel schedule -> torch ops) of a job on the CPU: finish on "
             "the CPU's torch ops, same bytes, counted in "
             "resilience_fallbacks_total. A job on the card refuses it: "
             "there the ladder steps from K2 to K1 only",
    )
    p.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="arm the fault-injection harness, e.g. "
             "'compute:rep=3:raise=RuntimeError,h2d:p=0.1'; same grammar as "
             "TPU_STENCIL_TORCH_FAULTS, which this flag overrides",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="checkpoint the frame every N repetitions (0 = off)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume from a matching checkpoint if present",
    )
    p.add_argument(
        "--overlap", default="off", choices=list(OVERLAP_MODES),
        help="compute/exchange overlap schedule on sharded meshes: off "
             "exchanges the ghosts, then runs each tile; split computes "
             "each tile's ghost-free interior on a side stream while the "
             "ghosts are copied and finishes the four border bands from "
             "them; fused-split does so per chunk of fuse reps (split off "
             "the kernels); edge copies each edge on its own and finishes "
             "each border piece as soon as its own edge has arrived; auto "
             "picks from measured probes (cached). Ignored off a mesh",
    )
    p.add_argument(
        "--time", action="store_true",
        help="additionally print whole-job time incl. I/O, the backend, "
             "schedule and kernel launch counts; the compute-window line "
             "is always printed",
    )
    return p


def _parse_mesh(parser: argparse.ArgumentParser, value: str) -> Tuple[int, int]:
    r, sep, c = value.lower().partition("x")
    if not sep or not r.isdigit() or not c.isdigit() or int(r) < 1 or int(c) < 1:
        parser.error(f"--mesh must be RxC with positive integers, got {value!r}")
    return (int(r), int(c))


def parse_args(argv=None) -> Tuple[JobConfig, argparse.Namespace]:
    parser = build_parser()
    ns = parser.parse_args(argv)
    mesh_shape = None
    if ns.mesh is not None:
        mesh_shape = _parse_mesh(parser, ns.mesh)
    if ns.checkpoint_every < 0:
        parser.error(f"--checkpoint-every must be >= 0, got {ns.checkpoint_every}")
    from tpu_stencil_torch.io import images as _images

    try:
        width, height = _images.resolve_size(ns.image, ns.width, ns.height)
    except (ValueError, OSError) as e:
        parser.error(str(e))
    try:
        cfg = JobConfig(
            image=ns.image,
            width=width,
            height=height,
            repetitions=ns.repetitions,
            image_type=ImageType(ns.image_type),
            filter_name=ns.filter_name,
            backend=ns.backend,
            mesh_shape=mesh_shape,
            output=ns.output,
            frames=ns.frames,
            schedule=ns.schedule,
            boundary=ns.boundary,
            block_h=ns.block_h,
            fuse=ns.fuse,
            dispatch_timeout_s=ns.dispatch_timeout_s,
            fallback_backend=ns.fallback_backend,
            overlap=ns.overlap,
        )
    except ValueError as e:
        parser.error(str(e))
    if ns.faults is not None:
        # Validate the spec at parse time, so a mistyped chaos spec dies as
        # a usage error, not mid-job; cli.main arms it.
        from tpu_stencil_torch.resilience import faults as _faults

        try:
            _faults.parse_spec(ns.faults)
        except ValueError as e:
            parser.error(str(e))
    return cfg, ns
