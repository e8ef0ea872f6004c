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
--profile``. :class:`StreamConfig` is the ``stream`` subcommand's
configuration, field for field the JAX package's.
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
