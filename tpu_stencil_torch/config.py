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
--profile``.
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
