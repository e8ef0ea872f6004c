"""``python -m tpu_stencil_torch stream``: the streaming CLI.

The JAX package's ``stream`` command line, flag for flag: positionals
``input width height repetitions {grey,rgb}``, where ``input`` is a
concatenated headerless ``.raw`` stream (a file, a FIFO, or ``-`` for
stdin) or a directory of per-frame ``.raw`` files, and exactly one of
``--frames N`` (the stream holds N frames; ending early is an error) or
``--until-eof``. It runs on the card (every visible CUDA device is
offered to ``--mesh-frames``, ``--shard-frames`` and ``--pipe-stages``)
unless ``--platform cpu`` asks for the CPU (offered as many times over as
the explicit topology asks for: ``mesh_frames * pipe_stages * R * C``);
with no GPU and no ``--platform cpu`` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tpu_stencil_torch import obs

from tpu_stencil_torch.config import (
    BACKENDS,
    OVERLAP_MODES,
    PALLAS_SCHEDULES,
    ImageType,
    StreamConfig,
)
from tpu_stencil_torch.devices import NoDeviceError, resolve_devices
from tpu_stencil_torch.ops._build import KernelBuildError

# --stats-json payload schema: the JAX package's. Bump on breaking shape
# changes.
STATS_SCHEMA_VERSION = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch stream",
        description=(
            "Pipelined multi-frame streaming: read -> H2D -> compute -> "
            "D2H -> write with K frames in flight, so host I/O and the "
            "copies over the host link overlap the kernels on the GPU."
        ),
    )
    p.add_argument(
        "input",
        help="frame stream: concatenated headerless .raw (file or FIFO), "
             "'-' for stdin, or a directory of per-frame .raw files",
    )
    p.add_argument("width", type=int, help="frame width in pixels")
    p.add_argument("height", type=int, help="frame height in pixels")
    p.add_argument("repetitions", type=int,
                   help="filter applications per frame")
    p.add_argument(
        "image_type", choices=[t.value for t in ImageType],
        help="grey (1 byte/px) or rgb (3 interleaved bytes/px)",
    )
    n = p.add_mutually_exclusive_group(required=True)
    n.add_argument(
        "--frames", type=int, default=None, metavar="N",
        help="the stream holds exactly N frames; a stream that ends "
             "early fails with the frame index",
    )
    n.add_argument(
        "--until-eof", action="store_true",
        help="process frames until the source reaches EOF",
    )
    p.add_argument(
        "--filter", dest="filter_name", default="gaussian",
        help="filter name (box|gaussian|edge|...); default gaussian",
    )
    p.add_argument(
        "--backend", default="auto", choices=list(BACKENDS),
        help="compute backend, same vocabulary as the run CLI (pallas, "
             "alias cuda: the hand-written kernels; xla, alias torch: "
             "torch ops)",
    )
    p.add_argument(
        "--schedule", default=None, choices=list(PALLAS_SCHEDULES),
        help="kernel schedule, as the run CLI's ('deep': K2, one "
             "cooperative launch per frame)",
    )
    p.add_argument(
        "--boundary", default="zero", choices=["zero", "periodic"],
        help="edge semantics, same vocabulary as the run CLI",
    )
    p.add_argument(
        "--block-h", dest="block_h", type=int, default=None, metavar="ROWS",
        help="force the fused kernel's tile height",
    )
    p.add_argument(
        "--fuse", type=int, default=None, metavar="REPS",
        help="force the fused kernel's reps per device-memory round trip",
    )
    p.add_argument(
        "--output", default=None,
        help="sink: concatenated stream file, a directory (per-frame "
             "files), '-' for stdout, or 'null' to discard (benchmark "
             "mode); default blur_<input> beside a path input",
    )
    p.add_argument(
        "--pipeline-depth", type=int, default=2, metavar="K",
        help="at most K frames between the start of their read and the "
             "end of their copy back (1 = serial stages; default 2 = "
             "double buffering)",
    )
    p.add_argument(
        "--ring", dest="ring_buffers", type=int, default=None, metavar="N",
        help="pinned host staging slots the reader fills (default "
             "pipeline_depth + 2; must be > pipeline_depth)",
    )
    p.add_argument(
        "--mesh-frames", dest="mesh_frames", type=int, default=1,
        metavar="N",
        help="mesh fan-out: deal frames round-robin over N devices, one "
             "lane (staging ring, streams, window) per device, written in "
             "order. 1 = one device (default); N > 1 fails when fewer "
             "devices exist; 0 = auto: a measured one-device-against-fan "
             "A/B fans only when strictly faster (cached). Checkpoints "
             "record the device count and per-device cursors, so --resume "
             "under another count fails typed",
    )
    p.add_argument(
        "--shard-frames", dest="shard_frames", default=None,
        metavar="RxC",
        help="spatially shard every frame over an RxC mesh of devices, "
             "each tile through the sharded runner (K3 under --overlap); "
             "frames below --shard-min-pixels stay on one device; 0 = auto: "
             "shard when one device cannot hold the frame, else a measured "
             "A/B shards only when strictly faster (cached). Checkpoints "
             "record RxC, so --resume under another fails typed",
    )
    p.add_argument(
        "--pipe-stages", dest="pipe_stages", type=int, default=1,
        metavar="K",
        help="temporal pipeline: split the reps into K stages on K "
             "devices (times the --mesh-frames groups and the "
             "--shard-frames tiles), frames moving one stage per tick. 1 = "
             "off (default); 0 = auto: a roofline gate, then a measured "
             "A/B enables it only when strictly faster (cached)",
    )
    p.add_argument(
        "--shard-min-pixels", dest="shard_min_pixels", type=int,
        default=1 << 20, metavar="PX",
        help="sharded-frame routing threshold in pixels (H*W): frames "
             "below it stay on one device (default 1 Mpx)",
    )
    p.add_argument(
        "--overlap", default="edge", choices=list(OVERLAP_MODES),
        help="overlap schedule of a --shard-frames mesh; ignored without "
             "it",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="commit a frame-index checkpoint every N written frames "
             "(0 = off); needs a resumable sink (file or directory)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume past the frames a matching checkpoint records",
    )
    p.add_argument(
        "--progress-every", type=int, default=0, metavar="N",
        help="print the frame index to stderr every N written frames",
    )
    p.add_argument(
        "--dispatch-timeout", dest="dispatch_timeout_s", type=float,
        default=0.0, metavar="SECONDS",
        help="watchdog window around the drain's wait for each frame's "
             "compute: a hung launch fails typed (DispatchTimeout) instead "
             "of parking the pipeline forever (0 = off, unless "
             "TPU_STENCIL_TORCH_DISPATCH_TIMEOUT arms an env default)",
    )
    p.add_argument(
        "--io-retries", dest="io_retries", type=int, default=2,
        metavar="N",
        help="transient-I/O retries per frame read/write (rewindable "
             "sources and idempotent sinks only; default 2)",
    )
    p.add_argument(
        "--engine-restarts", dest="max_engine_restarts", type=int,
        default=1, metavar="N",
        help="mid-stream engine restarts after a transient h2d/compute/"
             "d2h fault: re-prepare the engine and resume from the "
             "frame checkpoint (needs --checkpoint-every and a file/"
             "directory input; default 1, 0 = off)",
    )
    p.add_argument(
        "--no-verify-ingest", dest="verify_ingest",
        action="store_false",
        help="disable ingest integrity (on by default: each frame is "
             "CRC32C'd as the reader stages it and re-verified before its "
             "copy to the card, so a torn staging buffer fails typed "
             "before a launch)",
    )
    p.add_argument(
        "--witness-rate", dest="witness_rate", type=float,
        default=1.0 / 256.0, metavar="RATE",
        help="fraction of frames re-executed through torch ops in the "
             "writer and compared bit for bit BEFORE the frame reaches the "
             "sink (seeded; a divergence fails the run typed with the "
             "frame withheld; default 1/256, 0 = off; never past 512 "
             "reps)",
    )
    p.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="arm the fault-injection harness; same grammar as "
             "TPU_STENCIL_TORCH_FAULTS, which this flag overrides",
    )
    p.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="cpu runs on the CPU (the kernels' plain versions), offered "
             "as many times over as --mesh-frames x --pipe-stages x "
             "--shard-frames ask for; default (or gpu) runs on the CUDA "
             "devices and fails when there is none",
    )
    p.add_argument(
        "--stats-json", default=None, metavar="PATH",
        help="dump the run summary (frames, frames/s, per-stage "
             "seconds) as versioned JSON to PATH ('-' = stdout)",
    )
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome trace-event JSON of the pipeline ladder "
             "(stream.read/h2d/compute/d2h/write, one track per thread)",
    )
    p.add_argument(
        "--breakdown", action="store_true",
        help="print the per-stage pipeline table beside the modelled "
             "steady-state bound (max(stage), with the host-link H2D/D2H "
             "terms); implies span tracing for this run",
    )
    p.add_argument(
        "--metrics-text", default=None, metavar="PATH",
        help="write the driver-side metrics registry (stream_* "
             "histograms, stream_inflight_depth gauge) as "
             "Prometheus-style text to PATH ('-' = stdout)",
    )
    p.add_argument(
        "--flightrec-dir", dest="flightrec_dir", default=None,
        metavar="DIR",
        help="install the flight recorder with this anomaly-dump spool: "
             "witness mismatches and torn-staging checksum failures dump "
             "the frame's spans (trace id frame-<i>) as capped JSON files",
    )
    return p


def _parse_shard_frames(parser, value):
    """``RxC`` -> (R, C); ``0`` -> (0, 0) (auto); None passes through."""
    if value is None:
        return None
    if value == "0":
        return (0, 0)
    r, sep, c = value.lower().partition("x")
    if not sep or not r.isdigit() or not c.isdigit() \
            or int(r) < 1 or int(c) < 1:
        parser.error(
            f"--shard-frames must be RxC with positive integers, or 0 "
            f"for auto, got {value!r}"
        )
    return (int(r), int(c))


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    shard_frames = _parse_shard_frames(parser, ns.shard_frames)
    try:
        cfg = StreamConfig(
            input=ns.input,
            width=ns.width,
            height=ns.height,
            repetitions=ns.repetitions,
            image_type=ImageType(ns.image_type),
            filter_name=ns.filter_name,
            backend=ns.backend,
            output=ns.output,
            frames=ns.frames,
            schedule=ns.schedule,
            boundary=ns.boundary,
            block_h=ns.block_h,
            fuse=ns.fuse,
            pipeline_depth=ns.pipeline_depth,
            ring_buffers=ns.ring_buffers,
            mesh_frames=ns.mesh_frames,
            shard_frames=shard_frames,
            pipe_stages=ns.pipe_stages,
            shard_min_pixels=ns.shard_min_pixels,
            overlap=ns.overlap,
            checkpoint_every=ns.checkpoint_every,
            progress_every=ns.progress_every,
            dispatch_timeout_s=ns.dispatch_timeout_s,
            io_retries=ns.io_retries,
            max_engine_restarts=ns.max_engine_restarts,
            verify_ingest=ns.verify_ingest,
            witness_rate=ns.witness_rate,
        )
        out_spec = cfg.output_path  # stdin without --output dies here
    except ValueError as e:
        parser.error(str(e))
    if ns.faults is not None:
        from tpu_stencil_torch.resilience import faults as _faults

        try:
            _faults.configure(ns.faults)
        except ValueError as e:
            parser.error(str(e))
    # A stdout sink owns stdout: the binary frame stream must never be
    # interleaved with report text (a consumer piping '--output -' would
    # read corrupted frames), so the human summary moves to stderr and
    # the other stdout writers are refused.
    to_stdout_sink = out_spec == "-"
    if to_stdout_sink and ("-" in (ns.stats_json, ns.metrics_text)):
        parser.error(
            "--output - owns stdout; write --stats-json/--metrics-text "
            "to a file instead of '-'"
        )
    report_out = sys.stderr if to_stdout_sink else sys.stdout
    try:
        devices = resolve_devices(ns.platform)
    except NoDeviceError as e:
        print(f"tpu_stencil_torch stream: error: {e}", file=sys.stderr)
        return 2
    if devices[0].type == "cpu":
        # The CPU as N devices, as the JAX package's forced host device
        # count gives a CPU mesh its devices.
        r, c = cfg.shard_frames or (1, 1)
        devices = devices * (max(1, cfg.mesh_frames) * max(1, cfg.pipe_stages)
                             * max(1, r * c))
    tracing = bool(ns.trace or ns.breakdown)
    if tracing:
        obs.enable()
    if ns.flightrec_dir:
        obs.flight.install(spool_dir=ns.flightrec_dir)
    try:
        from tpu_stencil_torch.stream.engine import StreamFailure, run_stream

        try:
            result = run_stream(cfg, devices=devices, resume=ns.resume)
        except StreamFailure as e:
            print(f"stream FAILED: {e}", file=sys.stderr)
            return 1
        except KernelBuildError as e:
            print(f"stream FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        except ValueError as e:
            # Runtime-discovered usage errors (non-resumable sink with
            # --checkpoint-every, a checkpoint from a different job on
            # --resume): clean message + nonzero, never a traceback.
            print(f"stream: {e}", file=sys.stderr)
            return 2
        if tracing:
            _report_observability(ns, cfg, result, report_out, devices)
    finally:
        if tracing:
            obs.disable()
    if ns.metrics_text:
        obs.exposition.write_text(
            ns.metrics_text, obs.snapshot(), prefix="tpu_stencil_driver"
        )
    stages = " ".join(
        f"{k}={v:.3f}s" for k, v in sorted(result.stage_seconds.items())
        if v > 0
    )
    print(
        f"streamed {result.frames} frame(s)"
        + (f" (+{result.skipped} resumed)" if result.skipped else "")
        + (f" (engine restarted {result.restarts}x)"
           if result.restarts else "")
        + f" in {result.wall_seconds:.3f}s "
        f"({result.frames_per_second:.2f} frames/s, "
        f"depth={result.pipeline_depth}, backend={result.backend}"
        + (f" schedule={result.schedule}" if result.schedule else "")
        + (f" shard-frames={result.shard_frames[0]}x"
           f"{result.shard_frames[1]}"
           if result.shard_frames else "")
        + (f" pipe-stages={result.pipe_stages}"
           if result.pipe_stages > 1 else "")
        + (f" mesh-frames={result.n_devices}dev"
           if result.n_devices > 1 and not result.shard_frames
           and result.pipe_stages == 1 else "")
        + ")", file=report_out,
    )
    if result.per_device_frames and len(result.per_device_frames) > 1:
        # Mesh fan lanes, or pipeline groups under a composed topology.
        print(
            "per-device frames: "
            + " ".join(f"dev{d}={c}"
                       for d, c in enumerate(result.per_device_frames)),
            file=report_out,
        )
    if stages:
        print(f"stage seconds: {stages}", file=report_out)
    print(f"wrote {out_spec}" if out_spec != "null" else "sink: null",
          file=report_out)
    if ns.stats_json:
        payload = {
            "schema_version": STATS_SCHEMA_VERSION,
            "ts": time.monotonic(),
            "frames": result.frames,
            "skipped": result.skipped,
            "wall_seconds": result.wall_seconds,
            "frames_per_second": result.frames_per_second,
            "stage_seconds": result.stage_seconds,
            "backend": result.backend,
            "schedule": result.schedule,
            "pipeline_depth": result.pipeline_depth,
            "restarts": result.restarts,
            "n_devices": result.n_devices,
            "per_device_frames": result.per_device_frames,
            "shard_frames": (
                list(result.shard_frames) if result.shard_frames else None
            ),
            "pipe_stages": result.pipe_stages,
            "output": out_spec,
        }
        text = json.dumps(payload, indent=2, sort_keys=True)
        if ns.stats_json == "-":
            print(text)
        else:
            with open(ns.stats_json, "w") as fh:
                fh.write(text + "\n")
            print(f"wrote {ns.stats_json}", file=report_out)
    return 0


def _report_observability(ns, cfg: StreamConfig, result, out,
                          devices) -> None:
    tracer = obs.get_tracer()
    if ns.trace:
        wrote = obs.export.write_chrome_trace(ns.trace, tracer)
        if wrote:
            print(f"wrote trace {wrote}", file=out)
    if ns.breakdown:
        from tpu_stencil_torch.filters import get_filter

        print(obs.breakdown.render_breakdown(tracer), end="", file=out)
        print(obs.breakdown.render_stream(tracer, {
            "frame_bytes": cfg.frame_bytes,
            "reps": cfg.repetitions,
            "backend": result.backend,
            "schedule": result.schedule,
            "filter_name": cfg.filter_name,
            "h_img": cfg.height,
            "w_img": cfg.width,
            "channels": cfg.channels,
            "block_h": cfg.block_h,
            "fuse": cfg.fuse,
            "pipeline_depth": result.pipeline_depth,
            "frames": result.frames,
            "wall_seconds": result.wall_seconds,
            "n_devices": result.n_devices,
            "shard_frames": result.shard_frames,
            "pipe_stages": result.pipe_stages,
            "halo": get_filter(cfg.filter_name).halo,
            "one_card": len(set(devices[:result.n_devices])) == 1,
        }), end="", file=out)
        print(obs.breakdown.render_resilience(obs.snapshot()),
              end="", file=out)


if __name__ == "__main__":
    sys.exit(main())
