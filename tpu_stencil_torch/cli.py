"""Command-line entry point.

Reference-compatible invocation (``mpi/mpi_convolution.c:328-348``):

    python -m tpu_stencil_torch image.raw 1920 2520 40 rgb

prints the compute-window wall-clock (the reference's headline metric) and
writes ``blur_<input>``. It runs on the GPU; ``--platform cpu`` runs on the
CPU instead, and with no GPU and no ``--platform cpu`` it exits 2 with a
message rather than running on the CPU.

``--trace``/``--breakdown`` trace the job's phases (the breakdown tables
print before the ``Execution time`` line, as the JAX package's do; a
sharded run adds the overlap table),
``--metrics-text`` writes the driver registry, ``--hlo-dump`` is accepted
and writes nothing.

``python -m tpu_stencil_torch serve ...`` is the serving engine
(:mod:`tpu_stencil_torch.serve.cli`), ``stream ...`` the streaming engine
(:mod:`tpu_stencil_torch.stream.cli`), ``net ...`` the network serving
tier (:mod:`tpu_stencil_torch.net.cli`), ``fed ...`` the federation front
router (:mod:`tpu_stencil_torch.fed.cli`), ``ctrl ...`` the elastic
control plane (:mod:`tpu_stencil_torch.ctrl.cli`) and ``perf ...`` the
perf sentry (:mod:`tpu_stencil_torch.obs.sentry`), each dispatched ahead
of the job's parser as in the JAX package.

Several processes (the reference's ``mpiexec -n P``)::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m tpu_stencil_torch image.raw 1920 2520 40 rgb --mesh 2x1

Each process joins the gloo group first (``distributed.initialize``),
takes rank 0's job (``broadcast_config``) and rank 0's observability
flags, and runs on device ``LOCAL_RANK % device_count`` (on one card
every rank runs on ``cuda:0``); the trace, the breakdown, the
introspection tables and the metrics text are rank 0's to write.
"""

from __future__ import annotations

import os
import sys

from tpu_stencil_torch import driver, obs
from tpu_stencil_torch.config import parse_args
from tpu_stencil_torch.devices import NoDeviceError, resolve_devices
from tpu_stencil_torch.parallel import distributed
from tpu_stencil_torch.resilience import deadline as _deadline


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        # The serving engine owns its own flags, one process.
        from tpu_stencil_torch.serve import cli as serve_cli

        return serve_cli.main(argv[1:])
    if argv and argv[0] == "stream":
        # The streaming engine owns its own flags, one process.
        from tpu_stencil_torch.stream import cli as stream_cli

        return stream_cli.main(argv[1:])
    if argv and argv[0] == "net":
        # The network serving tier (HTTP frontend, replica fleet, drain)
        # owns its own flags, validated before any device is touched.
        from tpu_stencil_torch.net import cli as net_cli

        return net_cli.main(argv[1:])
    if argv and argv[0] == "fed":
        # The federation front router: membership, breakers and hedged
        # forwarding over many net hosts; it never touches a device.
        from tpu_stencil_torch.fed import cli as fed_cli

        return fed_cli.main(argv[1:])
    if argv and argv[0] == "ctrl":
        # The elastic control plane: hysteresis autoscaling,
        # preemption-aware drain and warm-start member launches over a
        # federation; its members run on the card unless told otherwise.
        from tpu_stencil_torch.ctrl import cli as ctrl_cli

        return ctrl_cli.main(argv[1:])
    if argv and argv[0] == "perf":
        # The perf sentry (log/check/report) touches no device.
        from tpu_stencil_torch.obs import sentry

        return sentry.main(argv[1:])
    cfg, ns = parse_args(argv)
    # Joining the job's processes leads main, as MPI_Init does
    # (mpi/mpi_convolution.c:23); a no-op for one process.
    distributed.initialize(timeout_s=_deadline.resolve(cfg.dispatch_timeout_s))
    multi = distributed.process_count() > 1
    rank0 = distributed.process_index() == 0
    if multi:
        # Rank 0 validates, everyone else receives (mpi/mpi_convolution.c:
        # 50-70): ranks launched with divergent argv would otherwise run
        # different jobs against the same files.
        cfg = distributed.broadcast_config(cfg if rank0 else None)
    trace_path, breakdown = _broadcast_obs_flags(ns)
    if ns.faults is not None:
        # Arm the fault-injection harness (the spec was validated at
        # parse time); it overrides TPU_STENCIL_TORCH_FAULTS.
        from tpu_stencil_torch.resilience import faults as _faults

        _faults.configure(ns.faults)
    try:
        devices = resolve_devices(ns.platform)
    except NoDeviceError as e:
        print(f"tpu_stencil_torch: error: {e}", file=sys.stderr)
        return 2
    if multi and devices[0].type == "cuda":
        devices = [devices[int(os.environ.get("LOCAL_RANK", "0"))
                           % len(devices)]]
    tracing = bool(trace_path or breakdown)
    # Introspection rides on any traced run or an explicit --hlo-dump.
    introspecting = tracing or bool(ns.hlo_dump)
    if introspecting:
        if tracing:
            obs.enable()
        obs.introspect.enable(hlo_dir=ns.hlo_dump)
    try:
        result = driver.run_job(
            cfg, devices=devices, profile_dir=ns.profile,
            checkpoint_every=ns.checkpoint_every, resume=ns.resume,
        )
        if tracing:
            _report_observability(trace_path, breakdown, cfg, result)
        if introspecting and rank0:
            _report_introspection(breakdown, cfg, result, ns.hlo_dump)
    finally:
        if introspecting:
            obs.disable()
            obs.introspect.disable()
    if ns.metrics_text and rank0:
        # One writer: several racing on one path would interleave it.
        _write_metrics_text(ns.metrics_text)
    # Reference-format output line (mpi/mpi_convolution.c:274 prints seconds).
    print(f"Execution time: {result.compute_seconds:.3f} sec")
    if ns.time:
        sched = (
            f" schedule={result.schedule or 'default'}"
            if result.backend == "pallas" else ""
        )
        if result.block_h is not None:
            # Effective launched geometry (post align/clamp).
            sched += f" block_h={result.block_h} fuse={result.fuse}"
        if result.overlap is not None:
            # The resolved overlap schedule (auto and fused-split resolve,
            # a degenerate tile runs off): what ran.
            sched += f" overlap={result.overlap}"
        launches = ",".join(f"{k}:{v}" for k, v in result.launches.items())
        if result.body:
            # The tile body the kernels ran (cuda_stencil.tile_body).
            launches += f" body={result.body}"
        if cfg.backend in ("auto", "autotune"):
            # Measurements the autotuner made before the compute window
            # (0 on a warm cache and off a card).
            launches += f" tune_probes={result.tune_probes}"
        print(
            f"total (incl. I/O): {result.total_seconds:.3f} sec; "
            f"backend={result.backend}{sched} mesh={result.mesh_shape} "
            f"launches={launches}"
        )
    print(f"wrote {result.output_path}")
    return 0


def _broadcast_obs_flags(ns):
    """Rank 0's ``--trace`` path and ``--breakdown`` flag on every rank:
    tracing changes what every rank exchanges (one rep per call, the
    sharded runner's probes, the trace merge), so ranks that disagreed
    would hang. Returns (trace_path, breakdown)."""
    path, breakdown = distributed.broadcast_strs(
        [ns.trace or "", "1" if ns.breakdown else ""])
    return path or None, bool(breakdown)


def _report_observability(trace_path, breakdown, cfg, result) -> None:
    """Write the trace and/or print the breakdown of one traced run, while
    the tracer is still installed. Every process joins the trace merge;
    rank 0 writes it and prints the breakdown."""
    tracer = obs.get_tracer()
    if trace_path:
        wrote = obs.export.write_chrome_trace(trace_path, tracer)
        if wrote:
            print(f"wrote trace {wrote}")
    if not breakdown or distributed.process_index() != 0:
        return
    # fuse is 1 for the GB/s: a traced run launches one rep at a time, so
    # it pays device memory every rep; the steady-state depth beside it is
    # the model's statement about the untraced run.
    steady_depth = None
    if result.backend == "pallas":
        from tpu_stencil_torch.runtime import roofline

        steady_depth = roofline.effective_fuse(
            cfg.filter_name, cfg.height, block_h=result.block_h,
            fuse=result.fuse, schedule=result.schedule, w_img=cfg.width,
            channels=cfg.channels, reps=cfg.repetitions,
            n_frames=cfg.frames)
    print(obs.breakdown.render_breakdown(tracer, roofline_info={
        "frame_bytes": cfg.nbytes,
        "reps": cfg.repetitions,
        "backend": result.backend,
        "filter_name": cfg.filter_name,
        "h_img": cfg.height,
        "block_h": result.block_h,
        "fuse": 1,
        "schedule": result.schedule,
        "steady_depth": steady_depth,
    }), end="")
    print(obs.breakdown.render_resilience(obs.snapshot()), end="")
    if result.mesh_shape is not None and result.overlap is not None:
        # Sharded runs: the ghost-bytes model beside the probe spans, at
        # fuse 1 and 1 byte per element: the probes exchange one
        # halo-deep ring of the uint8 tile.
        from tpu_stencil_torch import filters
        from tpu_stencil_torch.ops import lowering
        from tpu_stencil_torch.parallel import partition

        plan = lowering.plan_filter(filters.get_filter(cfg.filter_name))
        print(obs.breakdown.render_overlap(tracer, {
            "overlap": result.overlap,
            "tile": partition.tile_shape(cfg.height, cfg.width,
                                         result.mesh_shape),
            "channels": cfg.channels,
            "halo": plan.halo,
            "mesh_shape": result.mesh_shape,
            "fuse": 1,
            "elem_bytes": 1,
        }), end="")


def _report_introspection(breakdown, cfg, result, hlo_dump) -> None:
    """Hold each site's record against the traffic model (refreshing the
    ``introspect_*`` gauges before any ``--metrics-text`` write) and, under
    ``--breakdown``, print the kernel-instance and device-memory tables
    after the phase table."""
    recs = obs.introspect.records()
    if recs:
        from tpu_stencil_torch.runtime import roofline

        analytic = roofline.analytic_bytes_per_rep(
            cfg.nbytes, result.backend, cfg.filter_name, cfg.height,
            block_h=result.block_h, fuse=result.fuse,
            schedule=result.schedule, w_img=cfg.width,
            channels=cfg.channels, reps=cfg.repetitions,
            n_frames=cfg.frames,
        )
        for rec in recs:
            if rec.get("site") in ("driver.warmup", "sharded.iterate"):
                obs.introspect.cross_check(rec, analytic)
        if breakdown:
            print(obs.breakdown.render_introspection(recs), end="")
    if breakdown:
        print(obs.breakdown.render_memory(
            obs.introspect.device_memory_stats()), end="")
    if hlo_dump:
        print(obs.introspect.hlo_note(hlo_dump))


def _write_metrics_text(path: str) -> None:
    notes = ()
    if obs.introspect.device_memory_stats() is None:
        notes = ("device memory gauges unavailable: no CUDA allocator stats "
                 "on this device",)
    obs.exposition.write_text(path, obs.snapshot(),
                              prefix="tpu_stencil_driver", notes=notes)


if __name__ == "__main__":
    sys.exit(main())
