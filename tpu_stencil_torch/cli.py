"""Command-line entry point.

Reference-compatible invocation (``mpi/mpi_convolution.c:328-348``):

    python -m tpu_stencil_torch image.raw 1920 2520 40 rgb

prints the compute-window wall-clock (the reference's headline metric) and
writes ``blur_<input>``. It runs on the GPU; ``--platform cpu`` runs on the
CPU instead, and with no GPU and no ``--platform cpu`` it exits 2 with a
message rather than running on the CPU.

``--trace``/``--breakdown`` trace the job's phases (the breakdown tables
print before the ``Execution time`` line, as the JAX package's do),
``--metrics-text`` writes the driver registry, ``--hlo-dump`` is accepted
and writes nothing.
"""

from __future__ import annotations

import sys

from tpu_stencil_torch import driver, obs
from tpu_stencil_torch.config import parse_args
from tpu_stencil_torch.devices import NoDeviceError, resolve_devices


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    cfg, ns = parse_args(argv)
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
    tracing = bool(ns.trace or ns.breakdown)
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
            _report_observability(ns.trace, ns.breakdown, cfg, result)
        if introspecting:
            _report_introspection(ns.breakdown, cfg, result, ns.hlo_dump)
    finally:
        if introspecting:
            obs.disable()
            obs.introspect.disable()
    if ns.metrics_text:
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


def _report_observability(trace_path, breakdown, cfg, result) -> None:
    """Write the trace and/or print the breakdown of one traced run, while
    the tracer is still installed."""
    tracer = obs.get_tracer()
    if trace_path:
        print(f"wrote trace {obs.export.write_chrome_trace(trace_path, tracer)}")
    if not breakdown:
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
