"""Human-readable per-phase breakdown table (``--breakdown``).

The port's counterpart of the job renderers of the JAX package's
``obs/breakdown.py``: :func:`aggregate` groups a tracer's spans by name and
:func:`render_breakdown` renders seconds, share of the run and call count
per phase, annotating the iterate phase with achieved device-memory GB/s
and % of the H100's peak through the shared roofline model
(:mod:`tpu_stencil_torch.runtime.roofline`). Nested spans (recorded depth
> 0, e.g. ``iterate.rep`` inside ``iterate``) indent under their parent and
are left out of the share's denominator. Classification is by the
recorded nesting depth, not by dotted names: ``sharded.halo_exchange``
and ``sharded.interior_compute`` are top-level spans whose time counts.

Side tables the CLI prints after the phase table:
:func:`render_introspection` (the kernel instances the warm-up launched,
beside the traffic model), :func:`render_resilience` (every nonzero
resilience counter), :func:`render_memory` (the device allocator, or
an explicit "unavailable" line) and, for a sharded run,
:func:`render_overlap` (the ghost-bytes model beside the probe spans). A
stream ``--breakdown`` adds :func:`render_stream` (the stage table beside
the modelled bound).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu_stencil_torch.obs.tracing import Tracer


def aggregate(tracer: Tracer) -> List[dict]:
    """Spans grouped by name, in first-start order:
    ``{name, seconds, count, t_first, depth}`` (depth = the minimum
    nesting depth the name was recorded at)."""
    agg: Dict[str, dict] = {}
    for rec in tracer.spans():
        row = agg.get(rec.name)
        if row is None:
            agg[rec.name] = {
                "name": rec.name, "seconds": rec.seconds, "count": 1,
                "t_first": rec.t0, "depth": rec.depth,
            }
        else:
            row["seconds"] += rec.seconds
            row["count"] += 1
            row["t_first"] = min(row["t_first"], rec.t0)
            row["depth"] = min(row["depth"], rec.depth)
    return sorted(agg.values(), key=lambda r: r["t_first"])


def render_breakdown(tracer: Tracer,
                     roofline_info: Optional[dict] = None) -> str:
    """The ``--breakdown`` table.

    ``roofline_info`` (optional): ``{frame_bytes, reps, backend,
    filter_name, h_img, block_h, fuse, schedule, steady_depth}``: when
    given, the ``iterate`` row (and the per-rep sub-row) gains achieved
    GB/s against the device-memory roofline.
    """
    rows = aggregate(tracer)
    if not rows:
        return "(no spans recorded)\n"
    total = sum(r["seconds"] for r in rows if r["depth"] == 0)
    gbps_by_name: Dict[str, str] = {}
    if roofline_info and roofline_info.get("reps"):
        from tpu_stencil_torch.runtime import roofline

        ri = roofline_info
        for name in ("iterate", "iterate.rep"):
            sec = next(
                (r["seconds"] for r in rows if r["name"] == name), 0.0
            )
            if sec <= 0.0:
                continue
            gbps, pct = roofline.achieved(
                ri["frame_bytes"], sec / ri["reps"], ri["backend"],
                ri["filter_name"], ri["h_img"],
                block_h=ri.get("block_h"), fuse=ri.get("fuse"),
            )
            gbps_by_name[name] = f"{gbps:8.2f} {pct:5.1f}%"
    name_w = max(len(r["name"]) + 2 * r["depth"] for r in rows)
    name_w = max(name_w, len("phase"))
    head = (f"{'phase':<{name_w}}  {'seconds':>10}  {'share':>6}  "
            f"{'calls':>6}  {'HBM GB/s':>8} {'peak':>6}")
    lines = [head, "-" * len(head)]
    for r in rows:
        sub = r["depth"] > 0
        label = "  " * r["depth"] + r["name"]
        share = "" if sub or total <= 0 else f"{100 * r['seconds'] / total:5.1f}%"
        lines.append(
            f"{label:<{name_w}}  {r['seconds']:>10.6f}  {share:>6}  "
            f"{r['count']:>6}  {gbps_by_name.get(r['name'], ''):>15}"
        )
    lines.append(f"{'total':<{name_w}}  {total:>10.6f}  {'100.0%':>6}")
    if roofline_info and roofline_info.get("schedule"):
        # The kernel schedule beside the numbers it explains. Traced runs
        # launch one rep per launch (device memory paid every rep), so the
        # steady-state depth is a model statement, not what the GB/s above
        # achieved.
        depth = roofline_info.get("steady_depth")
        depth_s = (
            f"  steady-state depth: {depth:g} reps per device-memory round "
            f"trip (traced runs launch per rep)" if depth else ""
        )
        lines.append(
            f"kernel schedule: {roofline_info['schedule']}{depth_s}"
        )
    return "\n".join(lines) + "\n"


def _mb(v) -> str:
    return "" if v is None else f"{v / 1e6:.2f}"


def _cell(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, (list, tuple)):
        return "x".join(str(x) for x in v)
    return str(v)


def render_introspection(records: List[dict]) -> str:
    """The kernel-instance table: per :func:`introspect.capture` record,
    the library's build seconds, the modelled MB and operations per rep,
    the compiler's MB per rep ("unavailable": hand-written kernels have
    none), then one row per kernel instance the warm-up launched: tile
    body, tile, grid, threads, dynamic shared memory, registers and
    resident blocks per SM ("-" where only a card can tell)."""
    if not records:
        return ""
    head = (f"{'site':<16}  {'build_s':>8}  {'model MB/rep':>12}  "
            f"{'model Gop/rep':>13}  {'compiler MB/rep':>15}")
    lines = ["", "kernel instances (introspection)", head, "-" * len(head)]
    for rec in records:
        site = rec.get("site", "?")
        build = rec.get("compile_seconds")
        ops = rec.get("model_ops_per_rep")
        lines.append(
            f"{site:<16}  {'' if build is None else f'{build:8.3f}':>8}  "
            f"{_mb(rec.get('model_bytes_per_rep')):>12}  "
            f"{'' if ops is None else f'{ops / 1e9:.4f}':>13}  "
            f"{'unavailable':>15}"
        )
        for k in rec.get("kernels") or ():
            lines.append(
                f"  {k['kernel']} body={k['body']} tile={k['block_h']}x"
                f"{k['tile_w']} fuse={k['fuse']} grid={_cell(k['grid'])} "
                f"threads={k['threads']} smem={k['smem_bytes']}B "
                f"regs={_cell(k.get('registers'))} "
                f"blocks/SM={_cell(k.get('blocks_per_sm'))}"
            )
        if rec.get("error"):
            lines.append(f"  ({rec['error']})")
    return "\n".join(lines) + "\n"


# The resilience counter schema (the JAX package's docs/RESILIENCE.md): registry name ->
# human row label. Rendered in declaration order; zero/absent counters
# are omitted — a healthy run prints no table at all.
_RESILIENCE_COUNTERS = (
    ("resilience_faults_injected_total", "faults injected"),
    ("resilience_retries_total", "retries (backoff taken)"),
    ("resilience_fallbacks_total", "schedule/backend demotions"),
    ("resilience_dispatch_timeouts_total", "dispatch watchdog timeouts"),
    ("resilience_stream_restarts_total", "stream engine restarts"),
    ("resilience_worker_crashes_total", "serve worker crashes"),
    ("deadline_expired_total", "deadline-expired requests"),
    # The integrity layer: every nonzero row here is a corruption
    # detected; the healthy-run table stays empty like the rows above.
    ("integrity_checksum_failures_total", "checksum mismatches (ingest)"),
    ("integrity_ingest_failures_total", "torn staging buffers"),
    ("integrity_witness_mismatch_total", "witness mismatches"),
    ("integrity_verify_failures_total", "client verify failures"),
    ("integrity_quarantines_total", "replicas quarantined"),
    ("integrity_readmits_total", "quarantine re-admissions"),
)


def render_resilience(snapshot: dict) -> str:
    """The ``--breakdown`` resilience side table: every nonzero
    resilience counter in a registry snapshot (driver or serve), one
    row each. Returns "" when nothing fired — a clean run stays clean;
    a run that injected, retried, demoted, timed out, or restarted
    says so next to the timings it explains."""
    counters = snapshot.get("counters", {})
    rows = [
        (label, counters[name])
        for name, label in _RESILIENCE_COUNTERS
        if counters.get(name)
    ]
    if not rows:
        return ""
    head = f"{'resilience':<32}  {'count':>6}"
    lines = ["", head, "-" * len(head)]
    for label, count in rows:
        lines.append(f"{label:<32}  {count:>6}")
    return "\n".join(lines) + "\n"


def render_memory(stats: Optional[dict]) -> str:
    """One device-memory line from
    :func:`tpu_stencil_torch.obs.introspect.device_memory_stats`; without
    a CUDA device it says so explicitly instead of rendering nothing."""
    if not stats:
        return ("device memory: unavailable "
                "(no CUDA allocator stats on this device)\n")
    order = ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
             "bytes_free", "bytes_limit")
    parts = [f"{k}={stats[k] / 1e6:.2f}MB" for k in order if k in stats]
    return "device memory: " + " ".join(parts) + "\n"


def render_overlap(tracer: Tracer, info: dict) -> str:
    """The overlap side table of a sharded ``--breakdown`` run: the
    modelled ghost bytes per rep and tile
    (:func:`tpu_stencil_torch.runtime.roofline.ici_ghost_bytes_per_rep`)
    beside the measured probe spans (exchange, interior, and under an
    overlap mode its interior and border halves), the exchange's implied
    GB/s, a per-edge table (one row per ``sharded.exchange_edge[*]`` span:
    its seconds, its modelled bytes, its implied GB/s) and the
    exchange/interior ratio ``--overlap auto`` gates on.

    The implied rates stand against no ceiling: on one card the exchange
    is device-to-device copies, and no interconnect rate is modelled.

    ``info``: ``{overlap, tile, channels, halo, mesh_shape, fuse,
    elem_bytes}``. Renders nothing when no probe span was recorded."""
    from tpu_stencil_torch.parallel.overlap import EDGE_NAMES

    by = {r["name"]: r for r in aggregate(tracer)}
    names = [n for n in (
        "sharded.halo_exchange", "sharded.interior_compute",
        "sharded.interior_overlap", "sharded.border_compute",
    ) if n in by]
    edge_rows = [(x, f"sharded.exchange_edge[{x}]") for x in EDGE_NAMES
                 if f"sharded.exchange_edge[{x}]" in by]
    if not names and not edge_rows:
        return ""
    from tpu_stencil_torch.runtime import roofline

    kw = dict(fuse=info.get("fuse") or 1,
              elem_bytes=info.get("elem_bytes", 1))
    model_mode = "edge" if info.get("overlap") == "edge" else "phased"
    bytes_rep = roofline.ici_ghost_bytes_per_rep(
        info["tile"], info["channels"], info["halo"], info["mesh_shape"],
        mode=model_mode, **kw)
    # The halo_exchange probe runs the phased (corner-routed) exchange, so
    # its rate divides the phased bytes whatever the schedule.
    bytes_phased = roofline.ici_ghost_bytes_per_rep(
        info["tile"], info["channels"], info["halo"], info["mesh_shape"],
        **kw)
    lines = [
        "",
        f"overlap schedule: {info['overlap']}  (ghost model: "
        f"{bytes_rep / 1e6:.6g} MB/rep/tile; implied GB/s against no "
        f"ceiling)",
    ]
    head = f"{'probe span':<26}  {'seconds':>10}  {'GB/s':>8}"
    lines += [head, "-" * len(head)]
    for n in names:
        sec = by[n]["seconds"] / by[n]["count"]
        gbps = ""
        if n == "sharded.halo_exchange" and sec > 0 and bytes_phased > 0:
            gbps = f"{bytes_phased / sec / 1e9:8.2f}"
        lines.append(f"{n:<26}  {sec:>10.6f}  {gbps:>8}")
    if edge_rows:
        # The per-edge probes copy one bare-tile strip each: the edge
        # pipeline's geometry, each span over its own edge's bytes.
        per_edge = roofline.ici_ghost_bytes_per_edge(
            info["tile"], info["channels"], info["halo"],
            info["mesh_shape"], elem_bytes=info.get("elem_bytes", 1),
            mode="edge")
        lines.append("per-edge exchange (one strip copy per edge; border "
                     "pieces wait per edge):")
        ehead = f"{'edge':<6}  {'seconds':>10}  {'model KB':>8}  {'GB/s':>8}"
        lines += [ehead, "-" * len(ehead)]
        for x, span_name in edge_rows:
            sec = by[span_name]["seconds"] / by[span_name]["count"]
            b = per_edge.get(x, 0.0)
            gbps = f"{b / sec / 1e9:8.2f}" if sec > 0 and b > 0 else ""
            lines.append(f"{x:<6}  {sec:>10.6f}  {b / 1e3:>8.3f}  {gbps:>8}")
    ex = by.get("sharded.halo_exchange")
    it = by.get("sharded.interior_compute")
    if ex and it and it["seconds"] > 0:
        from tpu_stencil_torch.runtime.autotune import OVERLAP_MIN_RATIO

        ratio = (ex["seconds"] / ex["count"]) / (it["seconds"] / it["count"])
        lines.append(
            f"probe ratio exchange/interior: {ratio:.3f} (--overlap auto "
            f"splits above {OVERLAP_MIN_RATIO:g} where a split measures "
            f"faster than off)")
    return "\n".join(lines) + "\n"


_STREAM_STAGES = ("stream.read", "stream.h2d", "stream.compute",
                  "stream.d2h", "stream.write")


def render_stream(tracer: Tracer, info: dict) -> str:
    """The stream side table: busy seconds per frame of each stage from the
    ``stream.*`` spans beside the modelled seconds
    (:func:`tpu_stencil_torch.runtime.roofline.stream_stage_seconds`), the
    measured pipeline bound (the slowest stage once the stages overlap,
    their sum at depth 1), and the modelled device-side bound beside the
    measured frames/s; under a fan, the whole-fan bound and the host
    link's cap; on a sharded run the per-tile model
    (:func:`~tpu_stencil_torch.runtime.roofline.
    sharded_stream_stage_seconds`), with H2D and D2H summed over a frame's
    shards; on a pipeline one stage's share of the reps and the fill and
    drain (:func:`~tpu_stencil_torch.runtime.roofline.
    pipeline_stream_stage_seconds`).

    ``info``: ``{frame_bytes, reps, backend, schedule, filter_name, h_img,
    w_img, channels, block_h, fuse, pipeline_depth, frames, wall_seconds,
    n_devices}``, plus ``{shard_frames, pipe_stages, halo, one_card}`` (the
    topology that ran, the filter's halo for the ghost model, whether the
    devices are one card). Renders nothing when no stream span was
    recorded."""
    by = {r["name"]: r for r in aggregate(tracer)}
    stages = [n for n in _STREAM_STAGES if n in by]
    if not stages:
        return ""
    from tpu_stencil_torch.runtime import roofline

    geometry = {"w_img": info.get("w_img"),
                "channels": info.get("channels", 1),
                "schedule": info.get("schedule")}
    shard = info.get("shard_frames")
    pipe = info.get("pipe_stages") or 1
    one_card = bool(info.get("one_card"))
    halo = info.get("halo") or 1
    if shard:
        model_stages = roofline.sharded_stream_stage_seconds(
            info["reps"], info["backend"], info["filter_name"],
            info["h_img"], info["w_img"], info.get("channels", 1),
            tuple(shard), halo=halo, block_h=info.get("block_h"),
            fuse=info.get("fuse"), one_card=one_card)
    elif pipe > 1:
        model_stages = roofline.pipeline_stream_stage_seconds(
            info["frame_bytes"], info["reps"], info["backend"],
            info["filter_name"], info["h_img"], pipe,
            block_h=info.get("block_h"), fuse=info.get("fuse"),
            one_card=one_card)
    else:
        model_stages = roofline.stream_stage_seconds(
            info["frame_bytes"], info["reps"], info["backend"],
            info["filter_name"], info["h_img"], block_h=info.get("block_h"),
            fuse=info.get("fuse"), **geometry)
    depth = info.get("pipeline_depth", 2)
    n_dev = info.get("n_devices", 1) or 1
    n_frames = info.get("frames") or 0
    lines = [
        "",
        f"stream pipeline: depth={depth}  "
        f"(steady state bound = {'max' if depth > 1 else 'sum'}(stage))",
    ]
    head = (f"{'stage':<16}  {'s/frame':>10}  {'frames':>6}  "
            f"{'model s/frame':>13}")
    lines += [head, "-" * len(head)]
    slowest = ("", 0.0)
    total = 0.0
    for n in stages:
        per = by[n]["seconds"] / by[n]["count"]
        if shard and n_frames and n in ("stream.h2d", "stream.d2h"):
            # One span per shard: a frame's copy is the sum of its shards'.
            per = by[n]["seconds"] / n_frames
        # On a fan (and a pipeline's devices) the device stages run n_dev
        # at once: a frame's share of the throughput is per / n_dev; read
        # and write serve every frame on one thread, and a sharded mesh
        # computes one frame at a time.
        eff = (per / n_dev
               if not shard
               and n in ("stream.h2d", "stream.compute", "stream.d2h")
               else per)
        total += eff
        if eff > slowest[1]:
            slowest = (n, eff)
        model = model_stages.get(n[len("stream."):])
        model_s = "" if model is None else f"{model:13.6f}"
        lines.append(
            f"{n:<16}  {per:>10.6f}  {by[n]['count']:>6}  {model_s:>13}")
    note = (f" ({shard[0]}x{shard[1]} shards)" if shard
            else f" ({pipe} stages)" if pipe > 1
            else f" ({n_dev} lanes)" if n_dev > 1 else "")
    if depth > 1 and slowest[1] > 0:
        lines.append(f"pipeline bound{note}: {slowest[0]} -> "
                     f"{1.0 / slowest[1]:.2f} frames/s")
    elif total > 0:
        lines.append(f"pipeline bound{note}: sum(stages) -> "
                     f"{1.0 / total:.2f} frames/s")
    measured = ""
    if info.get("frames") and info.get("wall_seconds"):
        measured = (f"measured {info['frames'] / info['wall_seconds']:.2f} "
                    f"frames/s vs ")
    if shard:
        fps = roofline.sharded_stream_frames_per_second(
            info["frame_bytes"], info["reps"], info["backend"],
            info["filter_name"], info["h_img"], info["w_img"],
            info.get("channels", 1), tuple(shard), halo=halo,
            block_h=info.get("block_h"), fuse=info.get("fuse"),
            pipeline_depth=depth, one_card=one_card)
        th, tw = roofline.shard_tile_shape(info["h_img"], info["w_img"],
                                           tuple(shard))
        ghost = roofline.ici_ghost_bytes_per_rep(
            (th, tw), info.get("channels", 1), halo, tuple(shard),
            mode="edge")
        lines.append(
            f"{measured}modeled sharded bound {fps:.2f} frames/s (tile "
            f"{th}x{tw}/device, ICI ghost model {ghost / 1e3:.3f} "
            f"KB/rep/device over "
            f"{'one card' if one_card else 'NVLink'}; host read/write "
            f"measured, not modeled)")
        return "\n".join(lines) + "\n"
    if pipe > 1:
        fps = roofline.pipeline_stream_frames_per_second(
            info["frame_bytes"], info["reps"], info["backend"],
            info["filter_name"], info["h_img"], pipe,
            frames=n_frames or None, block_h=info.get("block_h"),
            fuse=info.get("fuse"), pipeline_depth=depth, one_card=one_card)
        fill = roofline.pipeline_fill_drain_factor(n_frames or None, pipe)
        lines.append(
            f"{measured}modeled pipeline bound {fps:.2f} frames/s ({pipe} "
            f"stages, fill/drain factor {fill:.3f}; host read/write "
            f"measured, not modeled)")
        return "\n".join(lines) + "\n"
    fps_model = roofline.stream_frames_per_second(
        info["frame_bytes"], info["reps"], info["backend"],
        info["filter_name"], info["h_img"], block_h=info.get("block_h"),
        fuse=info.get("fuse"), pipeline_depth=depth, **geometry)
    label = "per-device " if n_dev > 1 else "device-side "
    lines.append(f"{measured}modeled {label}bound {fps_model:.2f} frames/s "
                 "(host read/write measured, not modeled)")
    if n_dev > 1:
        mesh_fps = roofline.mesh_stream_frames_per_second(
            info["frame_bytes"], info["reps"], info["backend"],
            info["filter_name"], info["h_img"], block_h=info.get("block_h"),
            fuse=info.get("fuse"), pipeline_depth=depth, n_devices=n_dev,
            **geometry)
        cap = roofline.pcie_contention_frames_per_second(info["frame_bytes"])
        lines.append(
            f"mesh fan-out: {n_dev} devices -> modeled whole-mesh bound "
            f"{mesh_fps:.2f} frames/s (PCIe contention cap {cap:.2f} "
            f"frames/s)")
    return "\n".join(lines) + "\n"
