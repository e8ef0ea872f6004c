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
resilience counter) and :func:`render_memory` (the device allocator, or
an explicit "unavailable" line). The overlap and stream tables come with
their slices.
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
