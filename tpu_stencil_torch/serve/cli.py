"""``python -m tpu_stencil_torch serve``: drive the serving engine.

The port's counterpart of the JAX package's ``serve/cli.py``, every flag
kept. It runs the synthetic load generator against an in-process
:class:`~tpu_stencil_torch.serve.engine.StencilServer` on the card (or on
the CPU under ``--platform cpu``) and prints a throughput / tail-latency
report. ``--self-test`` instead runs a deterministic correctness pass: a
handful of mixed-shape grey and RGB requests checked byte for byte
against the independent NumPy golden model, plus the backpressure and
cache-hit invariants. Without a card and without ``--platform cpu`` it
exits 2 with "no CUDA device".
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpu_stencil_torch.config import BACKENDS, OVERLAP_MODES

# --stats-json payload schema. 1 = the PR-1 report dict plus the
# schema_version/ts fields themselves. Bump on breaking shape changes.
STATS_SCHEMA_VERSION = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch serve",
        description="In-process async micro-batching inference service "
                    "driven by a synthetic load generator.",
    )
    p.add_argument("--self-test", action="store_true",
                   help="run the deterministic correctness/backpressure "
                        "smoke test and exit (0 = OK)")
    p.add_argument("--http", default=None, metavar="URL",
                   help="drive a network tier at URL instead of an "
                        "in-process server: "
                        "the same closed/open load models (incl. "
                        "--rate-fps) POST raw frames at /v1/blur and "
                        "the report reads the tier's own /statusz "
                        "registry — identical schema, remote target. "
                        "Engine flags "
                        "(--max-queue/--max-batch/--overlap/...) are "
                        "ignored: the tier's own CLI owns them")
    p.add_argument("--mode", default="closed", choices=["closed", "open"],
                   help="load model: closed (submit-and-wait workers) or "
                        "open (fixed-rate arrivals; overload rejects)")
    p.add_argument("--requests", type=int, default=64,
                   help="total synthetic requests (default 64)")
    p.add_argument("--concurrency", type=int, default=4,
                   help="closed-loop worker count (default 4)")
    p.add_argument("--rate", type=float, default=200.0,
                   help="open-loop arrival rate in req/s (default 200)")
    p.add_argument("--burst", type=int, default=1, metavar="N",
                   help="bursty open-loop arrivals: N simultaneous "
                        "same-shape requests per tick (distinct "
                        "payloads), tick gaps Poisson-jittered (seeded "
                        "exponential) at the same mean request rate — "
                        "the client shape that exercises cross-request "
                        "coalescing at the network edge (--http against "
                        "a --coalesce-window-us tier); p50/p99 report "
                        "next to achieved fps as always (default 1 = "
                        "the classic metronome; needs --mode open or "
                        "--rate-fps)")
    p.add_argument("--zipf", type=float, default=None, metavar="S",
                   help="keyspace mode: draw requests from a seeded "
                        "pool of --zipf-keys DISTINCT frames under a "
                        "Zipf(S) popularity law (S=0 uniform, S~1 "
                        "web-traffic skew) instead of all-distinct "
                        "frames — the repeat-heavy stream a "
                        "--result-cache-mb tier serves; the report "
                        "adds cache_hit_ratio from the target's own "
                        "result_cache_* counters. Deterministic per "
                        "--seed")
    p.add_argument("--zipf-keys", type=int, default=16, metavar="K",
                   help="distinct frames in the --zipf pool "
                        "(default 16)")
    p.add_argument("--ramp", default=None,
                   metavar="START_FPS:END_FPS:SECONDS",
                   help="ramped open-loop profile: sweep the offered "
                        "frame rate linearly from START_FPS to END_FPS "
                        "over SECONDS, stepped across --ramp-phases "
                        "equal metronome phases (arrivals due on "
                        "schedule regardless of completions); forces "
                        "--mode open, "
                        "overrides --requests with the schedule's own "
                        "count, and reports per-phase achieved fps + "
                        "p99 from client-side records. Seeded; "
                        "exclusive with --rate-fps and --burst > 1")
    p.add_argument("--ramp-phases", type=int, default=4, metavar="N",
                   help="equal-duration phases the --ramp window is "
                        "stepped across (default 4)")
    p.add_argument("--rate-fps", type=float, default=None, metavar="FPS",
                   help="open-loop fixed-frame-rate mode: one frame due "
                        "every 1/FPS seconds regardless of completions "
                        "(the live-video arrival law; forces --mode "
                        "open at FPS); reports achieved vs requested "
                        "rate")
    p.add_argument("--reps", type=int, default=5,
                   help="filter applications per request (default 5)")
    p.add_argument("--filter", dest="filter_name", default="gaussian",
                   help="filter name (default gaussian)")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS),
                   help="compute backend (default auto; pallas runs the "
                        "hand-written kernels, xla torch ops)")
    p.add_argument("--overlap", default="off", choices=list(OVERLAP_MODES),
                   help="interior/border overlap schedule (same vocabulary "
                        "as the run CLI); recorded in the overlap_mode "
                        "gauge. off (default) keeps every request on the "
                        "single-device bucket route; any other mode "
                        "ACTIVATES sharded routing — requests of at least "
                        "--shard-min-pixels run the sharded runner over "
                        "every visible device under this schedule, bucketed "
                        "separately so small requests never wait inside a "
                        "sharded dispatch. Byte-exact either way")
    p.add_argument("--shard-min-pixels", dest="shard_min_pixels",
                   type=int, default=1 << 20, metavar="PX",
                   help="sharded-routing size threshold in true pixels "
                        "(H*W): with a non-off --overlap, requests at or "
                        "above it route through the spatially-sharded "
                        "path; below it they stay on the bucket "
                        "route (default 1048576 = ~1024x1024)")
    p.add_argument("--request-timeout", dest="request_timeout_s",
                   type=float, default=0.0, metavar="SECONDS",
                   help="per-request deadline: a request still queued "
                        "past it fails typed (DeadlineExceeded) instead "
                        "of occupying a batch slot (0 = none)")
    p.add_argument("--verify", default=None, choices=["crc", "golden"],
                   help="check every completed response: crc "
                        "validates each body against the tier's "
                        "X-Result-Crc32c stamp (needs --http — only the "
                        "network tiers stamp) and stamps requests with "
                        "X-Content-Crc32c; golden compares small frames "
                        "against the independent NumPy golden (works "
                        "in-process too). Failures count "
                        "verify_failures_total in the report; the "
                        "closed loop fails fast on the first one")
    p.add_argument("--tenant", default=None, metavar="NAME",
                   help="stamp every request with this X-Tenant (needs "
                        "--http; the network tiers meter per-tenant "
                        "device-seconds and quota against it); the "
                        "report gains a 'cost' rollup of the tier's "
                        "X-Cost-* response headers")
    p.add_argument("--witness-rate", dest="witness_rate", type=float,
                   default=0.0, metavar="RATE",
                   help="fraction of completed requests the in-process "
                        "engine re-executes through a different "
                        "program, torch ops (seeded; counted in "
                        "integrity_witness_*; 0 = off, the in-process "
                        "default)")
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="arm the fault-injection harness (chaos testing "
                        "/ failure reproduction); same grammar as "
                        "TPU_STENCIL_TORCH_FAULTS, which this flag "
                        "overrides")
    p.add_argument("--max-queue", type=int, default=256,
                   help="bounded queue depth; beyond it submissions are "
                        "rejected (default 256)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="requests per micro-batch (default 8)")
    p.add_argument("--shapes", default="48x36,64x48,30x50",
                   help="comma-separated HxW request shapes to cycle")
    p.add_argument("--channels", default="3",
                   help="comma-separated channel counts to cycle "
                        "(1=grey, 3=rgb; default 3)")
    p.add_argument("--seed", type=int, default=0, help="loadgen seed")
    p.add_argument("--per-request", dest="per_request",
                   action="store_true",
                   help="print one line per completed request with its "
                        "latency and X-Trace-Id (the id every hop "
                        "echoed and /debug/trace assembles); the "
                        "summary always names the slowest trace")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="the device to serve on: gpu (the default, the "
                        "current CUDA device) or cpu")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="dump the report + metrics registry snapshot as "
                        "JSON to PATH ('-' = stdout); versioned schema "
                        "(schema_version + monotonic ts fields)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="span tracing (tpu_stencil_torch.obs): write a "
                        "Chrome "
                        "trace-event JSON of the serve pipeline (enqueue/"
                        "batch-form/cache/execute/drain spans, one track "
                        "per thread) to PATH; works with --self-test too")
    p.add_argument("--metrics-text", default=None, metavar="PATH",
                   help="write the server's metrics registry as "
                        "Prometheus-style text exposition to PATH "
                        "('-' = stdout); includes the device-memory "
                        "gauges and (under --trace) the per-cache-entry "
                        "introspect_serve_bucket_* gauges")
    p.add_argument("--perf-log", nargs="?", const=None, default=False,
                   metavar="PATH",
                   help="append this loadgen run's p50 latency to the "
                        "perf-sentry history (default path: see "
                        "'python -m tpu_stencil_torch perf --help'); gate "
                        "later runs with 'perf check'")
    return p


def _parse_shapes(parser, value):
    out = []
    for part in value.split(","):
        h, sep, w = part.strip().lower().partition("x")
        # "0".isdigit() is True: zero dims must die here as a usage error,
        # not as a bucketing traceback out of the worker thread.
        if (not sep or not h.isdigit() or not w.isdigit()
                or int(h) < 1 or int(w) < 1):
            parser.error(
                f"--shapes must be HxW[,HxW...] with positive integers, "
                f"got {value!r}"
            )
        out.append((int(h), int(w)))
    return tuple(out)


def self_test(metrics_text=None, device=None) -> int:
    """Deterministic smoke on ``device`` (None: the card): golden-model
    exactness over mixed shapes and channel counts (including a 1-pixel
    image and a request above the ladder's top edge), cache reuse, and
    backpressure rejection. ``metrics_text``: write the correctness
    server's registry as text exposition."""
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.config import ServeConfig
    from tpu_stencil_torch.ops import stencil
    from tpu_stencil_torch.serve.engine import QueueFull, StencilServer

    rng = np.random.default_rng(7)
    cases = [
        (rng.integers(0, 256, (40, 30, 3), dtype=np.uint8), 3),
        (rng.integers(0, 256, (17, 23), dtype=np.uint8), 2),     # grey
        (rng.integers(0, 256, (1, 1), dtype=np.uint8), 1),       # 1 pixel
        (rng.integers(0, 256, (20, 44, 3), dtype=np.uint8), 0),  # identity
        # A later dispatch of case 0's key: must be a cache HIT.
        (rng.integers(0, 256, (40, 30, 3), dtype=np.uint8), 3),
    ]
    f = filters.get_filter("gaussian")
    with StencilServer(ServeConfig(max_queue=16, max_batch=4,
                                   bucket_edges=(8, 16, 32)),
                       device=device) as server:
        for img, reps in cases:
            want = stencil.reference_stencil_numpy(img, f, reps)
            got = server.submit(img, reps).result(timeout=300)
            if not np.array_equal(got, want):
                print(f"serve self-test FAILED: shape={img.shape} "
                      f"reps={reps} mismatch", file=sys.stderr)
                return 1
        stats = server.stats()
    if metrics_text:
        from tpu_stencil_torch.obs import exposition

        exposition.write_text(metrics_text, stats,
                              prefix="tpu_stencil_serve")
    if stats["counters"]["cache_hits_total"] < 1:
        print("serve self-test FAILED: no executable-cache hit",
              file=sys.stderr)
        return 1
    # Backpressure: a parked (never-started) server must reject, not grow.
    parked = StencilServer(ServeConfig(max_queue=2), start=False,
                           device=device)
    img = cases[0][0]
    parked.submit(img, 1)
    parked.submit(img, 1)
    try:
        parked.submit(img, 1)
        print("serve self-test FAILED: full queue accepted a request",
              file=sys.stderr)
        return 1
    except QueueFull:
        pass
    finally:
        parked.close()
    if parked.stats()["counters"]["rejected_total"] != 1:
        print("serve self-test FAILED: rejection not counted",
              file=sys.stderr)
        return 1
    print(f"serve self-test OK: {len(cases)} requests exact, "
          f"cache_hits={stats['counters']['cache_hits_total']}, "
          f"batches={stats['counters']['batches_total']}, "
          "backpressure rejects when full")
    return 0


def _export_trace(path: str) -> None:
    from tpu_stencil_torch import obs

    wrote = obs.export.write_chrome_trace(path, obs.get_tracer())
    if wrote:
        print(f"wrote trace {wrote}")


def _platform_name(device) -> str:
    """The sentry record's ``platform``: the device type the server ran
    on, in the ``--platform`` vocabulary (``gpu`` for a CUDA device)."""
    return "gpu" if device.type == "cuda" else device.type


def _check_args(parser, ns):
    """The flag checks the JAX package makes, as usage errors. Returns
    (shapes, channels, ramp)."""
    shapes = _parse_shapes(parser, ns.shapes)
    try:
        channels = tuple(int(c) for c in ns.channels.split(","))
        if not all(c in (1, 3) for c in channels):
            raise ValueError
    except ValueError:
        parser.error(f"--channels must be 1 and/or 3, got {ns.channels!r}")
    if ns.verify == "crc" and not ns.http:
        parser.error("--verify crc needs --http: only the network "
                     "tiers stamp X-Result-Crc32c (use --verify golden "
                     "for an in-process server)")
    if ns.tenant and not ns.http:
        parser.error("--tenant needs --http: only the network tiers "
                     "meter X-Tenant")
    if ns.rate_fps is not None and not ns.rate_fps > 0:
        parser.error(f"--rate-fps must be > 0, got {ns.rate_fps}")
    if ns.burst < 1:
        parser.error(f"--burst must be >= 1, got {ns.burst}")
    if ns.burst > 1 and ns.mode != "open" and ns.rate_fps is None:
        parser.error("--burst needs --mode open (or --rate-fps): "
                     "it is an open-loop arrival mode")
    if ns.zipf is not None and ns.zipf < 0:
        parser.error(f"--zipf must be >= 0, got {ns.zipf}")
    if ns.zipf_keys < 1:
        parser.error(f"--zipf-keys must be >= 1, got {ns.zipf_keys}")
    ramp = None
    if ns.ramp is not None:
        try:
            parts = ns.ramp.split(":")
            if len(parts) != 3:
                raise ValueError
            ramp = tuple(float(v) for v in parts)
            if not all(v > 0 for v in ramp):
                raise ValueError
        except ValueError:
            parser.error(
                f"--ramp must be START_FPS:END_FPS:SECONDS with "
                f"three positive numbers, got {ns.ramp!r}"
            )
        if ns.rate_fps is not None:
            parser.error("--ramp and --rate-fps are exclusive "
                         "arrival laws (the ramp sweeps the rate)")
        if ns.burst > 1:
            parser.error("--ramp is a metronome profile; "
                         "--burst > 1 is not supported with it")
        if ns.ramp_phases < 1:
            parser.error(f"--ramp-phases must be >= 1, "
                         f"got {ns.ramp_phases}")
    return shapes, channels, ramp


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.faults is not None:
        from tpu_stencil_torch.resilience import faults as _faults

        try:
            _faults.configure(ns.faults)
        except ValueError as e:
            parser.error(str(e))
    if not ns.self_test:
        shapes, channels, ramp = _check_args(parser, ns)
        if not ns.http:
            from tpu_stencil_torch.config import ServeConfig

            try:
                cfg = ServeConfig(
                    filter_name=ns.filter_name, backend=ns.backend,
                    max_queue=ns.max_queue, max_batch=ns.max_batch,
                    overlap=ns.overlap,
                    shard_min_pixels=ns.shard_min_pixels,
                    request_timeout_s=ns.request_timeout_s,
                    witness_rate=ns.witness_rate,
                )
            except ValueError as e:
                parser.error(str(e))
    device = None
    if ns.self_test or not ns.http:
        from tpu_stencil_torch.devices import NoDeviceError, resolve_device

        try:
            device = resolve_device(ns.platform)
        except NoDeviceError as e:
            print(f"tpu_stencil_torch serve: error: {e}", file=sys.stderr)
            return 2
    if ns.trace:
        from tpu_stencil_torch import obs

        obs.enable()
        # Traced serve runs also introspect each cache entry (the kernel
        # instance it launches, into the server registry).
        obs.introspect.enable()
    if ns.self_test:
        try:
            rc = self_test(metrics_text=ns.metrics_text, device=device)
            if ns.trace:
                _export_trace(ns.trace)
            return rc
        finally:
            if ns.trace:
                obs.disable()
                obs.introspect.disable()

    from tpu_stencil_torch.serve import loadgen
    from tpu_stencil_torch.serve.engine import StencilServer

    try:
        loadgen_kwargs = dict(
            mode=ns.mode, requests=ns.requests,
            concurrency=ns.concurrency, rate=ns.rate, reps=ns.reps,
            shapes=shapes, channels=channels, seed=ns.seed,
            rate_fps=ns.rate_fps, burst=ns.burst,
            verify=ns.verify, verify_filter=ns.filter_name,
            per_request=ns.per_request,
            zipf=ns.zipf, zipf_keys=ns.zipf_keys,
            ramp=ramp, ramp_phases=ns.ramp_phases,
        )
        if ns.http:
            # The network-tier target: same loops, same report schema,
            # no in-process server.
            target = loadgen.HttpTarget(ns.http, verify=ns.verify,
                                        tenant=ns.tenant)
            try:
                report = loadgen.run(target, **loadgen_kwargs)
            finally:
                target.close()
        else:
            with StencilServer(cfg, device=device) as server:
                report = loadgen.run(server, **loadgen_kwargs)
        if ns.trace:
            _export_trace(ns.trace)
    finally:
        if ns.trace:
            obs.disable()
            obs.introspect.disable()
    if ns.metrics_text:
        from tpu_stencil_torch.obs import exposition

        exposition.write_text(
            ns.metrics_text, report["stats"],
            prefix="tpu_stencil_net" if ns.http else "tpu_stencil_serve",
        )
    _print_report(ns, report)
    if ns.perf_log is not False:
        _log_perf(ns, report, ramp, device)
    if ns.stats_json:
        # Versioned schema: consumers dispatch on schema_version; ts is
        # monotonic so captures within one process order totally.
        report["schema_version"] = STATS_SCHEMA_VERSION
        report["ts"] = time.monotonic()
        payload = json.dumps(report, indent=2, sort_keys=True)
        if ns.stats_json == "-":
            print(payload)
        else:
            with open(ns.stats_json, "w") as fh:
                fh.write(payload + "\n")
            print(f"wrote {ns.stats_json}")
    return 0


def _print_report(ns, report: dict) -> None:
    c = report["stats"]["counters"]
    if ns.per_request and report.get("per_request"):
        # The X-Trace-Id column is the id every hop echoed.
        print(f"{'i':>4}  {'latency_ms':>10}  {'ok':>2}  X-Trace-Id")
        for rec in report["per_request"]:
            print(f"{rec['i']:>4}  {rec['latency_s'] * 1e3:>10.2f}  "
                  f"{'y' if rec['ok'] else 'n':>2}  {rec['trace_id']}")
    print(
        f"served {report['completed']}/{report['requests']} requests "
        f"in {report['wall_seconds']:.3f}s "
        f"({report['throughput_rps']:.1f} req/s, {report['mode']}-loop"
        f"{', http' if ns.http else ''})"
    )
    if report.get("slowest_trace_id"):
        print(
            f"slowest request: "
            f"{report['slowest_latency_s'] * 1e3:.2f}ms "
            f"trace {report['slowest_trace_id']} "
            f"(GET /debug/trace/<id>; flightrec dump if it tripped a "
            f"trigger)"
        )
    if ns.http:
        print(
            f"latency p50={report['p50_s'] * 1e3:.2f}ms "
            f"p99={report['p99_s'] * 1e3:.2f}ms; "
            f"rejected={report['rejected']} "
            f"shed={c.get('shed_total', 0)} "
            f"fleet_batches={c.get('fleet_batches_total', 0)} "
            f"warm={c.get('warm_submits_total', 0)}"
        )
    else:
        print(
            f"latency p50={report['p50_s'] * 1e3:.2f}ms "
            f"p99={report['p99_s'] * 1e3:.2f}ms; "
            f"rejected={report['rejected']} batches={c['batches_total']} "
            f"cache={c['cache_hits_total']}h/{c['cache_misses_total']}m "
            f"padded_waste={c['padded_pixels_total']}px"
        )
    if "verify_failures_total" in report:
        print(
            f"verify ({report['verify']}): "
            f"{report['verify_failures_total']} failure(s) over "
            f"{report['completed']} completed"
        )
    if "cost" in report and report["cost"]["responses"]:
        cost = report["cost"]
        srcs = ", ".join(f"{k}={v}" for k, v in
                         sorted(cost["by_source"].items()))
        print(
            f"cost (tenant {cost['tenant']}): "
            f"{cost['device_seconds']:.4f}s device over "
            f"{cost['responses']} costed response(s), "
            f"queue {cost['queue_us'] / 1e6:.4f}s; source {srcs}"
        )
    if "zipf" in report:
        hr = report["cache_hit_ratio"]
        print(
            f"zipf keyspace: S={report['zipf']:g} over "
            f"{report['zipf_keys']} key(s), "
            f"{report['distinct_keys_offered']} distinct offered; "
            f"cache_hit_ratio="
            f"{'n/a (no result cache)' if hr is None else format(hr, '.3f')}"
        )
    if "requested_fps" in report:
        print(
            f"frame rate: requested {report['requested_fps']:.2f} fps, "
            f"offered {report['offered_fps']:.2f} fps, "
            f"achieved {report['achieved_fps']:.2f} fps"
        )
    if "ramp" in report:
        r = report["ramp"]
        print(
            f"ramp {r['start_fps']:g}->{r['end_fps']:g} fps over "
            f"{r['seconds']:g}s ({len(r['phases'])} phase(s)):"
        )
        for pi, ph in enumerate(r["phases"]):
            print(
                f"  phase {pi}: {ph['fps']:8.2f} fps requested, "
                f"{ph['achieved_fps']:8.2f} achieved "
                f"({ph['completed']}/{ph['requests']}), "
                f"p99={ph['p99_s'] * 1e3:.2f}ms"
            )


def _log_perf(ns, report: dict, ramp, device) -> None:
    """One sentry record per loadgen run: p50 request latency. The load
    model (mode, reps, closed-loop concurrency or open-loop rate, burst,
    zipf) is folded into the metric name, a key field, so different load
    shapes never gate each other."""
    from tpu_stencil_torch.obs import sentry

    # report["mode"], not ns.mode: --rate-fps forces the open loop.
    ran_mode = report["mode"]
    if ran_mode == "closed":
        load = f"c{ns.concurrency}"
    elif ramp is not None:
        load = f"ramp{ramp[0]:g}-{ramp[1]:g}"
    elif ns.rate_fps is not None:
        load = f"fps{ns.rate_fps:g}"
    else:
        load = f"rate{ns.rate:g}"
    if ns.burst > 1:
        load += f"b{ns.burst}"
    if ns.zipf is not None:
        load += f"z{ns.zipf:g}"
    # The network tier measures HTTP and routing on top of the engine:
    # its own series.
    tier = ".net" if ns.http else ""
    metric = f"serve.p50_s.{ran_mode}.{load}.reps{ns.reps}{tier}"
    if report["p50_s"] > 0:
        rec = sentry.make_record(
            metric=metric, value=report["p50_s"],
            filter_name=ns.filter_name, shape=ns.shapes,
            backend=ns.backend,
            platform=(_platform_name(device) if device is not None
                      else "remote"),
            source="serve",
            extra={"requests": report["requests"],
                   "throughput_rps": report["throughput_rps"]},
        )
        print(f"perf history += {metric} {report['p50_s']:.6g}s -> "
              f"{sentry.append(rec, ns.perf_log)}")
    else:
        print("perf history not updated: no completed requests "
              "(p50 unavailable)")


if __name__ == "__main__":
    sys.exit(main())
