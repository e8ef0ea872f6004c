"""``python -m tpu_stencil_torch fed`` — run the federation front router
(the JAX package's ``fed`` command line, flag for flag).

Starts the membership/breaker/router stack behind the stdlib HTTP
frontend and serves until SIGTERM/SIGINT (or ``POST /admin/drain``
with no host), then runs the graceful-drain sequence mirroring the net
CLI's discipline: flip ``/healthz`` to draining, stop admission, bleed
every member's outstanding forwarded requests under
``--drain-timeout``, report per host clean-vs-abandoned, write
``--metrics-text`` / ``--stats-json`` artifacts, exit 0 when every
host bled clean (1 when one was abandoned).

The federation process never creates a CUDA context and takes no
``--platform``: it needs no card. Its members (``python -m
tpu_stencil_torch net --register URL``) run K1 on the card.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

from tpu_stencil_torch.config import FedConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch fed",
        description="Federation front router: health-checked "
                    "membership, per-host circuit breakers, hedged "
                    "requests, per-tenant quotas over many "
                    "`tpu_stencil_torch net` hosts; holds no "
                    "device.",
    )
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=8090,
                   help="listen port; 0 binds an ephemeral port and "
                        "prints it (default 8090)")
    p.add_argument("--member", dest="members", action="append",
                   default=[], metavar="URL",
                   help="seed member host URL (repeatable); hosts can "
                        "also register live via POST /admin/register "
                        "(`tpu_stencil_torch net --register`)")
    p.add_argument("--heartbeat-interval", dest="heartbeat_interval_s",
                   type=float, default=1.0, metavar="SECONDS",
                   help="membership /healthz probe period (default 1)")
    p.add_argument("--suspect-after", type=int, default=2,
                   metavar="N",
                   help="consecutive missed heartbeats before a member "
                        "is suspect — routed only after every healthy "
                        "host (default 2)")
    p.add_argument("--evict-after", type=int, default=5, metavar="N",
                   help="consecutive missed heartbeats before a member "
                        "is evicted; re-registration readmits it "
                        "(default 5)")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   metavar="N",
                   help="consecutive transport-level forward failures "
                        "that open a member's circuit breaker "
                        "(default 3)")
    p.add_argument("--breaker-cooldown", dest="breaker_cooldown_s",
                   type=float, default=2.0, metavar="SECONDS",
                   help="open-breaker cooldown before one half-open "
                        "probe request is let through (default 2)")
    p.add_argument("--no-hedge", dest="hedge", action="store_false",
                   help="disable hedged requests (on by default: a "
                        "forward pending past the observed p99 fires "
                        "one hedge at the next member, first response "
                        "wins)")
    p.add_argument("--hedge-min", dest="hedge_min_s", type=float,
                   default=0.05, metavar="SECONDS",
                   help="hedge-trigger floor under the observed p99 "
                        "(default 0.05)")
    p.add_argument("--no-digest-affinity", dest="digest_affinity",
                   action="store_false",
                   help="disable content-digest rendezvous placement "
                        "(on by default: identical frames land on the "
                        "same healthy member so its result cache sees "
                        "the whole repeat stream; off = pure "
                        "least-outstanding)")
    p.add_argument("--forward-timeout", dest="forward_timeout_s",
                   type=float, default=120.0, metavar="SECONDS",
                   help="per-attempt member socket timeout (default "
                        "120, matching the net handler's read guard)")
    p.add_argument("--reoffer", dest="reoffer_s", type=float,
                   default=0.5, metavar="SECONDS",
                   help="re-offer window when every member answers "
                        "backpressure, before the typed 429/503 "
                        "surfaces (0 = off; default 0.5)")
    p.add_argument("--max-inflight-mb", type=float, default=512.0,
                   help="federation-scope shed watermark (503 + "
                        "Retry-After past it; premium tenants get 25%% "
                        "headroom; 0 = off; default 512)")
    p.add_argument("--tenant-quota", type=int, default=32, metavar="N",
                   help="max outstanding requests per standard tenant "
                        "(X-Tenant header; 429 + Retry-After past it; "
                        "default 32)")
    p.add_argument("--premium-tenant", dest="premium_tenants",
                   action="append", default=[], metavar="NAME",
                   help="tenant in the premium priority class "
                        "(repeatable): quota x --premium-factor, 25%% "
                        "shed headroom")
    p.add_argument("--premium-factor", dest="premium_quota_factor",
                   type=int, default=4, metavar="K",
                   help="premium tenants' quota multiplier (default 4)")
    p.add_argument("--drain-timeout", dest="drain_timeout_s",
                   type=float, default=30.0, metavar="SECONDS",
                   help="graceful-drain budget on SIGTERM: every "
                        "member's outstanding forwarded requests must "
                        "bleed to zero within it, else that host is "
                        "reported abandoned and the process exits 1 "
                        "(default 30)")
    p.add_argument("--flightrec-dir", dest="flightrec_dir",
                   default="flightrec", metavar="DIR",
                   help="flight-recorder spool: anomaly triggers (slow "
                        "request, deadline, breaker open) dump the "
                        "trace's spans as capped per-trace JSON files "
                        "here; GET /debug/flightrec lists/fetches them; "
                        "TPU_STENCIL_TORCH_FLIGHTREC_DIR overrides; "
                        "'none' disables the spool")
    p.add_argument("--flight-latency-threshold",
                   dest="flight_latency_threshold_s", type=float,
                   default=0.0, metavar="SECONDS",
                   help="slow-request anomaly threshold: a 200 slower "
                        "than this triggers an automatic flight-"
                        "recorder dump (0 = off)")
    p.add_argument("--sample-interval", dest="sample_interval_s",
                   type=float, default=1.0, metavar="SECONDS",
                   help="time-series sampler period over the LOCAL fed "
                        "registry (GET /debug/timeseries fans the "
                        "member query on demand); the SLO engine "
                        "evaluates on its ticks (0 disables both; "
                        "default 1.0)")
    p.add_argument("--slo-error-budget", dest="slo_error_budget",
                   type=float, default=0.05, metavar="FRACTION",
                   help="SLO error budget for the fed tier's own "
                        "response mix; a sustained burn flips /healthz "
                        "to 'degraded' (0 disables; default 0.05)")
    p.add_argument("--metrics-text", default=None, metavar="PATH",
                   help="after the drain, write the federation-wide "
                        "metrics (the /metrics exposition, member "
                        "scrapes folded in) to PATH ('-' = stdout)")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="after the drain, dump the /statusz payload as "
                        "JSON to PATH ('-' = stdout); versioned schema")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    try:
        cfg = FedConfig(
            host=ns.host, port=ns.port, members=tuple(ns.members),
            heartbeat_interval_s=ns.heartbeat_interval_s,
            suspect_after=ns.suspect_after,
            evict_after=ns.evict_after,
            breaker_threshold=ns.breaker_threshold,
            breaker_cooldown_s=ns.breaker_cooldown_s,
            hedge=ns.hedge, hedge_min_s=ns.hedge_min_s,
            digest_affinity=ns.digest_affinity,
            forward_timeout_s=ns.forward_timeout_s,
            reoffer_s=ns.reoffer_s,
            max_inflight_mb=ns.max_inflight_mb,
            tenant_quota=ns.tenant_quota,
            premium_tenants=tuple(ns.premium_tenants),
            premium_quota_factor=ns.premium_quota_factor,
            drain_timeout_s=ns.drain_timeout_s,
            flightrec_dir=(None if ns.flightrec_dir == "none"
                           else ns.flightrec_dir),
            flight_latency_threshold_s=ns.flight_latency_threshold_s,
            sample_interval_s=ns.sample_interval_s,
            slo_error_budget=ns.slo_error_budget,
        )
    except ValueError as e:
        parser.error(str(e))

    from tpu_stencil_torch.fed.http import FedFrontend

    fe = FedFrontend(cfg).start()
    stop = threading.Event()

    def _on_signal(signum, _frame) -> None:
        print(f"fed: received {signal.Signals(signum).name}, draining",
              flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(
        f"fed: serving on {fe.url} with "
        f"{len(fe.membership.members())} seed member(s) "
        f"(heartbeat={cfg.heartbeat_interval_s:g}s, "
        f"suspect/evict after {cfg.suspect_after}/{cfg.evict_after} "
        f"misses, breaker opens at {cfg.breaker_threshold}, "
        f"hedge={'on' if cfg.hedge else 'off'}, "
        f"affinity={'on' if cfg.digest_affinity else 'off'}, "
        f"tenant quota {cfg.tenant_quota}); "
        f"POST /v1/blur /admin/register /admin/drain, "
        f"GET /healthz /metrics /statusz /debug/trace/<id> "
        f"/debug/flightrec /debug/timeseries /debug/capacity "
        f"/debug/tenants; SIGTERM drains",
        flush=True,
    )
    # Timed waits (the net CLI's signal-liveness discipline).
    while not stop.wait(0.5):
        if fe.admin_drain_requested.is_set():
            print("fed: admin drain requested, draining", flush=True)
            break
    t0 = time.perf_counter()
    report = fe.drain(cfg.drain_timeout_s)
    hung = sorted(h for h, ok in report.items() if not ok)
    if hung:
        print(f"fed: drain ABANDONED host(s) {hung} after "
              f"{cfg.drain_timeout_s:g}s "
              f"({time.perf_counter() - t0:.2f}s elapsed)", flush=True)
    else:
        print(f"fed: drained {len(report)} host(s) cleanly in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    if ns.metrics_text:
        from tpu_stencil_torch.obs import exposition

        exposition.write_text(ns.metrics_text, fe.metrics_snapshot(),
                              prefix="tpu_stencil_fed")
    if ns.stats_json:
        payload = json.dumps(fe.statusz(), indent=2, sort_keys=True)
        if ns.stats_json == "-":
            print(payload)
        else:
            with open(ns.stats_json, "w") as fh:
                fh.write(payload + "\n")
            print(f"wrote {ns.stats_json}")
    fe.close()
    return 1 if hung else 0


if __name__ == "__main__":
    sys.exit(main())
