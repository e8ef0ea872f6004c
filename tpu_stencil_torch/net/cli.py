"""``python -m tpu_stencil_torch net``: run the network serving tier (the
JAX package's ``net`` command line, flag for flag).

Starts the replica fleet behind the stdlib HTTP frontend and serves until
SIGTERM/SIGINT (or ``POST /admin/drain``), then drains: ``/healthz`` flips
to draining, admission stops, every replica gets ``close(timeout=)``
within ``--drain-timeout``, the replicas that hung are reported, the
``--metrics-text`` / ``--stats-json`` artifacts are written, and the
process exits 0 when every replica drained (1 when one was abandoned).

It runs on the card (one replica per visible device, by default) unless
``--platform cpu`` asks for the CPU (offered ``--replicas`` times, at
least once). With no card and no ``--platform cpu`` it exits 2 naming
``NoDeviceError``; it never drops to the CPU on its own. Flags are
validated (:class:`~tpu_stencil_torch.config.NetConfig`) before any
device is touched.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

from tpu_stencil_torch.config import BACKENDS, NetConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_stencil_torch net",
        description="Network serving tier: an HTTP frontend over a "
                    "per-device replica fleet with admission control "
                    "and graceful drain, on the GPU unless --platform "
                    "cpu.",
    )
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1; 0.0.0.0 to "
                        "accept off-host traffic)")
    p.add_argument("--port", type=int, default=8080,
                   help="listen port; 0 binds an ephemeral port and "
                        "prints it (default 8080)")
    p.add_argument("--replicas", type=int, default=0,
                   help="serving engines in the fleet, one pinned per "
                        "local device (0 = one per device; default 0)")
    p.add_argument("--filter", dest="filter_name", default="gaussian",
                   help="default filter (per-request override via "
                        "X-Filter; default gaussian)")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS),
                   help="compute backend for every replica (default auto)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="per-replica bounded queue depth; beyond it the "
                        "router tries the next replica, and when every "
                        "queue is full the request gets 429 (default 256)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="per-replica micro-batch bound (default 8)")
    p.add_argument("--coalesce-window-us", dest="coalesce_window_us",
                   type=float, default=300.0, metavar="US",
                   help="router-level continuous batching: concurrent "
                        "requests sharing a (filter, bucket, channels, "
                        "reps) key are held up to this many microseconds "
                        "and stacked onto ONE replica submit — one "
                        "compiled batch program and one H2D instead of "
                        "N. A full group (max-batch) or a member whose "
                        "deadline falls inside the window dispatches "
                        "immediately. 0 = off (one request, one launch). "
                        "Default 300")
    p.add_argument("--no-ingest-arena", dest="ingest_arena",
                   action="store_false",
                   help="disable zero-copy ingest (on by default: "
                        "request bodies readinto reusable per-bucket "
                        "staging buffers, CRC in place, no per-request "
                        "host copies); off buffers every body through "
                        "fresh bytes objects — the A/B arm")
    p.add_argument("--result-cache-mb", dest="result_cache_mb",
                   type=float, default=0.0, metavar="MB",
                   help="content-addressed result cache: this many MB "
                        "of true result bytes keyed by (body BLAKE2b "
                        "digest, filter, reps, geometry); a hit answers "
                        "X-Cache: hit from the store without touching a "
                        "replica, concurrent identical requests "
                        "collapse onto one launch, and a witness "
                        "mismatch or quarantine drops the suspect "
                        "replica's entries. GET /admin/cache?action="
                        "clear wipes it. 0 = off, the default")
    p.add_argument("--max-inflight-mb", type=float, default=256.0,
                   help="load-shed watermark: past this many MB of "
                        "tracked in-flight request+response bytes, new "
                        "requests get 503 + Retry-After before touching "
                        "any queue (0 = off; default 256)")
    p.add_argument("--request-timeout", dest="request_timeout_s",
                   type=float, default=0.0, metavar="SECONDS",
                   help="default per-request deadline: expired requests "
                        "fail 504 (DeadlineExceeded) instead of occupying "
                        "a batch slot; X-Request-Timeout overrides per "
                        "request (0 = none)")
    p.add_argument("--drain-timeout", dest="drain_timeout_s", type=float,
                   default=30.0, metavar="SECONDS",
                   help="graceful-drain budget on SIGTERM: every replica "
                        "gets close(timeout=) within it; a replica that "
                        "does not join is reported abandoned and the "
                        "process exits 1 (default 30)")
    p.add_argument("--no-warm", dest="warm_fleet", action="store_false",
                   help="disable shared program-cache warming across "
                        "replicas (on by default: a shape built on one "
                        "replica pre-warms the others)")
    p.add_argument("--no-integrity", dest="integrity",
                   action="store_false",
                   help="disable the integrity layer (on by default: "
                        "X-Content-Crc32c request validation, "
                        "X-Result-Crc32c response stamping, witness "
                        "re-execution). Quarantine then only trips via "
                        "POST /admin/quarantine")
    p.add_argument("--witness-rate", dest="witness_rate", type=float,
                   default=1.0 / 256.0, metavar="RATE",
                   help="fraction of completed requests re-executed "
                        "through torch ops on the replica's device and "
                        "compared bit-exact per replica (seeded, "
                        "deterministic; default 1/256; 0 disables). K "
                        "mismatches in the window quarantine the "
                        "replica")
    p.add_argument("--quarantine-after", dest="quarantine_after",
                   type=int, default=3, metavar="K",
                   help="witness mismatches within the window that "
                        "quarantine a replica (default 3)")
    p.add_argument("--readmit-after", dest="readmit_after", type=int,
                   default=3, metavar="N",
                   help="consecutive clean background probes that "
                        "re-admit a quarantined replica (default 3)")
    p.add_argument("--probe-interval", dest="probe_interval_s",
                   type=float, default=1.0, metavar="SECONDS",
                   help="background re-verify probe period for "
                        "quarantined replicas (default 1.0; 0 disables "
                        "the prober)")
    p.add_argument("--flightrec-dir", dest="flightrec_dir",
                   default="flightrec", metavar="DIR",
                   help="flight-recorder spool: anomaly triggers (slow "
                        "request, deadline, witness mismatch, "
                        "quarantine) dump the trace's spans as capped "
                        "per-trace JSON files here; GET /debug/flightrec "
                        "lists/fetches them; TPU_STENCIL_TORCH_FLIGHTREC_DIR "
                        "overrides; 'none' disables the spool")
    p.add_argument("--flight-latency-threshold",
                   dest="flight_latency_threshold_s", type=float,
                   default=0.0, metavar="SECONDS",
                   help="slow-request anomaly threshold: a 200 slower "
                        "than this triggers an automatic flight-recorder "
                        "dump, so a p99 straggler leaves a black-box "
                        "record (0 = off)")
    p.add_argument("--sample-interval", dest="sample_interval_s",
                   type=float, default=1.0, metavar="SECONDS",
                   help="time-series sampler period: a daemon thread "
                        "snapshots the merged registry into a bounded "
                        "ring serving GET /debug/timeseries; the SLO "
                        "engine evaluates on its ticks (0 disables "
                        "both; default 1.0)")
    p.add_argument("--slo-error-budget", dest="slo_error_budget",
                   type=float, default=0.05, metavar="FRACTION",
                   help="SLO error budget (allowed bad fraction) for "
                        "the stock burn-rate objectives; a sustained "
                        "fast+slow window burn flips /healthz to "
                        "'degraded', emits an slo.breach event and "
                        "triggers a flight dump (0 disables the "
                        "engine; default 0.05)")
    p.add_argument("--slo-latency-p99", dest="slo_latency_p99_s",
                   type=float, default=0.0, metavar="SECONDS",
                   help="optional latency objective: requests slower "
                        "than this burn a 1%% budget (0 = off)")
    p.add_argument("--prof-dir", dest="prof_dir", default="profspool",
                   metavar="DIR",
                   help="on-demand profiler spool: POST /debug/prof"
                        "?seconds=N runs a bounded torch.profiler "
                        "capture into DIR (capped, oldest pruned); "
                        "'none' disables the endpoint")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="where the replicas run: the GPU by default "
                        "(every visible card); 'cpu' runs them on the "
                        "CPU, offered --replicas times (at least once). "
                        "Without a GPU and without 'cpu' the command "
                        "fails (NoDeviceError)")
    p.add_argument("--register", default=None, metavar="FED_URL",
                   help="announce this host to a federation front "
                        "router at FED_URL on "
                        "startup: POSTs the advertised URL to "
                        "FED_URL/admin/register with backoff retries "
                        "(best-effort — the fed may start later and "
                        "seed-list this host instead)")
    p.add_argument("--advertise", default=None, metavar="URL",
                   help="the URL to register (default "
                        "http://<host>:<bound port>; set it when this "
                        "host binds 0.0.0.0 or sits behind NAT)")
    p.add_argument("--warm-from", dest="warm_from", default=None,
                   metavar="URL",
                   help="warm-start: GET URL/admin/warmstate (a fed "
                        "front or a warm member) and, BEFORE the HTTP "
                        "listener starts, rebuild every program-cache "
                        "key it names from this checkout's kernel "
                        "sources and run it once on each replica's "
                        "device; an unusable entry degrades to a cold "
                        "start, typed and counted "
                        "(ctrl_warmstart_fallbacks_total), never fatal")
    p.add_argument("--metrics-text", default=None, metavar="PATH",
                   help="after the drain, write the fleet-wide metrics "
                        "(the /metrics exposition) to PATH ('-' = stdout)")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="after the drain, dump the /statusz payload as "
                        "JSON to PATH ('-' = stdout); versioned schema")
    return p


def _register_with_fed(fed_url: str, advertise: str) -> None:
    """Announce this host to a federation front router in the background:
    POST the advertised URL to ``<fed_url>/admin/register`` under the
    shared retry policy (the router may still be starting). Best-effort:
    a router that never answers is logged, not fatal."""
    import urllib.parse
    import urllib.request

    from tpu_stencil_torch.resilience import retry as _retry

    target = (fed_url.rstrip("/") + "/admin/register?url="
              + urllib.parse.quote(advertise, safe=""))

    def announce() -> None:
        req = urllib.request.Request(target, data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=10.0):
            pass

    def run() -> None:
        try:
            _retry.retry_call(
                announce,
                policy=_retry.RetryPolicy(attempts=8, base_delay=0.25,
                                          multiplier=2.0, max_delay=5.0),
                label="net.register",
            )
            print(f"net: registered {advertise} with federation "
                  f"{fed_url}", flush=True)
        except Exception as e:
            print(f"net: federation registration with {fed_url} "
                  f"failed ({type(e).__name__}: {e}); serving "
                  f"unfederated", flush=True)

    threading.Thread(target=run, name="tpu-stencil-torch-net-register",
                     daemon=True).start()


def _load_envelope(data: bytes):
    """A warm-state envelope parsed from the wire; None (the importer's
    ``payload_unavailable``) for anything but a JSON object."""
    try:
        doc = json.loads(data)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def _pull_warm_state(fe, url: str) -> None:
    """Warm-start pull: fetch the envelope from ``url`` and import it into
    every replica before the HTTP listener exists. Every failure (the
    pull, or any entry in it) degrades to a cold start, typed and
    counted in ``ctrl_warmstart_fallbacks_total``, never fatal."""
    import urllib.request

    payload = None
    try:
        with urllib.request.urlopen(
                url.rstrip("/") + "/admin/warmstate", timeout=30.0) as r:
            payload = _load_envelope(r.read())
    except Exception as e:  # a cold start, not a failure
        print(f"net: warm-state pull from {url} failed "
              f"({type(e).__name__}: {e}); starting cold", flush=True)
    # Build the fleet now (NetFrontend.start() finds it built) and seed.
    fe.fleet.start()
    summary = fe.fleet.warmstate_import(payload)
    print(f"net: warm-start imported {summary['imported']} "
          f"artifact(s), {summary['fallbacks']} fallback(s) "
          f"from {url}", flush=True)


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    try:
        cfg = NetConfig(
            host=ns.host, port=ns.port, replicas=ns.replicas,
            filter_name=ns.filter_name, backend=ns.backend,
            max_queue=ns.max_queue, max_batch=ns.max_batch,
            coalesce_window_us=ns.coalesce_window_us,
            ingest_arena=ns.ingest_arena,
            result_cache_mb=ns.result_cache_mb,
            max_inflight_mb=ns.max_inflight_mb,
            request_timeout_s=ns.request_timeout_s,
            drain_timeout_s=ns.drain_timeout_s,
            warm_fleet=ns.warm_fleet,
            integrity=ns.integrity,
            witness_rate=ns.witness_rate,
            quarantine_after=ns.quarantine_after,
            readmit_after=ns.readmit_after,
            probe_interval_s=ns.probe_interval_s,
            flightrec_dir=(None if ns.flightrec_dir == "none"
                           else ns.flightrec_dir),
            flight_latency_threshold_s=ns.flight_latency_threshold_s,
            sample_interval_s=ns.sample_interval_s,
            slo_error_budget=ns.slo_error_budget,
            slo_latency_p99_s=ns.slo_latency_p99_s,
            prof_dir=(None if ns.prof_dir == "none" else ns.prof_dir),
        )
    except ValueError as e:
        parser.error(str(e))

    from tpu_stencil_torch.devices import NoDeviceError, resolve_devices

    try:
        devices = resolve_devices(ns.platform)
    except NoDeviceError as e:
        print(f"tpu_stencil_torch net: error: NoDeviceError: {e}",
              file=sys.stderr)
        return 2
    if devices[0].type == "cpu":
        # The CPU as N devices, as the JAX package's forced host device
        # count gives a CPU fleet its devices.
        devices = devices * max(1, cfg.replicas)

    from tpu_stencil_torch.net.http import NetFrontend

    fe = NetFrontend(cfg, devices=devices)
    try:
        if ns.warm_from:
            # Import before start(): the listener (and with it /healthz
            # ready) exists only once the envelope was imported.
            _pull_warm_state(fe, ns.warm_from)
        fe.start()
    except ValueError as e:  # --replicas above the device count
        print(f"tpu_stencil_torch net: error: {e}", file=sys.stderr)
        fe.close()
        return 1
    stop = threading.Event()

    def _on_signal(signum, _frame) -> None:
        print(f"net: received {signal.Signals(signum).name}, draining",
              flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(
        f"net: serving on {fe.url} with {len(fe.fleet)} replica(s) "
        f"(max_queue={cfg.max_queue}/replica, "
        f"shed>{cfg.max_inflight_mb:g}MB inflight, "
        f"coalesce={cfg.coalesce_window_us:g}us, "
        f"arena={'on' if cfg.ingest_arena else 'off'}, "
        f"cache={cfg.result_cache_mb:g}MB, "
        f"warm={'on' if cfg.warm_fleet else 'off'}, "
        f"devices={','.join(str(d) for d in fe.fleet.devices)}); "
        f"POST /v1/blur /debug/prof, GET /healthz /metrics /statusz "
        f"/debug/trace/<id> /debug/flightrec /debug/timeseries "
        f"/debug/capacity /debug/tenants; SIGTERM drains",
        flush=True,
    )
    if ns.register:
        _register_with_fed(ns.register, ns.advertise or fe.url)
    # Timed waits, not a bare stop.wait(): an untimed Event.wait parks the
    # main thread where a Python signal handler that only sets the event
    # would never run.
    while not stop.wait(0.5):
        if fe.admin_drain_requested.is_set():
            # POST /admin/drain: the same drain and rc as SIGTERM.
            print("net: admin drain requested, draining", flush=True)
            break
    t0 = time.perf_counter()
    report = fe.drain(cfg.drain_timeout_s)
    hung = sorted(i for i, ok in report.items() if not ok)
    if hung:
        print(f"net: drain ABANDONED replica(s) {hung} after "
              f"{cfg.drain_timeout_s:g}s "
              f"({time.perf_counter() - t0:.2f}s elapsed)", flush=True)
    else:
        print(f"net: drained {len(report)} replica(s) cleanly in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    if ns.metrics_text:
        from tpu_stencil_torch.obs import exposition

        exposition.write_text(ns.metrics_text, fe.metrics_snapshot(),
                              prefix="tpu_stencil_net")
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
