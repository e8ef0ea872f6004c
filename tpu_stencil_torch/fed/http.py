"""The federation front router's HTTP edge: one endpoint over N hosts (the
port's copy of the JAX package's ``fed/http.py``).

Endpoints:

* ``POST /v1/blur`` — the same wire contract as the net tier (geometry
  via ``X-*`` headers or query params, raw frame body, chunked uploads
  legal); the frontend admits (drain gate 503 / federation byte-shed
  503 + Retry-After / per-tenant quota 429 + Retry-After, classes keyed
  on ``X-Tenant``), then the router forwards to a member host with
  hedging and typed rerouting — placed by content-digest rendezvous
  affinity when ``digest_affinity`` is on, so identical frames revisit
  the same member's result cache. Success responses carry
  ``X-Fed-Member`` (which host computed), ``X-Fed-Hedged``, and the
  member's ``X-Cache`` verdict (hit/miss/collapsed) when its result
  cache is enabled.
* ``GET /healthz`` — 200 serving (``degraded`` body when the SLO
  burn-rate engine holds a breach) / 503 draining, same readiness
  contract as the net tier, one hop up.
* ``GET /debug/timeseries[?window=s]`` — the local sampler's windowed
  deltas/rates plus every live member's ``/debug/timeseries`` answer,
  fanned concurrently and merged (a failed member surfaces as an
  explicit ``stale`` entry with its scrape age).
* ``GET /metrics`` — the fed registry rendered under
  ``tpu_stencil_fed``, with every live member's ``/metrics`` scrape
  folded in as ``fleet_<host>_<name>`` (counters) — one scrape walks
  the whole federation, the way the net tier folds its replicas.
* ``GET /statusz`` — members (state/misses/breaker), tenants,
  outstanding per host, drain state; the ``net`` key carries the same
  merged snapshot ``/metrics`` renders, so ``loadgen.HttpTarget``
  pointed at a federation works unchanged.
* ``POST /admin/register?url=U`` — backend host registration
  (health-checked; ``tpu_stencil_torch net --register`` drives it).
* ``POST /admin/drain?host=ID`` — rolling whole-host drain: the router
  bleeds traffic off the member (state → draining) and then drives the
  member's own ``/admin/drain`` SIGTERM-equivalent path. Without
  ``host``, drains the federation itself (the fed's own
  SIGTERM-equivalent, mirroring the net tier's).

:class:`FedFrontend` owns the tier lifecycle: membership (+ heartbeat
thread) → breakers → router → threaded HTTP server, then
``begin_drain`` → ``drain`` (bleed members, report clean-vs-abandoned
per host) → ``close``.

The federation never touches a device: ``/debug/prof`` answers 404 and
names the members' endpoint. ``/metrics`` keeps the JAX package's
``tpu_stencil_fed`` prefix and folds the members' ``tpu_stencil_net``
scrapes, so one dashboard reads the federations of both packages.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from tpu_stencil_torch.cache import digest as _cache_digest
from tpu_stencil_torch.config import FedConfig
from tpu_stencil_torch.fed.breaker import BreakerBoard
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.fed.membership import Membership
from tpu_stencil_torch.fed.router import (
    DEFAULT_TENANT,
    FedRouter,
    TenantQuotaExceeded,
)
from tpu_stencil_torch.net.http import (
    _Oversized,
    _parse_window,
    read_request_body,
    send_trace_pair,
    traced_error_body,
)
from tpu_stencil_torch.net.router import Draining, Overloaded
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.obs import flight as _obs_flight
from tpu_stencil_torch.obs import slo as _obs_slo
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.obs import timeseries as _obs_ts
from tpu_stencil_torch.resilience.errors import (
    DeadlineExceeded,
    HostUnavailable,
)
from tpu_stencil_torch.serve.engine import QueueFull
from tpu_stencil_torch.serve.metrics import Registry

FED_STATUS_SCHEMA_VERSION = 1

# Retry-After hints (seconds) when no member supplied one: breaker
# cooldowns and shed backlogs clear in seconds, tenant quotas as soon
# as the tenant's own requests complete.
RETRY_AFTER_SHED = 2
RETRY_AFTER_QUOTA = 1

#: Optional request headers forwarded to the member verbatim (header
#: name, query-param spelling — the net tier's vocabulary). The hop
#: carries routing metadata + the one body, nothing else.
_FORWARD_HEADERS = (
    ("X-Filter", "filter"),
    ("X-Boundary", "boundary"),
    ("X-Request-Timeout", "timeout"),
    # Checksums on every hop: the client's body CRC rides to the member,
    # which re-validates it — the fed edge's own validation (below) does
    # not spend the member's trust.
    ("X-Content-Crc32c", "crc32c"),
    # The tenant rides to the member so its cost ledger meters the SAME
    # identity the fed quota machinery admitted — /debug/tenants at
    # both tiers agrees on who spent what.
    ("X-Tenant", "tenant"),
)


class _FedHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, frontend: "FedFrontend") -> None:
        self.frontend = frontend
        super().__init__(addr, _FedHandler)


class _FedHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tpu-stencil-torch-fed/1"
    timeout = 120.0  # read-side guard, same as the net handler

    # Request-scoped trace context, same discipline as the net handler
    # (set by _blur, cleared at every do_* against keep-alive reuse).
    _trace: Optional[_obs_ctx.TraceContext] = None

    def log_message(self, *args) -> None:
        pass

    @property
    def fe(self) -> "FedFrontend":
        return self.server.frontend

    def _respond(self, code: int, body: bytes,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.fe.registry.counter(f"responses_{code // 100}xx_total").inc()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        headers = headers or {}
        if self._trace is not None:
            send_trace_pair(self, self._trace, headers)
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str,
               headers: Optional[Dict[str, str]] = None) -> None:
        # Close after errors answered before the body was consumed —
        # the same keep-alive-coherence rule as the net handler.
        self.close_connection = True
        if self._trace is not None:
            # The net tier's typed JSON error body, one hop up — every
            # federation rejection class (shed 503, quota 429,
            # validation 400, deadline 504) greps to its trace from
            # the body alone.
            self._respond(
                code,
                traced_error_body(code, msg, self._trace.trace_id),
                content_type="application/json",
                headers={**(headers or {}), "Connection": "close"},
            )
            return
        self._respond(code, (msg.rstrip("\n") + "\n").encode(),
                      headers={**(headers or {}), "Connection": "close"})

    def _param(self, query: dict, header: str, qname: str,
               default: Optional[str] = None) -> Optional[str]:
        v = self.headers.get(header)
        if v is not None:
            return v
        if qname in query:
            return query[qname][0]
        return default

    # -- GET -----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        self._trace = None
        path = urlsplit(self.path).path
        if path == "/healthz":
            if self.fe.router.draining:
                self._error(503, "draining")
            elif self.fe.slo is not None and self.fe.slo.degraded():
                # Same contract as the net tier: degraded is 200
                # (routable) but visibly unhealthy.
                self._respond(200, b"degraded\n")
            else:
                self._respond(200, b"ok\n")
        elif path == "/metrics":
            self._respond(200, self.fe.render_metrics().encode(),
                          content_type="text/plain; version=0.0.4")
        elif path == "/statusz":
            self._respond(
                200,
                json.dumps(self.fe.statusz(), indent=2,
                           sort_keys=True).encode(),
                content_type="application/json",
            )
        elif path == "/admin/warmstate":
            self._admin_warmstate()
        elif path == "/debug/timeseries":
            self._debug_timeseries(parse_qs(urlsplit(self.path).query))
        elif path == "/debug/capacity":
            self._debug_capacity(parse_qs(urlsplit(self.path).query))
        elif path == "/debug/tenants":
            self._respond(
                200,
                json.dumps(self.fe.debug_tenants(), indent=2,
                           sort_keys=True).encode(),
                content_type="application/json",
            )
        elif path == "/debug/prof" or path.startswith("/debug/prof/"):
            # The federation tier holds no device: the profiler
            # endpoint exists but is 404-clean, pointing the operator at
            # the member endpoints.
            self._error(404, "no device profiler on the federation "
                             "tier; POST /debug/prof on a "
                             "member")
        elif path.startswith("/debug/trace/"):
            self._debug_trace(path[len("/debug/trace/"):])
        elif path == "/debug/flightrec" or path.startswith(
                "/debug/flightrec/"):
            name = (path[len("/debug/flightrec/"):]
                    if path != "/debug/flightrec" else None)
            data = _obs_flight.spool_http_payload(
                _obs_flight.effective_spool(self.fe.cfg.flightrec_dir),
                name,
            )
            if data is None:
                self._error(404, "no such flight-recorder dump")
            else:
                self._respond(200, data,
                              content_type="application/json")
        else:
            self._error(404, f"no such endpoint: {path}")

    def _debug_timeseries(self, query: dict) -> None:
        if self.fe.sampler is None:
            self._error(404, "time-series sampler is off "
                             "(--sample-interval 0)")
            return
        window_s = _parse_window(query)
        if window_s is None:
            self._error(400, "window must be a positive number of "
                             "seconds")
            return
        payload = self.fe.debug_timeseries(window_s)
        self._respond(200, json.dumps(payload, indent=2,
                                      sort_keys=True).encode(),
                      content_type="application/json")

    def _debug_capacity(self, query: dict) -> None:
        window_s = _parse_window(query)
        if window_s is None:
            self._error(400, "window must be a positive number of "
                             "seconds")
            return
        payload = self.fe.debug_capacity(window_s)
        self._respond(200, json.dumps(payload, indent=2,
                                      sort_keys=True).encode(),
                      content_type="application/json")

    def _debug_trace(self, trace_id: str) -> None:
        if not _obs_ctx.valid_id(trace_id):
            self._error(400, f"malformed trace id {trace_id!r}")
            return
        payload = self.fe.debug_trace(trace_id)
        if payload["span_count"] == 0:
            self._error(404, f"no spans recorded for trace {trace_id} "
                             "on this federation or its members")
            return
        self._respond(200, json.dumps(payload, indent=2).encode(),
                      content_type="application/json")

    # -- POST ----------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        self._trace = None
        split = urlsplit(self.path)
        if split.path == "/v1/blur":
            self._blur(parse_qs(split.query))
        elif split.path == "/admin/register":
            self._register(parse_qs(split.query))
        elif split.path == "/admin/drain":
            self._drain(parse_qs(split.query))
        elif split.path == "/admin/preempt":
            self._preempt(parse_qs(split.query))
        elif split.path == "/debug/prof":
            self._consume_body()
            self._error(404, "no device profiler on the federation "
                             "tier; POST /debug/prof on a "
                             "member")
        else:
            self._error(404, f"no such endpoint: {split.path}")

    def _consume_body(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(min(n, 1 << 20))

    def _register(self, query: dict) -> None:
        self._consume_body()
        url = (query.get("url") or [None])[0]
        if not url:
            self._error(400, "missing url=<member base URL>")
            return
        try:
            member = self.fe.membership.register(url)
        except ValueError as e:
            self._error(400, str(e))
            return
        self._respond(200, json.dumps({
            "host_id": member.host_id, "url": member.url,
            "state": member.state,
        }).encode(), content_type="application/json")

    def _drain(self, query: dict) -> None:
        self._consume_body()
        host = (query.get("host") or [None])[0]
        if host is None:
            # The federation's own SIGTERM-equivalent.
            self.fe.request_admin_drain()
            self._respond(200, json.dumps(
                {"draining": True, "scope": "federation"}
            ).encode(), content_type="application/json")
            return
        result = self.fe.drain_member(host)
        if result is None:
            self._error(404, f"no such member host: {host}")
            return
        self._respond(200, json.dumps(result).encode(),
                      content_type="application/json")

    def _preempt(self, query: dict) -> None:
        """``POST /admin/preempt?host=ID`` — a host preemption notice
        for one member: a *planned* drain (``Member.pinned_draining``,
        never the eviction path).  The member leaves routing
        immediately but keeps its in-flight work; the control plane
        sees the pinned drain in ``/statusz`` and starts the
        replacement BEFORE the victim exits."""
        self._consume_body()
        host = (query.get("host") or [None])[0]
        if not host:
            self._error(400, "missing host=<member host id>")
            return
        result = self.fe.preempt_member(host)
        if result is None:
            self._error(404, f"no such member host: {host}")
            return
        self._respond(200, json.dumps(result).encode(),
                      content_type="application/json")

    def _admin_warmstate(self) -> None:
        """``GET /admin/warmstate`` — proxy the warm-state envelope
        from a warm member, so a joiner needs only the fed URL.  503
        typed when no member can answer (the joiner starts cold)."""
        payload = self.fe.warmstate()
        if payload is None:
            self._error(503, "no routable member answered "
                             "/admin/warmstate; start cold")
            return
        self._respond(200, json.dumps(payload).encode(),
                      content_type="application/json")

    def _blur(self, query: dict) -> None:
        fe = self.fe
        # The OUTERMOST edge of the federation: adopt a tracing
        # client's valid X-Trace-Id, mint otherwise. Bound for the
        # handler's duration — the router reads it to stamp every
        # forward attempt (each hedge leg gets its own span id under
        # this one trace id).
        ctx = self._trace = _obs_ctx.from_headers(self.headers)
        t0 = time.perf_counter()
        with _obs_ctx.bind(ctx), _obs_span("fed.request", "fed"):
            try:
                w = int(self._param(query, "X-Width", "w"))
                h = int(self._param(query, "X-Height", "h"))
                reps = int(self._param(query, "X-Reps", "reps"))
                channels = int(
                    self._param(query, "X-Channels", "channels", "1")
                )
                if w < 1 or h < 1:
                    raise ValueError(f"bad frame geometry {w}x{h}")
                if reps < 0:
                    raise ValueError(f"reps must be >= 0, got {reps}")
                if channels not in (1, 3):
                    raise ValueError(
                        f"channels must be 1 (grey) or 3 (rgb), got "
                        f"{channels}"
                    )
            except (TypeError, ValueError) as e:
                self._error(400, f"bad request parameters: {e}")
                return
            tenant = self._param(query, "X-Tenant", "tenant",
                                 DEFAULT_TENANT)
            expected = w * h * channels
            try:
                body = read_request_body(self.rfile, self.headers,
                                         expected)
            except _Oversized as e:
                self._error(413, str(e))
                return
            except ValueError as e:
                self._error(400, str(e))
                return
            if len(body) != expected:
                self._error(
                    400,
                    f"body is {len(body)} bytes; {w}x{h}x{channels} "
                    f"needs exactly {expected}",
                )
                return
            # Checksum hop #1: a client-declared body CRC is validated
            # HERE, before any forward — a body damaged on the client→
            # fed leg dies typed at the front, never burning a member
            # round-trip (the member re-validates the forwarded header
            # for the fed→member leg).
            claim = self._param(query, _checksum.CRC_HEADER, "crc32c")
            if claim is not None:
                err = _checksum.claim_error(claim, body)
                if err is not None:
                    msg, mismatch = err
                    if mismatch:
                        fe.registry.counter(
                            "integrity_checksum_failures_total"
                        ).inc()
                    self._error(400, msg)
                    return
            # Forward geometry as headers (canonical form regardless
            # of how the client sent it) + the passthrough set.
            fwd = {
                "X-Width": str(w), "X-Height": str(h),
                "X-Reps": str(reps), "X-Channels": str(channels),
                "Content-Type": "application/octet-stream",
            }
            for name, qname in _FORWARD_HEADERS:
                v = self._param(query, name, qname)
                if v is not None:
                    fwd[name] = v
            # Digest-affinity placement: the fed computes the same
            # BLAKE2b-160 content digest the member's result cache
            # keys on, so the router can land identical frames on the
            # SAME member — N member caches hold N keyspaces, not N
            # copies of the hot set.
            digest = (_cache_digest.content_digest(body)
                      if fe.cfg.digest_affinity else None)
            # Request + response buffers both live for the hop's
            # lifetime: the honest in-flight footprint is 2x the frame.
            nbytes = 2 * expected
            try:
                status, rh, data, host_id, hedged = fe.router.submit(
                    body, fwd, nbytes, tenant=tenant, digest=digest
                )
            except Draining as e:
                self._error(503, str(e),
                            {"Retry-After": str(RETRY_AFTER_SHED)})
                return
            except Overloaded as e:
                # A member-supplied Retry-After (all-members-shedding)
                # beats the static hint — the members know their
                # backlog.
                self._error(503, str(e), {"Retry-After": str(
                    getattr(e, "retry_after_s", None)
                    or RETRY_AFTER_SHED
                )})
                return
            except TenantQuotaExceeded as e:
                self._error(429, str(e),
                            {"Retry-After": str(RETRY_AFTER_QUOTA)})
                return
            except QueueFull as e:
                self._error(429, str(e), {"Retry-After": str(
                    getattr(e, "retry_after_s", None)
                    or RETRY_AFTER_QUOTA
                )})
                return
            except HostUnavailable as e:
                self._error(503, f"HostUnavailable: {e}",
                            {"Retry-After": str(RETRY_AFTER_SHED)})
                return
            except DeadlineExceeded as e:
                # The member burned the deadline one hop down: this
                # process's black box is the record of the whole hop
                # (the member's own dump covers its half).
                _obs_flight.trigger(
                    "deadline_exceeded", trace_id=ctx.trace_id,
                    tier="fed", duration_s=time.perf_counter() - t0,
                    detail=str(e),
                )
                self._error(504, str(e))
                return
            except Exception as e:
                self._error(500, f"{type(e).__name__}: {e}")
                return
            elapsed = time.perf_counter() - t0
            if status == 200:
                fe.registry.histogram(
                    "request_latency_seconds"
                ).observe(elapsed)
                # The member's X-Cache verdict, observed at THIS tier:
                # member_cache_hit_total / requests answered from a
                # member's result cache is the federation's hit ratio
                # — the number digest-affinity placement exists to
                # move. (The header also passes through to the client
                # via the x-* copy below.)
                xc = rh.get("x-cache")
                if xc in ("hit", "miss", "collapsed"):
                    fe.registry.counter(
                        f"member_cache_{xc}_total"
                    ).inc()
                thr = fe.cfg.flight_latency_threshold_s
                if thr and elapsed > thr:
                    _obs_flight.trigger(
                        "slow_request", trace_id=ctx.trace_id,
                        tier="fed", duration_s=elapsed,
                        threshold_s=thr, member=host_id,
                    )
            out_headers = {
                k.title(): v for k, v in rh.items()
                if k.startswith("x-")
            }
            # The member echoed the trace id with ITS span id; this
            # edge answers with its own (the member hop stays visible
            # in /debug/trace, not in the response headers).
            out_headers[_obs_ctx.TRACE_HEADER] = ctx.trace_id
            out_headers[_obs_ctx.SPAN_HEADER] = ctx.span_id
            out_headers["X-Fed-Member"] = host_id
            out_headers["X-Fed-Hedged"] = "1" if hedged else "0"
            if status != 200:
                # Pass a member's 4xx through verbatim, connection
                # closed (the body was consumed here, but the verdict
                # is deterministic — keep the client's view simple).
                self.close_connection = True
                out_headers["Connection"] = "close"
            self._respond(
                status, data,
                content_type=rh.get("content-type",
                                    "application/octet-stream"),
                headers=out_headers,
            )


class FedFrontend:
    """The whole federation tier: membership + breakers + router +
    threaded HTTP server.

    >>> fe = FedFrontend(FedConfig(port=0, members=(m1.url, m2.url)))
    >>> fe.start()
    >>> ...  # POST frames at fe.url; members register/evict live
    >>> fe.drain(); fe.close()
    """

    def __init__(self, cfg: FedConfig) -> None:
        self.cfg = cfg
        self.registry = Registry()
        # Pre-create the keys loadgen's report reads, so a federation
        # that has served only errors still scrapes them.
        self.registry.histogram("request_latency_seconds")
        self.registry.counter("rejected_total")
        self.registry.counter("member_scrape_failures_total")
        self.registry.counter("fold_collisions_total")
        # The federation's view of member result caches (X-Cache on
        # member 200s) — pre-created so a cold federation scrapes them
        # at zero and dashboards can rate() from the start.
        for xc in ("hit", "miss", "collapsed"):
            self.registry.counter(f"member_cache_{xc}_total")
        self.membership = Membership(cfg, self.registry)
        self.breakers = BreakerBoard(
            cfg.breaker_threshold, cfg.breaker_cooldown_s, self.registry
        )
        self.router = FedRouter(cfg, self.membership, self.breakers,
                                self.registry)
        # The re-registration reset (the reused-netloc bugfix): a host
        # announcing back after an eviction or drain is a NEW process —
        # drop the dead one's open breaker and hedge-p99 reservoir, or
        # the fresh host starts life unroutable behind stale state.
        self.registry.counter("reregister_resets_total")
        self.registry.counter("preemptions_total")
        self.membership.on_resurrect = self._on_member_resurrect
        self._httpd: Optional[_FedHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._drain_report: Optional[Dict[str, bool]] = None
        self._t_start = time.monotonic()
        self.admin_drain_requested = threading.Event()
        # The process-wide flight recorder, installed at start().
        self.flight = None
        # Live telemetry plane: the sampler ticks over the LOCAL
        # registry only (a member scrape per second would hammer the
        # fleet); /debug/timeseries fans the member query on demand.
        self.sampler: Optional[_obs_ts.Sampler] = None
        self.slo: Optional[_obs_slo.SloEngine] = None
        # Monotonic stamp of the last successful scrape per member
        # host, feeding the fleet_<host>_scrape_age_seconds gauges: a
        # stale fold is distinguishable from a live one, and a skipped
        # member is an explicit staleness gauge, never silently absent.
        self._last_scrape_ok: Dict[str, float] = {}

    # -- lifecycle -----------------------------------------------------

    def _local_snapshot(self) -> dict:
        snap = self.registry.snapshot()
        snap["counters"]["flightrec_dropped_total"] = (
            _obs_flight.dropped_total()
        )
        return snap

    def start(self) -> "FedFrontend":
        # The always-on flight recorder (obs.flight): idempotent per
        # process, spool per FedConfig (env override wins).
        self.flight = _obs_flight.install(spool_dir=self.cfg.flightrec_dir)
        for url in self.cfg.members:
            self.membership.register_seed(url)
        self.membership.start()
        self.router.start()
        if self.cfg.sample_interval_s > 0:
            self.sampler = _obs_ts.Sampler(
                self._local_snapshot, self.cfg.sample_interval_s
            )
            if self.cfg.slo_error_budget > 0:
                self.slo = _obs_slo.SloEngine(
                    _obs_slo.default_fed_objectives(self.cfg),
                    self.registry, tier="fed",
                    fast_window_s=self.cfg.slo_fast_window_s,
                    slow_window_s=self.cfg.slo_slow_window_s,
                    fast_burn=self.cfg.slo_fast_burn,
                    slow_burn=self.cfg.slo_slow_burn,
                )
                self.sampler.on_sample.append(self.slo.evaluate)
            self.sampler.start()
        self._httpd = _FedHTTPServer((self.cfg.host, self.cfg.port), self)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpu-stencil-torch-fed-http", daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        assert self._httpd is not None, "not started"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.cfg.host}:{self.port}"

    def request_admin_drain(self) -> None:
        self.begin_drain()
        self.admin_drain_requested.set()

    def begin_drain(self) -> None:
        self.router.begin_drain()

    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, bool]:
        """The SIGTERM sequence minus the process exit: stop
        admission, bleed every member's outstanding forwarded requests
        to zero under the budget, report per host clean-vs-abandoned.
        The listener stays up so in-flight responses deliver."""
        self.begin_drain()
        report = self.router.drain_wait(
            timeout_s if timeout_s is not None
            else self.cfg.drain_timeout_s
        )
        self._drain_report = report
        return report

    def drain_member(self, host_id: str) -> Optional[dict]:
        """Rolling whole-host drain: bleed traffic off the member
        (routing stops instantly), then drive its own
        ``POST /admin/drain`` SIGTERM-equivalent path. Returns the
        report dict, or None for an unknown host."""
        m = self.membership.get(host_id)
        if m is None:
            return None
        # Pinned: a heartbeat 200 must not re-admit the host behind
        # the operator's back (e.g. when the drain POST below fails
        # before the member flips its healthz).
        self.membership.mark_draining(host_id, pinned=True)
        self.registry.counter("member_drains_total").inc()
        member_resp: object = None
        try:
            req = urllib.request.Request(
                m.url + "/admin/drain", data=b"", method="POST"
            )
            with urllib.request.urlopen(req, timeout=10.0) as r:
                member_resp = json.loads(r.read())
        except Exception as e:
            member_resp = f"unreachable: {type(e).__name__}: {e}"
        return {
            "host_id": host_id,
            "draining": True,
            "member_response": member_resp,
        }

    def _on_member_resurrect(self, host_id: str) -> None:
        """A host re-registered after an eviction or drain: the new
        process must not inherit the dead one's open circuit breaker
        or its forward-latency tail in the hedge p99."""
        self.breakers.drop(host_id)
        self.router.reset_host(host_id)
        self.registry.counter("reregister_resets_total").inc()

    def preempt_member(self, host_id: str) -> Optional[dict]:
        """A host preemption notice: a PLANNED drain, never an
        eviction.  The member leaves routing now (pinned — heartbeat
        200s must not re-admit it) but keeps serving its in-flight
        work; the replacement is the control plane's job, started
        before the victim exits (``tpu_stencil_torch ctrl`` watches
        ``/statusz`` for pinned drains it owns).  Unlike
        :meth:`drain_member`, the victim's own drain is NOT driven
        here — capacity must arrive first."""
        m = self.membership.get(host_id)
        if m is None:
            return None
        self.membership.mark_draining(host_id, pinned=True)
        self.registry.counter("preemptions_total").inc()
        with _obs_span("fed.preempt", "fed", host=host_id):
            pass  # zero-duration marker: the notice moment
        m = self.membership.get(host_id)
        return {
            "host_id": host_id,
            "preempted": True,
            "state": m.state if m is not None else "unknown",
            "pinned_draining": bool(m and m.pinned_draining),
        }

    def warmstate(self) -> Optional[dict]:
        """The warm-state envelope, pulled from a warm member: the
        routable member with entries wins; a member that answers
        without entries is the fallback; None when nobody answers."""
        best: Optional[dict] = None
        for m in self.membership.routable():
            try:
                with urllib.request.urlopen(
                        m.url + "/admin/warmstate", timeout=10.0) as r:
                    doc = json.loads(r.read())
            except Exception:  # noqa: BLE001 - try the next member
                continue
            if not isinstance(doc, dict):
                continue
            if doc.get("entries"):
                return doc
            if best is None:
                best = doc
        return best

    def close(self) -> None:
        if self.sampler is not None:
            self.sampler.stop()
        if self.router is not None and not self.router.draining:
            self.drain()
        self.membership.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "FedFrontend":
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scrape surfaces -----------------------------------------------

    def debug_trace(self, trace_id: str) -> dict:
        """The cross-process trace tree: this process's spans (the
        flight ring + the live tracer) PLUS every live member's
        ``/debug/trace/<id>`` answer, fanned concurrently like the
        metrics fold — one lookup walks the whole federation, a wedged
        member costs one timeout, a 404 member simply contributes
        nothing."""
        import concurrent.futures

        local = _obs_flight.local_trace_spans(trace_id)
        processes = []
        if local:
            processes.append({
                "source": "fed",
                "span_count": len(local),
                "spans": local,
                "tree": _obs_flight.build_tree(local),
            })

        def fetch(m) -> list:
            with urllib.request.urlopen(
                m.url + "/debug/trace/" + trace_id, timeout=5.0
            ) as r:
                doc = json.loads(r.read())
            out = []
            for p in doc.get("processes", []):
                p = dict(p)
                p["source"] = f"{m.host_id}:{p.get('source', 'net')}"
                out.append(p)
            return out

        live = [m for m in self.membership.members()
                if m.state != "evicted"]
        if live:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(live)),
                thread_name_prefix="tpu-stencil-torch-fed-trace",
            ) as pool:
                futs = [pool.submit(fetch, m) for m in live]
                for fut in futs:
                    try:
                        processes.extend(fut.result())
                    except Exception:
                        continue  # 404 / unreachable: nothing to add
        return {
            "schema_version": 1,
            "trace_id": trace_id,
            "span_count": sum(p["span_count"] for p in processes),
            "processes": processes,
        }

    def metrics_snapshot(self) -> dict:
        """The fed registry with every live member's counters folded
        in as ``fleet_<host>_<name>`` — the net tier's replica fold,
        one hop up. Members scrape CONCURRENTLY (one wedged host costs
        one timeout, not members x timeout — a scrape is how an
        operator diagnoses exactly that host); a member whose scrape
        fails is skipped and counted: a scrape must never hang or die
        on one lost host."""
        import concurrent.futures

        snap = self._local_snapshot()
        from tpu_stencil_torch.obs import exposition

        def scrape(m) -> dict:
            with urllib.request.urlopen(m.url + "/metrics",
                                        timeout=5.0) as r:
                return exposition.parse_text(r.read().decode(),
                                             prefix="tpu_stencil_net")

        live = [m for m in self.membership.members()
                if m.state != "evicted"]
        if live:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(live)),
                thread_name_prefix="tpu-stencil-torch-fed-scrape",
            ) as pool:
                futs = [(m, pool.submit(scrape, m)) for m in live]
                for m, fut in futs:
                    try:
                        member = fut.result()
                        self._last_scrape_ok[m.host_id] = (
                            time.monotonic()
                        )
                    except Exception:
                        self.registry.counter(
                            "member_scrape_failures_total"
                        ).inc()
                        # Re-snapshot the counter so the failure
                        # itself is in this scrape.
                        snap["counters"][
                            "member_scrape_failures_total"
                        ] = self.registry.counter(
                            "member_scrape_failures_total"
                        ).value
                        continue
                    for k, v in sorted(
                        member.get("counters", {}).items()
                    ):
                        fk = f"fleet_{m.host_id}_{k}"
                        if fk in snap["counters"]:
                            # Fold collision: a member counter whose
                            # folded name is already taken (a fed
                            # counter literally named fleet_<host>_<k>,
                            # or two registrations of one host). The
                            # old behavior silently overwrote — the
                            # first writer's value vanished from the
                            # scrape. First writer wins; the collision
                            # is counted and re-snapshotted so THIS
                            # scrape shows it.
                            self.registry.counter(
                                "fold_collisions_total"
                            ).inc()
                            snap["counters"][
                                "fold_collisions_total"
                            ] = self.registry.counter(
                                "fold_collisions_total"
                            ).value
                            continue
                        snap["counters"][fk] = v
        # EVERY live member gets a scrape-age stamp — a member whose
        # scrape just failed (or never succeeded: age -1.0) shows up
        # as explicit staleness, never as silent absence from the fold.
        now = time.monotonic()
        for m in live:
            last = self._last_scrape_ok.get(m.host_id)
            age = round(now - last, 3) if last is not None else -1.0
            snap["gauges"][f"fleet_{m.host_id}_scrape_age_seconds"] = {
                "value": age, "peak": age,
            }
        snap["members"] = len(live)
        return snap

    def render_metrics(self) -> str:
        from tpu_stencil_torch.obs import exposition

        return exposition.render_text(self.metrics_snapshot(),
                                      prefix="tpu_stencil_fed")

    def debug_timeseries(self, window_s: float) -> dict:
        """The fed ``GET /debug/timeseries`` body: the local sampler's
        windowed view plus every live member's ``/debug/timeseries``
        answer, fanned concurrently with the same bounded-timeout
        discipline as the metrics fold. A member that fails mid-scrape
        surfaces as an explicit ``stale`` entry (with its last-good
        scrape age), never as silent absence — and one dead member
        costs one timeout, not a hang."""
        import concurrent.futures

        assert self.sampler is not None, "sampler is off"
        local = self.sampler.ring.window(window_s)
        local["source"] = "fed"
        local["slo"] = None if self.slo is None else self.slo.statusz()

        def fetch(m) -> dict:
            url = f"{m.url}/debug/timeseries?window={window_s:g}"
            with urllib.request.urlopen(url, timeout=5.0) as r:
                return json.loads(r.read())

        members: Dict[str, dict] = {}
        live = [m for m in self.membership.members()
                if m.state != "evicted"]
        if live:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(live)),
                thread_name_prefix="tpu-stencil-torch-fed-ts",
            ) as pool:
                futs = [(m, pool.submit(fetch, m)) for m in live]
                now = time.monotonic()
                for m, fut in futs:
                    try:
                        doc = fut.result()
                        self._last_scrape_ok[m.host_id] = (
                            time.monotonic()
                        )
                        doc["stale"] = False
                        doc["scrape_age_s"] = 0.0
                        members[m.host_id] = doc
                    except Exception as e:
                        self.registry.counter(
                            "member_scrape_failures_total"
                        ).inc()
                        last = self._last_scrape_ok.get(m.host_id)
                        members[m.host_id] = {
                            "stale": True,
                            "error": f"{type(e).__name__}: {e}",
                            "scrape_age_s": (
                                round(now - last, 3)
                                if last is not None else -1.0
                            ),
                        }
        return {
            "schema_version": _obs_ts.SCHEMA_VERSION,
            "window_s": float(window_s),
            "source": "fed",
            "fed": local,
            "members": members,
        }

    def _fan_members(self, path: str, prefix: str) -> Dict[str, dict]:
        """Fan one GET to every live member with the
        ``/debug/timeseries`` staleness discipline: a fresh answer is
        stamped ``stale=False``/``scrape_age_s=0``; a failed member
        surfaces as an explicit ``stale`` entry carrying its last-good
        scrape age and the scrape-failure counter ticks — never silent
        absence, never a hang (one dead member costs one timeout)."""
        import concurrent.futures

        def fetch(m) -> dict:
            with urllib.request.urlopen(m.url + path, timeout=5.0) as r:
                return json.loads(r.read())

        members: Dict[str, dict] = {}
        live = [m for m in self.membership.members()
                if m.state != "evicted"]
        if live:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(live)),
                thread_name_prefix=prefix,
            ) as pool:
                futs = [(m, pool.submit(fetch, m)) for m in live]
                now = time.monotonic()
                for m, fut in futs:
                    try:
                        doc = fut.result()
                        self._last_scrape_ok[m.host_id] = (
                            time.monotonic()
                        )
                        doc["stale"] = False
                        doc["scrape_age_s"] = 0.0
                        members[m.host_id] = doc
                    except Exception as e:
                        self.registry.counter(
                            "member_scrape_failures_total"
                        ).inc()
                        last = self._last_scrape_ok.get(m.host_id)
                        members[m.host_id] = {
                            "stale": True,
                            "error": f"{type(e).__name__}: {e}",
                            "scrape_age_s": (
                                round(now - last, 3)
                                if last is not None else -1.0
                            ),
                        }
        return members

    def debug_tenants(self) -> dict:
        """The fed ``GET /debug/tenants`` body: every live member's
        metering table fanned + merged (numeric fields summed across
        fresh members — a stale member contributes its staleness entry,
        never phantom numbers), next to the fed-local quota view. A
        hedged request only ever counts once in the merge: the losing
        member's write failed, so its meter never recorded the
        request."""
        members = self._fan_members("/debug/tenants",
                                    "tpu-stencil-torch-fed-tenants")
        merged: Dict[str, dict] = {}
        fresh_ids = set()
        for hid, doc in members.items():
            if doc.get("stale"):
                continue
            fresh_ids.add(hid)
            for tenant, row in doc.get("tenants", {}).items():
                agg = merged.setdefault(tenant, {})
                for k, v in row.items():
                    if isinstance(v, (int, float)):
                        agg[k] = agg.get(k, 0) + v
        # Reconcile hedge losers: a cancelled attempt whose 200 was
        # already written got billed by its member, but nobody received
        # it — subtract those (only for members actually folded) so
        # the merged totals count every delivered answer exactly once.
        discards = self.router.hedge_discards(fresh_ids)
        for tenant, d in discards.items():
            row = merged.get(tenant)
            if row is None:
                continue
            row["requests"] = max(
                0, row.get("requests", 0) - d["requests"]
            )
            row["device_seconds"] = max(
                0.0, row.get("device_seconds", 0.0)
                - d["device_seconds"]
            )
        for row in merged.values():
            # Ratios do not sum — recompute from the merged counts.
            req = row.get("requests", 0)
            row["cache_hit_ratio"] = (
                row.get("cache_hits", 0) / req if req else 0.0
            )
        return {
            "schema_version": 1,
            "source": "fed",
            "fed": self.router.tenant_stats(),
            "tenants": merged,
            "hedge_discards": discards,
            "members": members,
        }

    def debug_capacity(self, window_s: float) -> dict:
        """The fed ``GET /debug/capacity`` body: every live member's
        capacity answer fanned + merged. Headroom SUMS across fresh
        members (rps the federation can still absorb); utilization
        reports the hottest member (the saturation bottleneck);
        time-to-saturation is the earliest projected across members.
        Stale members are excluded from the aggregates and carried as
        explicit staleness entries."""
        members = self._fan_members(
            f"/debug/capacity?window={window_s:g}",
            "tpu-stencil-torch-fed-capacity",
        )
        fresh = [doc for doc in members.values()
                 if not doc.get("stale")]
        headrooms = [doc["headroom_rps"] for doc in fresh
                     if doc.get("headroom_rps") is not None]
        utils = [doc["utilization"]["slot_fraction"] for doc in fresh
                 if doc.get("utilization")]
        sat = [doc["time_to_saturation_s"] for doc in fresh
               if doc.get("time_to_saturation_s") is not None]
        return {
            "schema_version": 1,
            "source": "fed",
            "window_s": float(window_s),
            "members_live": len(members),
            "members_fresh": len(fresh),
            "headroom_rps": sum(headrooms) if headrooms else None,
            "utilization": {
                "max_member_slot_fraction": max(utils) if utils
                else None,
            },
            "time_to_saturation_s": min(sat) if sat else None,
            "outstanding": self.router.outstanding(),
            "members": members,
        }

    def statusz(self) -> dict:
        return {
            "schema_version": FED_STATUS_SCHEMA_VERSION,
            "ts": time.monotonic(),
            "uptime_s": time.monotonic() - self._t_start,
            "draining": self.router.draining,
            "members": self.membership.statusz(),
            "breakers": self.breakers.statusz(),
            "outstanding": self.router.outstanding(),
            "tenants": self.router.tenants(),
            "drain_report": self._drain_report,
            "slo": None if self.slo is None else self.slo.statusz(),
            "timeseries": None if self.sampler is None else {
                "interval_s": self.sampler.interval_s,
                "samples": len(self.sampler.ring),
            },
            "flightrec_dropped_total": _obs_flight.dropped_total(),
            # The same merged snapshot /metrics renders; loadgen's
            # HttpTarget.stats() reads this key, so --http against a
            # federation works unchanged.
            "net": self.metrics_snapshot(),
            "config": {
                "members": list(self.cfg.members),
                "heartbeat_interval_s": self.cfg.heartbeat_interval_s,
                "suspect_after": self.cfg.suspect_after,
                "evict_after": self.cfg.evict_after,
                "breaker_threshold": self.cfg.breaker_threshold,
                "breaker_cooldown_s": self.cfg.breaker_cooldown_s,
                "hedge": self.cfg.hedge,
                "hedge_min_s": self.cfg.hedge_min_s,
                "digest_affinity": self.cfg.digest_affinity,
                "forward_timeout_s": self.cfg.forward_timeout_s,
                "reoffer_s": self.cfg.reoffer_s,
                "max_inflight_mb": self.cfg.max_inflight_mb,
                "tenant_quota": self.cfg.tenant_quota,
                "premium_tenants": list(self.cfg.premium_tenants),
                "premium_quota_factor": self.cfg.premium_quota_factor,
                "drain_timeout_s": self.cfg.drain_timeout_s,
                "flightrec_dir": _obs_flight.effective_spool(
                    self.cfg.flightrec_dir
                ),
                "flight_latency_threshold_s":
                    self.cfg.flight_latency_threshold_s,
                "sample_interval_s": self.cfg.sample_interval_s,
                "slo_error_budget": self.cfg.slo_error_budget,
            },
        }
