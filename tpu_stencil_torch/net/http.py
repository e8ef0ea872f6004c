"""The HTTP network edge: stdlib-only threaded frontend over the fleet
(the port's copy of the JAX package's ``net/http.py``: the same
endpoints, status codes, headers, metric names and JSON payloads, so a
client, a load balancer and a dashboard read both packages alike).

Endpoints:

* ``POST /v1/blur`` — one raw frame in, one blurred raw frame out.
  Geometry rides headers (``X-Width``/``X-Height``/``X-Reps``/
  ``X-Channels``/``X-Filter``) or query params (``w``/``h``/``reps``/
  ``channels``/``filter``; headers win); the body is the headerless
  frame bytes (``Content-Length`` or ``Transfer-Encoding: chunked`` —
  large frames stream up in chunks, the reference's headerless ``.raw``
  contract carried onto the wire). ``X-Request-Timeout`` (seconds)
  overrides the per-request deadline. Responses: 200 with the blurred
  bytes (+ the same geometry headers), 400 validation, 404 wrong path,
  413 oversized body, 429 + ``Retry-After`` when every replica queue
  is full, 503 + ``Retry-After`` when shedding or draining, 504 when
  the deadline expired (``DeadlineExceeded``), 500 anything else.
* ``GET /healthz`` — 200 ``ok`` serving / 200 ``degraded`` when the
  SLO burn-rate engine holds a breach (still routable, visibly
  unhealthy) / 503 ``draining`` after SIGTERM. The readiness probe: a
  load balancer stops routing here the moment the drain begins.
* ``GET /metrics`` — Prometheus-style text exposition
  (:mod:`tpu_stencil_torch.obs.exposition`, prefix ``tpu_stencil_net``):
  the net registry (router + fleet + per-request HTTP metrics) with
  every replica's counters
  folded in as ``fleet_<name>`` — one scrape, one prefix, exact
  parse round-trip.
* ``GET /statusz`` — the JSON operator view: per-replica snapshots,
  router outstanding/inflight, drain state (versioned schema).
* ``POST /admin/restart?replica=i`` — rolling single-replica restart
  (:meth:`ReplicaFleet.restart`); the rest of the fleet serves on.
* ``POST /admin/drain`` — the SIGTERM-equivalent admin path (the
  federation's rolling whole-host drain drives it): flips healthz,
  stops admission, and signals the CLI loop to run the full drain
  sequence and exit with its usual rc discipline.
* ``GET /admin/cache?action=clear|stats`` — operator control over the
  result cache (``--result-cache-mb``; 404 when it is off): ``clear``
  wipes every entry, ``stats`` reports sizes without touching one.
* ``GET /debug/timeseries[?window=s]`` — windowed counter deltas and
  per-second rates from the in-process sampler ring
  (:mod:`tpu_stencil_torch.obs.timeseries`; versioned JSON; 404 typed when
  the sampler is off).
* ``POST /debug/prof?seconds=N`` — one bounded ``torch.profiler``
  capture into a capped spool (404-clean when profiling is
  unavailable; 409 while one runs); ``GET /debug/prof`` lists
  captures, ``GET /debug/prof/<path>`` fetches a trace file.

With ``--result-cache-mb N`` the edge holds a content-addressed result
cache in front of the router (:mod:`tpu_stencil_torch.cache`): the request
body's BLAKE2b-160 digest (fused into the same scan as the CRC claim
check) plus filter/reps/geometry keys a byte-budgeted LRU of true
result bytes. A hit answers ``X-Cache: hit`` with the stored payload
and stamp, never touching admission; concurrent identical misses
collapse onto one leader launch (``X-Cache: collapsed`` for the
followers); a witness mismatch or quarantine on a replica synchronously
drops every entry it produced.

Chaos sites ``net.accept`` (drop/stall a connection before any
response) and ``net.body`` (truncate a 200 mid-body, or stall) arm via
the standard ``TPU_STENCIL_TORCH_FAULTS`` grammar — the socket-level failure
modes the federation's verdict classifier must survive.

:class:`NetFrontend` owns the whole tier lifecycle: fleet → router →
threaded HTTP server, then ``begin_drain`` (flip healthz, stop
admission) → ``drain`` (close every replica under the budget, report
which hung) → ``close`` (stop the listener). SIGTERM in the CLI maps
onto exactly that sequence.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence
from urllib.parse import parse_qs, urlsplit

import numpy as np

from tpu_stencil_torch.cache import ResultCache
from tpu_stencil_torch.cache import digest as _cache_digest
from tpu_stencil_torch.config import NetConfig
from tpu_stencil_torch.integrity import checksum as _checksum
from tpu_stencil_torch.integrity.quarantine import (
    QuarantineBoard,
    QuarantineProber,
)
from tpu_stencil_torch.net.arena import StagingArena
from tpu_stencil_torch.net.fleet import ReplicaFleet
from tpu_stencil_torch.net.router import (
    RETRY_AFTER_QUEUE_FULL,
    RETRY_AFTER_SHED,
    Draining,
    Overloaded,
    Router,
)
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.obs import flight as _obs_flight
from tpu_stencil_torch.obs import ledger as _obs_ledger
from tpu_stencil_torch.obs import prof as _obs_prof
from tpu_stencil_torch.obs import slo as _obs_slo
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.obs import timeseries as _obs_ts
from tpu_stencil_torch.resilience.errors import DeadlineExceeded, WorkerCrashed
from tpu_stencil_torch.serve import bucketing
from tpu_stencil_torch.serve.engine import QueueFull, ServerClosed
from tpu_stencil_torch.serve.metrics import Registry

# /statusz + --stats-json payload schema. Bump on breaking changes.
STATUS_SCHEMA_VERSION = 1

# (RETRY_AFTER_* floors live in net.router next to the derived
# retry_after_s hint; re-imported here so the wire constants keep one
# spelling for both HTTP tiers.)

# Hard cap on how long a handler thread waits for an accepted request
# with no explicit deadline — the never-hang discipline at the edge.
_RESULT_TIMEOUT_S = 600.0

# Upload bound: a request body may not exceed the declared frame bytes
# (chunked uploads have no Content-Length to sanity-check up front).
_MAX_EXTRA_BODY = 2

# Default /debug/timeseries window when ?window= is absent.
DEFAULT_TS_WINDOW_S = 60.0


def _parse_window(query: dict) -> Optional[float]:
    """``?window=<seconds>`` -> float, :data:`DEFAULT_TS_WINDOW_S` when
    absent, ``None`` (the caller's 400) when malformed/non-positive.
    Shared by the net and fed handlers."""
    raw = query.get("window", [None])[0]
    if raw is None:
        return DEFAULT_TS_WINDOW_S
    try:
        w = float(raw)
    except ValueError:
        return None
    return w if w > 0 else None

# How long an armed net.accept/net.body rule with raise=TimeoutError
# stalls the handler (the chaos stand-in for a wedged host; the default
# outlasts the 120s read-side socket timeout and typical forward
# timeouts, so the PEER's timeout path fires — tests shrink it).
STALL_ENV = "TPU_STENCIL_TORCH_FAULT_STALL_S"
_DEFAULT_STALL_S = 150.0


def _fault_stall_s() -> float:
    import os

    return float(os.environ.get(STALL_ENV, _DEFAULT_STALL_S))


class _Oversized(ValueError):
    """Body larger than the declared frame (→ 413; a malformed framing
    header is a plain ValueError → 400 — shrinking won't fix it)."""


def traced_error_body(code: int, msg: str, trace_id: str) -> bytes:
    """The typed JSON error body of a request-scoped rejection — the
    trace id rides in the body next to the header echo, so a logged
    body alone greps to its trace. One spelling for BOTH HTTP tiers
    (the fed handler imports it), so the wire contract cannot drift."""
    return json.dumps({
        "error": msg.rstrip("\n"),
        "status": code,
        "trace_id": trace_id,
    }).encode() + b"\n"


def send_trace_pair(handler, trace, headers: Dict[str, str]) -> None:
    """Echo the ``X-Trace-Id``/``X-Span-Id`` pair on a response being
    assembled (skipping keys the caller already set) — shared by both
    tiers' ``_respond``."""
    if _obs_ctx.TRACE_HEADER not in headers:
        handler.send_header(_obs_ctx.TRACE_HEADER, trace.trace_id)
    if _obs_ctx.SPAN_HEADER not in headers:
        handler.send_header(_obs_ctx.SPAN_HEADER, trace.span_id)


def read_request_body(rfile, headers, limit: int) -> bytes:
    """The upload: ``Content-Length`` bodies in one read, chunked
    transfer decoded chunk by chunk (stdlib handlers do NOT de-chunk).
    ``limit`` bounds either path — a body past the declared frame size
    fails typed (:class:`_Oversized` → 413) instead of buffering.
    Module-level so the federation frontend (:mod:`tpu_stencil_torch.fed`)
    reads its uploads under the exact same framing contract."""
    te = (headers.get("Transfer-Encoding") or "").lower()
    if "chunked" in te:
        chunks = []
        total = 0
        while True:
            # 1024 accommodates spec-legal chunk extensions; a line
            # that still lacks its newline was truncated mid-line,
            # and parsing it would desync the stream (the unread
            # tail would be consumed as payload) — fail typed.
            size_line = rfile.readline(1024)
            if size_line and not size_line.endswith(b"\n"):
                raise ValueError(
                    "chunk-size line exceeds 1024 bytes"
                )
            try:
                size = int(
                    size_line.split(b";")[0].strip() or b"0", 16
                )
            except ValueError:
                raise ValueError(
                    f"malformed chunk-size line {size_line!r}"
                ) from None
            if size == 0:
                # Consume trailers (none expected) up to blank line.
                while rfile.readline(1024).strip():
                    pass
                break
            total += size
            if total > limit + _MAX_EXTRA_BODY:
                raise _Oversized(
                    f"chunked body exceeds declared frame size "
                    f"({limit} bytes)"
                )
            chunks.append(rfile.read(size))
            rfile.read(2)  # chunk-terminating CRLF
        return b"".join(chunks)
    try:
        n = int(headers.get("Content-Length") or 0)
    except ValueError:
        raise ValueError(
            f"malformed Content-Length "
            f"{headers.get('Content-Length')!r}"
        ) from None
    if n > limit + _MAX_EXTRA_BODY:
        raise _Oversized(
            f"body of {n} bytes exceeds declared frame size "
            f"({limit} bytes)"
        )
    return rfile.read(n)


def _readinto_all(rfile, mv: memoryview) -> int:
    """Fill ``mv`` from the stream (readinto loops until full or EOF);
    returns bytes read."""
    total = 0
    while total < len(mv):
        n = rfile.readinto(mv[total:])
        if not n:
            break
        total += n
    return total


def read_request_body_into(rfile, headers, buf, limit: int) -> int:
    """Zero-copy sibling of :func:`read_request_body`: the upload lands
    DIRECTLY in ``buf`` (a staging-arena buffer of at least ``limit`` +
    slop bytes) via ``readinto`` — no intermediate ``bytes`` objects on
    either the Content-Length or the chunked path. Same framing
    contract: a body past the declared frame size fails typed
    (:class:`_Oversized` -> 413), a malformed frame is a ValueError
    (-> 400). Returns the byte count actually read; the caller treats a
    short body exactly like the buffered path does (400)."""
    mv = memoryview(buf).cast("B")
    cap = min(len(mv), limit + _MAX_EXTRA_BODY)
    te = (headers.get("Transfer-Encoding") or "").lower()
    if "chunked" in te:
        total = 0
        while True:
            size_line = rfile.readline(1024)
            if size_line and not size_line.endswith(b"\n"):
                raise ValueError("chunk-size line exceeds 1024 bytes")
            try:
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                raise ValueError(
                    f"malformed chunk-size line {size_line!r}"
                ) from None
            if size == 0:
                while rfile.readline(1024).strip():
                    pass
                return total
            if total + size > limit + _MAX_EXTRA_BODY:
                raise _Oversized(
                    f"chunked body exceeds declared frame size "
                    f"({limit} bytes)"
                )
            got = _readinto_all(rfile, mv[total:total + size])
            total += got
            if got < size:
                return total  # stream ended mid-chunk: short body, 400
            rfile.read(2)  # chunk-terminating CRLF
    try:
        n = int(headers.get("Content-Length") or 0)
    except ValueError:
        raise ValueError(
            f"malformed Content-Length "
            f"{headers.get('Content-Length')!r}"
        ) from None
    if n > limit + _MAX_EXTRA_BODY:
        raise _Oversized(
            f"body of {n} bytes exceeds declared frame size "
            f"({limit} bytes)"
        )
    return _readinto_all(rfile, mv[:min(n, cap)])


class _NetHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # Restart fast after a drain in tests/ops (no TIME_WAIT bind error).
    allow_reuse_address = True

    def __init__(self, addr, frontend: "NetFrontend") -> None:
        self.frontend = frontend
        super().__init__(addr, _Handler)


class _Handler(BaseHTTPRequestHandler):
    # 1.1 so chunked request bodies are legal; every response carries an
    # explicit Content-Length, keeping keep-alive connections coherent.
    protocol_version = "HTTP/1.1"
    server_version = "tpu-stencil-torch-net/1"
    # Socket timeout: a client that declares Content-Length and goes
    # quiet mid-body would otherwise pin this handler thread forever
    # (the never-hang discipline covers the READ side of the edge too;
    # stdlib maps the timeout onto the connection socket and drops it).
    timeout = 120.0

    # -- plumbing ------------------------------------------------------

    # The request-scoped trace context (obs.context): set by _blur,
    # cleared at the top of every do_* — handler instances persist per
    # keep-alive connection, so a stale context must never leak onto
    # the next request.
    _trace: Optional[_obs_ctx.TraceContext] = None
    # The request's metered tenant (sanitized X-Tenant): set by _blur
    # with the same keep-alive hygiene, so a 429/503 answered later on
    # the connection never bills the previous request's tenant.
    _tenant: Optional[str] = None

    def log_message(self, *args) -> None:
        pass  # metrics, not stderr chatter, are the observability story

    @property
    def fe(self) -> "NetFrontend":
        return self.server.frontend

    def _respond(self, code: int, body: bytes,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None) -> None:
        klass = f"responses_{code // 100}xx_total"
        self.fe.registry.counter(klass).inc()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        headers = headers or {}
        if self._trace is not None:
            # Every response — 200 AND 4xx/5xx — echoes the trace pair,
            # so a client correlates its failure to /debug/trace and
            # the flight-recorder spool without parsing bodies.
            send_trace_pair(self, self._trace, headers)
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str,
               headers: Optional[Dict[str, str]] = None) -> None:
        # Close after every error response: the early-error paths
        # (bad params, oversized/malformed framing, unknown path)
        # answer BEFORE the request body was consumed, and unread body
        # bytes on a kept-alive connection would be parsed as the next
        # request line — garbage for the whole connection.
        self.close_connection = True
        if self._tenant is not None and code in (429, 503):
            # The abuse view's two columns: a shed/backpressured
            # request cost no device time, but the tenant meter still
            # counts WHO was told to back off.
            self.fe.tenants.reject(self._tenant, code)
        if self._trace is not None:
            # Request-scoped errors answer the typed JSON body carrying
            # the trace id next to the header echo.
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

    def _read_body(self, limit: int) -> bytes:
        return read_request_body(self.rfile, self.headers, limit)

    # -- GET -----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        self._trace = None
        self._tenant = None
        split = urlsplit(self.path)
        path = split.path
        if path == "/healthz":
            if self.fe.router.draining:
                self._error(503, "draining")
            elif self.fe.slo is not None and self.fe.slo.degraded():
                # Degraded ≠ draining: still 200 (routable — shedding
                # a whole host on a burn-rate breach would amplify the
                # incident), but visibly unhealthy to probes.
                self._respond(200, b"degraded\n")
            else:
                self._respond(200, b"ok\n")
        elif path == "/metrics":
            text = self.fe.render_metrics()
            self._respond(200, text.encode(),
                          content_type="text/plain; version=0.0.4")
        elif path == "/statusz":
            payload = json.dumps(self.fe.statusz(), indent=2,
                                 sort_keys=True)
            self._respond(200, payload.encode(),
                          content_type="application/json")
        elif path == "/admin/cache":
            self._admin_cache(parse_qs(split.query))
        elif path == "/admin/warmstate":
            self._admin_warmstate()
        elif path == "/debug/timeseries":
            self._debug_timeseries(parse_qs(split.query))
        elif path == "/debug/capacity":
            self._debug_capacity(parse_qs(split.query))
        elif path == "/debug/tenants":
            self._respond(
                200,
                json.dumps(self.fe.tenants_payload(), indent=2,
                           sort_keys=True).encode(),
                content_type="application/json",
            )
        elif path == "/debug/prof" or path.startswith("/debug/prof/"):
            self._debug_prof_get(path)
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

    def _debug_trace(self, trace_id: str) -> None:
        if not _obs_ctx.valid_id(trace_id):
            self._error(400, f"malformed trace id {trace_id!r}")
            return
        payload = self.fe.debug_trace(trace_id)
        if payload["span_count"] == 0:
            self._error(404, f"no spans recorded for trace {trace_id} "
                             "(aged out of the ring, or never here)")
            return
        self._respond(200, json.dumps(payload, indent=2).encode(),
                      content_type="application/json")

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
        payload = self.fe.timeseries_payload(window_s)
        self._respond(200, json.dumps(payload, indent=2,
                                      sort_keys=True).encode(),
                      content_type="application/json")

    def _debug_capacity(self, query: dict) -> None:
        window_s = _parse_window(query)
        if window_s is None:
            self._error(400, "window must be a positive number of "
                             "seconds")
            return
        payload = self.fe.capacity_payload(window_s)
        self._respond(200, json.dumps(payload, indent=2,
                                      sort_keys=True).encode(),
                      content_type="application/json")

    def _debug_prof_get(self, path: str) -> None:
        spool = self.fe.cfg.prof_dir
        if spool is None:
            self._error(404, "profiler spool is off (--prof-dir none)")
            return
        if path == "/debug/prof":
            payload = _obs_prof.spool_list(spool)
            self._respond(200, json.dumps(payload, indent=2,
                                          sort_keys=True).encode(),
                          content_type="application/json")
            return
        data = _obs_prof.spool_read(spool, path[len("/debug/prof/"):])
        if data is None:
            self._error(404, "no such profiler capture file")
            return
        self._respond(200, data,
                      content_type="application/octet-stream")

    def _debug_prof_post(self, query: dict) -> None:
        spool = self.fe.cfg.prof_dir
        if spool is None:
            self._error(404, "profiler spool is off (--prof-dir none)")
            return
        ok, reason = _obs_prof.available()
        if not ok:
            self._error(404, reason)
            return
        try:
            seconds = float(query.get("seconds", ["1.0"])[0])
        except ValueError:
            self._error(400, "seconds must be a number")
            return
        try:
            result = _obs_prof.capture(seconds, spool)
        except RuntimeError as e:
            if str(e) == "busy":
                self._error(409, "a profiler capture is already running")
            else:
                self._error(404, str(e))
            return
        self._respond(200, json.dumps(result, indent=2,
                                      sort_keys=True).encode(),
                      content_type="application/json")

    # -- POST ----------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        self._trace = None
        self._tenant = None
        split = urlsplit(self.path)
        if split.path == "/v1/blur":
            with self.fe.blur_in_progress():
                self._blur(parse_qs(split.query))
        elif split.path == "/admin/restart":
            self._restart(parse_qs(split.query))
        elif split.path == "/admin/drain":
            self._admin_drain()
        elif split.path == "/admin/quarantine":
            self._quarantine(parse_qs(split.query))
        elif split.path == "/debug/prof":
            self._debug_prof_post(parse_qs(split.query))
        else:
            self._error(404, f"no such endpoint: {split.path}")

    # -- socket-level fault sites (net.accept / net.body) --------------

    def _socket_fault(self, site) -> bool:
        """Fire an armed ``net.accept`` rule. A ``raise=TimeoutError``
        rule STALLS the handler (the wedged-host chaos mode — the
        peer's socket/forward timeout is what fires); any other rule
        DROPS the connection with no response at all (the client sees
        a reset/empty reply, the federation's ``reset`` verdict).
        Returns True when the handler must return immediately."""
        try:
            site()
        except TimeoutError:
            time.sleep(_fault_stall_s())
            return False
        except Exception:
            self.close_connection = True
            return True
        return False

    def _body_fault(self, site, payload: bytes) -> bool:
        """Fire an armed ``net.body`` rule on a success response. A
        ``raise=TimeoutError`` rule stalls before the body is written;
        any other rule declares the FULL Content-Length, writes half
        the body, and drops the connection — the mid-body EOF the
        federation's ``eof`` verdict classifies. Returns True when the
        (truncated) response was already written."""
        try:
            site()
        except TimeoutError:
            time.sleep(_fault_stall_s())
            return False
        except Exception:
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(payload[: max(1, len(payload) // 2)])
            try:
                self.wfile.flush()
            except Exception:
                pass
            return True
        return False

    def _admin_drain(self) -> None:
        """The SIGTERM-equivalent admin path (the federation's rolling
        whole-host drain calls it): flip /healthz to draining, stop
        admission, and signal the CLI loop to run the full drain
        sequence and exit with its usual rc discipline. Responds
        BEFORE the replicas drain — the drain takes seconds and the
        caller only needs the acknowledgement."""
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(min(n, 1 << 20))
        self.fe.request_admin_drain()
        self._respond(200, json.dumps(
            {"draining": True, "replicas": len(self.fe.fleet)}
        ).encode(), content_type="application/json")

    def _quarantine(self, query: dict) -> None:
        """Operator quarantine override:
        ``?replica=i`` trips quarantine (out of routing now, probes or
        an explicit ``action=clear`` bring it back); ``action=clear``
        releases without waiting for the probe streak."""
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(min(n, 1 << 20))
        try:
            idx = int(query.get("replica", ["-1"])[0])
            if not 0 <= idx < len(self.fe.fleet):
                raise ValueError
        except ValueError:
            self._error(
                400, f"replica must be 0..{len(self.fe.fleet) - 1}"
            )
            return
        action = query.get("action", ["quarantine"])[0]
        if action == "clear":
            changed = self.fe.router.release_replica(idx)
        elif action == "quarantine":
            changed = self.fe.router.quarantine_replica(
                idx, "operator request (POST /admin/quarantine)"
            )
        else:
            self._error(400,
                        f"action must be quarantine|clear, got {action!r}")
            return
        self._respond(200, json.dumps({
            "replica": idx, "action": action, "changed": changed,
            "quarantined": bool(
                self.fe.quarantine is not None
                and self.fe.quarantine.is_quarantined(idx)
            ),
        }).encode(), content_type="application/json")

    def _admin_cache(self, query: dict) -> None:
        """Operator control over the result cache: ``?action=clear``
        wipes every entry (counted under
        ``cache_invalidations_clear_total``), ``?action=stats`` (the
        default) reports sizes without touching one. 404 when the tier
        runs cache-off — a probe can tell "cleared" from "was never
        caching"."""
        fe = self.fe
        if fe.cache is None:
            self._error(
                404, "result cache is not enabled (--result-cache-mb)"
            )
            return
        action = query.get("action", ["stats"])[0]
        if action == "clear":
            cleared = fe.cache.clear()
            self._respond(200, json.dumps(
                {"action": "clear", "cleared": cleared}
            ).encode(), content_type="application/json")
        elif action == "stats":
            self._respond(200, json.dumps(fe.cache.stats()).encode(),
                          content_type="application/json")
        else:
            self._error(
                400, f"action must be clear|stats, got {action!r}"
            )

    def _admin_warmstate(self) -> None:
        """``GET /admin/warmstate``: this host's warm-state envelope
        (:meth:`ReplicaFleet.warmstate_export`: program-cache keys, never
        binaries) for a joining host to rebuild and warm-run from its own
        kernel sources before it flips ready."""
        payload = self.fe.fleet.warmstate_export()
        self._respond(200, json.dumps(payload).encode(),
                      content_type="application/json")

    def _restart(self, query: dict) -> None:
        # Consume any request body first: an unread body corrupts the
        # keep-alive stream for the next request on this connection.
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(min(n, 1 << 20))
        try:
            idx = int(query.get("replica", ["-1"])[0])
            if not 0 <= idx < len(self.fe.fleet):
                raise ValueError
        except ValueError:
            self._error(
                400, f"replica must be 0..{len(self.fe.fleet) - 1}"
            )
            return
        drained = self.fe.fleet.restart(idx)
        self._respond(200, json.dumps(
            {"replica": idx, "restarted": True, "old_drained": drained}
        ).encode(), content_type="application/json")

    def _blur(self, query: dict) -> None:
        fe = self.fe
        if fe.fault_accept is not None and self._socket_fault(
            fe.fault_accept
        ):
            return  # injected connection drop: no response at all
        # Trace context: adopt a valid inbound X-Trace-Id (the fed hop,
        # or a tracing client), mint otherwise — net is the outermost
        # edge when unfederated. Bound for the handler's duration so
        # every span below (and the serve engine's request records)
        # stitches into one cross-process trace.
        ctx = self._trace = _obs_ctx.from_headers(self.headers)
        # The cost ledger (obs.ledger): bound next to the trace context
        # so the router's coalescer and the engine's retire fence credit
        # THIS request's spend with no call-site plumbing. Tenant comes
        # off the wire (X-Tenant, forwarded by the fed hop) — sanitized
        # before it can reach a metric name.
        tenant = self._tenant = _obs_ledger.sanitize_tenant(
            self._param(query, _obs_ledger.TENANT_HEADER, "tenant")
        )
        led = _obs_ledger.RequestLedger(tenant)
        t0 = time.perf_counter()
        with _obs_ctx.bind(ctx), _obs_ledger.bind(led), \
                _obs_span("net.request", "net"):
            try:
                w = int(self._param(query, "X-Width", "w"))
                h = int(self._param(query, "X-Height", "h"))
                reps = int(self._param(query, "X-Reps", "reps"))
                channels = int(
                    self._param(query, "X-Channels", "channels", "1")
                )
                fname = self._param(query, "X-Filter", "filter")
                boundary = self._param(
                    query, "X-Boundary", "boundary", "zero"
                )
                timeout = self._param(
                    query, "X-Request-Timeout", "timeout"
                )
                deadline_s = float(timeout) if timeout else None
                if w < 1 or h < 1:
                    raise ValueError(f"bad frame geometry {w}x{h}")
                if reps < 0:
                    raise ValueError(f"reps must be >= 0, got {reps}")
                if channels not in (1, 3):
                    raise ValueError(
                        f"channels must be 1 (grey) or 3 (rgb), got "
                        f"{channels}"
                    )
                if fname:
                    # Validate HERE (numpy-only lookup): an unknown
                    # X-Filter is a 400, not a worker-side KeyError
                    # surfacing as 500 — and it must never reach the
                    # warm-key dedup cache.
                    from tpu_stencil_torch import filters as _filters

                    try:
                        _filters.get_filter(fname)
                    except KeyError as e:
                        raise ValueError(str(e)) from None
            except (TypeError, ValueError) as e:
                self._error(400, f"bad request parameters: {e}")
                return
            if boundary != "zero":
                # The serve engines preserve zero semantics only (pad
                # re-zeroing) — answer typed, never silently wrong
                # pixels.
                self._error(
                    400,
                    f"boundary={boundary!r} is not servable over the "
                    "bucket-padded engines (zero only); run it via "
                    "`python -m tpu_stencil_torch` instead",
                )
                return
            expected = w * h * channels
            # Zero-copy ingest: the body is readinto a bucket-capacity
            # staging buffer, the CRC runs over it in place, and the
            # frame VIEW rides into the engine owned — released back to
            # the arena once the engine's worker copied it into its
            # pinned canvas (or the request failed first; release is
            # idempotent). The arena buffer itself is never the source
            # of an asynchronous copy to the card.
            lease = None
            release = None
            t_ing = time.perf_counter()
            if fe.arena is not None:
                bh, bw = bucketing.bucket_shape(
                    h, w, fe.cfg.bucket_edges or bucketing.DEFAULT_EDGES
                )
                # +slop so an over-declared body still reads FULLY and
                # fails the length check like the buffered path (a
                # bucket-exact frame would otherwise leave the excess
                # unread on a kept-alive socket); one capacity per
                # bucket either way, so pooling is unaffected.
                lease = fe.arena.lease(
                    bh * bw * channels + _MAX_EXTRA_BODY
                )
                release = lease.release
                try:
                    got = read_request_body_into(
                        self.rfile, self.headers, lease.array, expected
                    )
                except _Oversized as e:
                    release()
                    self._error(413, str(e))
                    return
                except ValueError as e:
                    release()
                    self._error(400, str(e))
                    return
                if got != expected:
                    release()
                    self._error(
                        400,
                        f"body is {got} bytes; {w}x{h}x{channels} "
                        f"needs exactly {expected}",
                    )
                    return
                flat = lease.view(expected)
            else:
                try:
                    body = self._read_body(expected)
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
                # A frombuffer view keeps the (immutable) bytes object
                # alive — still no copy, just no buffer reuse either.
                flat = np.frombuffer(body, np.uint8)
            # Chaos site: flip a bit in the ingested body AFTER the
            # framing checks, BEFORE checksum validation — the exact
            # corruption the X-Content-Crc32c hop exists to catch.
            if fe.fault_corrupt_ingest is not None and _checksum.fired(
                    fe.fault_corrupt_ingest):
                flat = _checksum.corrupt_array(flat)
            claim = self._param(query, _checksum.CRC_HEADER, "crc32c")
            digest = None
            body_crc = None
            if fe.cache is not None:
                # One scan, two checks: the BLAKE2b-160 cache key and
                # the CRC the integrity claim is validated against ride
                # the same pass over the staging buffer — arming the
                # cache never adds a second read of the body.
                digest, body_crc = _cache_digest.digest_and_crc(flat)
            if claim is not None and fe.cfg.integrity:
                err = _checksum.claim_error(claim, flat,
                                            computed=body_crc)
                if err is not None:
                    msg, mismatch = err
                    if mismatch:
                        fe.registry.counter(
                            "integrity_checksum_failures_total"
                        ).inc()
                    if release is not None:
                        release()
                    self._error(400, msg)
                    return
            shape = (h, w) if channels == 1 else (h, w, channels)
            img = flat.reshape(shape)
            # Ingest spend: arena lease + body read + CRC/digest scan.
            led.add_ingest(time.perf_counter() - t_ing)
            wait = (
                deadline_s + 5.0 if deadline_s
                else (fe.cfg.request_timeout_s + 5.0
                      if fe.cfg.request_timeout_s else _RESULT_TIMEOUT_S)
            )
            cache = fe.cache
            ckey = None
            token = 0
            is_leader = True
            fol_fut = None
            if cache is not None:
                # The full content key: body digest plus every knob
                # that reaches the kernel. Boundary is always zero at
                # this tier (validated above).
                ckey = cache.key(digest, fname or fe.cfg.filter_name,
                                 reps, h, w, channels, 0)
                with _obs_span("cache.lookup", "net"):
                    hit = cache.lookup(ckey)
                if hit is not None:
                    # Short-circuit BEFORE admission: no inflight-bytes
                    # reservation, no replica dispatch — the stored
                    # true bytes + stamp answer bit-identically to a
                    # cold compute.
                    if release is not None:
                        release()
                    fe.registry.histogram(
                        "request_latency_seconds"
                    ).observe(time.perf_counter() - t0)
                    led.set_source("cache")
                    # The hit's avoided spend: what the stored entry
                    # cost its producer to compute.
                    saved = hit.device_us / 1e6
                    led.saved_device_s = saved
                    if saved > 0:
                        fe.registry.counter(
                            "result_cache_saved_device_seconds_total"
                        ).inc(saved)
                    resp_headers = {
                        "X-Width": str(w), "X-Height": str(h),
                        "X-Channels": str(channels),
                        "X-Reps": str(reps),
                        "X-Replica": str(hit.replica),
                        "X-Cache": "hit",
                    }
                    if hit.stamp is not None:
                        resp_headers[_checksum.RESULT_HEADER] = hit.stamp
                    self._send_result(fe, hit.payload, resp_headers,
                                      ledger=led, bytes_in=expected)
                    return
                # Admission token BEFORE dispatch: any distrust of the
                # producing replica from here on (a witness verdict can
                # race this thread) refuses the later insert.
                token = cache.token()
                is_leader, fol_fut = cache.join(ckey)
                if not is_leader and release is not None:
                    # A follower's body is never dispatched — the
                    # leader's launch produces the shared bytes.
                    release()
            if not is_leader:
                try:
                    payload, stamp, idx = fol_fut.result(timeout=wait)
                except DeadlineExceeded as e:
                    self._error(504, str(e))
                    return
                except (TimeoutError, concurrent.futures.TimeoutError):
                    # THIS follower's budget expired; the leader and
                    # any patient followers keep flying — cancel
                    # nothing of theirs.
                    self._error(
                        504, f"request still pending after {wait:g}s"
                    )
                    return
                except QueueFull as e:
                    self._error(429, str(e), {
                        "Retry-After": str(
                            fe.router.retry_after_s(queue_full=True)
                        )
                    })
                    return
                except (Draining, Overloaded) as e:
                    self._error(503, str(e), {
                        "Retry-After": str(fe.router.retry_after_s())
                    })
                    return
                except (ServerClosed, WorkerCrashed) as e:
                    self._error(503, f"{type(e).__name__}: {e}", {
                        "Retry-After": str(fe.router.retry_after_s())
                    })
                    return
                except Exception as e:
                    self._error(500, f"{type(e).__name__}: {e}")
                    return
                fe.registry.histogram(
                    "request_latency_seconds"
                ).observe(time.perf_counter() - t0)
                # The single-flight follower rode the leader's compute:
                # its own device spend is zero by construction.
                led.set_source("coalesced")
                resp_headers = {
                    "X-Width": str(w), "X-Height": str(h),
                    "X-Channels": str(channels), "X-Reps": str(reps),
                    "X-Replica": str(idx), "X-Cache": "collapsed",
                }
                if stamp is not None:
                    resp_headers[_checksum.RESULT_HEADER] = stamp
                self._send_result(fe, payload, resp_headers,
                                  ledger=led, bytes_in=expected)
                return

            def settle(e: BaseException) -> None:
                # Leader failure: propagate the typed exception to
                # every follower and cache nothing.
                if cache is not None:
                    cache.fail(ckey, e)

            try:
                # owned=True: both ingest paths guarantee the buffer is
                # not reused before on_consumed (arena lease) or ever
                # (immutable bytes base) — the engine skips its
                # defensive copy.
                fut, idx = fe.router.submit(
                    img, reps, fname, deadline_s=deadline_s,
                    owned=True, on_consumed=release,
                )
            except Draining as e:
                settle(e)
                if release is not None:
                    release()
                self._error(503, str(e), {
                    "Retry-After": str(fe.router.retry_after_s())
                })
                return
            except Overloaded as e:
                settle(e)
                if release is not None:
                    release()
                self._error(503, str(e), {
                    "Retry-After": str(fe.router.retry_after_s())
                })
                return
            except QueueFull as e:
                settle(e)
                if release is not None:
                    release()
                self._error(429, str(e), {
                    "Retry-After": str(
                        fe.router.retry_after_s(queue_full=True)
                    )
                })
                return
            except ValueError as e:
                settle(e)
                if release is not None:
                    release()
                self._error(400, str(e))
                return
            if release is not None:
                # Failure paths that never reach the engine's consume
                # hook (deadline at batch formation, worker crash,
                # placement failure inside a coalesced group) release
                # via the future — idempotent next to on_consumed.
                fut.add_done_callback(lambda _f: release())
            try:
                out = fut.result(timeout=wait)
            except DeadlineExceeded as e:
                # (The serve engine already dumped this trace at its
                # batch-formation expiry — one anomaly, one dump.)
                settle(e)
                self._error(504, str(e))
                return
            except (TimeoutError, concurrent.futures.TimeoutError) as e:
                # (One name on 3.11+; two distinct classes before.)
                fut.cancel()
                settle(e)
                _obs_flight.trigger(
                    "deadline_exceeded", trace_id=ctx.trace_id,
                    tier="net", duration_s=time.perf_counter() - t0,
                    replica=-1 if idx is None else idx,
                    detail=f"still pending after {wait:g}s",
                )
                self._error(504,
                            f"request still pending after {wait:g}s")
                return
            except QueueFull as e:
                # A coalesced group's placement failure arrives through
                # the future (every replica rejected the whole group) —
                # the same typed 429 the synchronous path answers.
                settle(e)
                self._error(429, str(e), {
                    "Retry-After": str(
                        fe.router.retry_after_s(queue_full=True)
                    )
                })
                return
            except (Draining, Overloaded) as e:
                settle(e)
                self._error(503, str(e), {
                    "Retry-After": str(fe.router.retry_after_s())
                })
                return
            except (ServerClosed, WorkerCrashed) as e:
                settle(e)
                self._error(503, f"{type(e).__name__}: {e}", {
                    "Retry-After": str(fe.router.retry_after_s())
                })
                return
            except Exception as e:
                settle(e)
                self._error(500, f"{type(e).__name__}: {e}")
                return
            if idx is None:
                # Coalesced: the router stamped the placed replica onto
                # the future at group dispatch (before it resolved).
                idx = getattr(fut, "replica_idx", -1)
            elapsed = time.perf_counter() - t0
            fe.registry.histogram("request_latency_seconds").observe(
                elapsed
            )
            thr = fe.cfg.flight_latency_threshold_s
            if thr and elapsed > thr:
                # The p99-straggler trigger: the request SUCCEEDED but
                # anomalously slowly — dump its spans while they are
                # still in the ring.
                _obs_flight.trigger(
                    "slow_request", trace_id=ctx.trace_id, tier="net",
                    duration_s=elapsed, threshold_s=thr, replica=idx,
                )
            payload = np.ascontiguousarray(out).tobytes()
            resp_headers = {
                "X-Width": str(w), "X-Height": str(h),
                "X-Channels": str(channels), "X-Reps": str(reps),
                "X-Replica": str(idx),
            }
            stamp = None
            if fe.cfg.integrity:
                # Stamp the TRUE result's CRC, then let the wire-
                # corruption chaos site flip bits: a client (or the
                # federation forward path) verifying the stamp catches
                # exactly what the wire damaged.
                stamp = str(_checksum.crc32c(payload))
                resp_headers[_checksum.RESULT_HEADER] = stamp
            if cache is not None:
                # The store takes the pre-chaos-site bytes and the
                # stamp just served (distrust-fenced by the token);
                # followers resolve with the same triple. The entry
                # remembers its compute cost so a later hit can report
                # its avoided spend.
                cache.complete(ckey, payload, stamp, idx, token,
                               device_us=led.device_us)
                resp_headers["X-Cache"] = "miss"
            self._send_result(fe, payload, resp_headers,
                              ledger=led, bytes_in=expected)

    def _send_result(self, fe: "NetFrontend", payload: bytes,
                     resp_headers: Dict[str, str],
                     ledger: Optional[_obs_ledger.RequestLedger] = None,
                     bytes_in: int = 0) -> None:
        """The shared 200 tail for cold, hit, and collapsed responses:
        wire-corruption and mid-body-EOF chaos sites fire on all three
        alike, then the payload goes out — stamped with the request's
        cost headers. The tenant is metered only AFTER the write
        succeeded: a hedge loser whose fed-side socket already closed
        fails the write here, lands in the cancelled-spend counters
        instead, and is exactly how a hedged request that ran on two
        members never double-counts in tenant totals."""
        if ledger is not None:
            resp_headers = dict(resp_headers)
            resp_headers["X-Cost-Device-Us"] = str(ledger.device_us)
            resp_headers["X-Cost-Queue-Us"] = str(ledger.queue_us)
            resp_headers["X-Cost-Source"] = ledger.source
        if fe.fault_corrupt_body is not None and _checksum.fired(
                fe.fault_corrupt_body):
            payload = _checksum.corrupt_bytes(payload)
        if fe.fault_body is not None and self._body_fault(
            fe.fault_body, payload
        ):
            return  # injected mid-body EOF: truncated 200 written
        try:
            self._respond(
                200, payload,
                content_type="application/octet-stream",
                headers=resp_headers,
            )
        except OSError:
            # The client vanished before the 200 landed — the hedge
            # loser's signature. Its device spend really happened
            # (conservation keeps it), but no answer was delivered, so
            # it meters as cancelled, not as tenant goodput.
            self.close_connection = True
            fe.registry.counter("cancelled_responses_total").inc()
            if ledger is not None and ledger.device_s > 0:
                fe.registry.counter(
                    "cancelled_response_device_seconds_total"
                ).inc(ledger.device_s)
            return
        if ledger is not None:
            fe.tenants.record(ledger, bytes_in, len(payload))


class NetFrontend:
    """The whole network tier: fleet + router + threaded HTTP server.

    >>> fe = NetFrontend(NetConfig(port=0, replicas=2)).start()
    >>> ...  # POST frames at fe.url
    >>> fe.drain(); fe.close()
    """

    def __init__(self, cfg: NetConfig,
                 start_workers: bool = True,
                 devices: Optional[Sequence] = None) -> None:
        self.cfg = cfg
        self.registry = Registry()
        # Pre-create the latency histogram (otherwise born lazily on
        # the first 200): a scrape/statusz of a tier that has served
        # only errors must still carry the key the loadgen report and
        # dashboards read.
        self.registry.histogram("request_latency_seconds")
        # The replicas' devices (ReplicaFleet): ``devices`` when given
        # (one device may repeat), else every visible card.
        self.fleet = ReplicaFleet(cfg, registry=self.registry,
                                  start_workers=start_workers,
                                  devices=devices)
        # Zero-copy ingest staging pools (None = the buffered A/B arm).
        self.arena: Optional[StagingArena] = (
            StagingArena(self.registry) if cfg.ingest_arena else None
        )
        self.router: Optional[Router] = None
        self._httpd: Optional[_NetHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._drain_report: Optional[Dict[int, bool]] = None
        self._t_start = time.monotonic()
        # Set by POST /admin/drain (the SIGTERM-equivalent admin
        # path); the CLI main loop watches it next to the signal flag.
        self.admin_drain_requested = threading.Event()
        # Blur handlers between their first read and last write
        # (blur_in_progress), which close() lets finish.
        self._blurs = 0
        self._blurs_cond = threading.Condition()
        # The process-wide flight recorder, installed at start().
        self.flight = None
        # net.accept / net.body / corruption chaos sites, resolved once
        # at start().
        self.fault_accept = None
        self.fault_body = None
        self.fault_corrupt_ingest = None
        self.fault_corrupt_body = None
        # The quarantine state machine + its background re-verify
        # prober (integrity.quarantine): witness verdicts
        # from the replicas land on the board via the router; the
        # prober golden-checks quarantined replicas back to health.
        self.quarantine = QuarantineBoard(
            self.registry,
            quarantine_after=cfg.quarantine_after,
            window_s=cfg.quarantine_window_s,
            readmit_after=cfg.readmit_after,
        )
        self._prober: Optional[QuarantineProber] = None
        # The content-addressed result cache (cache),
        # default-off. Admission consults the quarantine board: a
        # currently-quarantined replica's results never enter.
        self.cache: Optional[ResultCache] = (
            ResultCache(self.registry, cfg.result_cache_bytes,
                        quarantined=self.quarantine.is_quarantined)
            if cfg.result_cache_mb > 0 else None
        )
        # The live telemetry plane (obs.timeseries / obs.slo), built at
        # start(): the sampler snapshots the merged registry on a fixed
        # interval and the SLO engine evaluates on its ticks.
        self.sampler: Optional[_obs_ts.Sampler] = None
        self.slo: Optional[_obs_slo.SloEngine] = None
        # The per-tenant billing/abuse table (obs.ledger) behind
        # GET /debug/tenants and the tenant_* registry family.
        self.tenants = _obs_ledger.TenantMeter(self.registry)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "NetFrontend":
        from tpu_stencil_torch.resilience import faults as _faults

        # The always-on flight recorder: every span this process
        # records from here on lands in the ring, and anomaly triggers
        # dump into the spool (obs.flight; idempotent per process).
        self.flight = _obs_flight.install(spool_dir=self.cfg.flightrec_dir)
        self.fault_accept = _faults.site("net.accept")
        self.fault_body = _faults.site("net.body")
        self.fault_corrupt_ingest = _faults.site("integrity.corrupt_ingest")
        self.fault_corrupt_body = _faults.site("net.corrupt_body")
        self.fleet.start()
        self.router = Router(
            self.fleet, self.registry,
            max_inflight_bytes=self.cfg.max_inflight_bytes,
            quarantine=self.quarantine,
            coalesce_window_s=self.cfg.coalesce_window_s,
            max_batch=self.cfg.max_batch,
            bucket_edges=self.cfg.bucket_edges,
            default_filter=self.cfg.filter_name,
            cache=self.cache,
        )
        if self.cfg.probe_interval_s > 0:
            self._prober = QuarantineProber(
                self.fleet, self.quarantine, self.cfg.filter_name,
                self.cfg.probe_interval_s, self.registry,
            ).start()
        if self.cfg.sample_interval_s > 0:
            self.sampler = _obs_ts.Sampler(
                self.metrics_snapshot, self.cfg.sample_interval_s
            )
            if self.cfg.slo_error_budget > 0:
                self.slo = _obs_slo.SloEngine(
                    _obs_slo.default_net_objectives(self.cfg),
                    self.registry, tier="net",
                    fast_window_s=self.cfg.slo_fast_window_s,
                    slow_window_s=self.cfg.slo_slow_window_s,
                    fast_burn=self.cfg.slo_fast_burn,
                    slow_burn=self.cfg.slo_slow_burn,
                )
                self.sampler.on_sample.append(self.slo.evaluate)
            self.sampler.start()
        self._httpd = _NetHTTPServer((self.cfg.host, self.cfg.port), self)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpu-stencil-torch-net-http", daemon=True,
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

    def begin_drain(self) -> None:
        """Stop admission + flip ``/healthz`` to draining (idempotent);
        the listener keeps answering so in-flight requests respond and
        probes observe the flip."""
        assert self.router is not None, "not started"
        self.router.begin_drain()

    def request_admin_drain(self) -> None:
        """The ``POST /admin/drain`` semantics: flip healthz + stop
        admission NOW, and raise the flag the CLI loop treats exactly
        like SIGTERM (full replica drain, rc discipline). Library
        embedders watch ``admin_drain_requested`` themselves."""
        self.begin_drain()
        self.admin_drain_requested.set()

    def drain(self, timeout_s: Optional[float] = None) -> Dict[int, bool]:
        """The SIGTERM sequence minus the process exit: stop admission,
        close every replica under the budget, report per replica
        drained-vs-abandoned. The HTTP listener stays up (``close()``
        stops it) so every accepted request gets its response."""
        self.begin_drain()
        report = self.fleet.drain(timeout_s)
        self._drain_report = report
        return report

    def close(self) -> None:
        """Stop the listener (drains first if nobody did)."""
        if self.sampler is not None:
            self.sampler.stop()
        if self._prober is not None:
            self._prober.stop()
            self._prober = None
        if self.router is not None and not self.router.draining:
            self.drain()
        if self.router is not None:
            self.router.shutdown()  # stop the coalescer timer thread
        # Every request the drain completed still has its response to
        # write on its handler thread (daemon threads, which a process
        # exit would cut mid-request): let them finish first.
        self._wait_blurs(self.cfg.drain_timeout_s)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    @contextlib.contextmanager
    def blur_in_progress(self):
        """Counts one ``POST /v1/blur`` handler from its first byte read
        to its last byte written (:meth:`close` waits for the count to
        reach zero)."""
        with self._blurs_cond:
            self._blurs += 1
        try:
            yield
        finally:
            with self._blurs_cond:
                self._blurs -= 1
                self._blurs_cond.notify_all()

    def _wait_blurs(self, timeout_s: float) -> bool:
        """Wait up to ``timeout_s`` for every blur handler to finish; True
        when none is left."""
        deadline = time.monotonic() + timeout_s
        with self._blurs_cond:
            while self._blurs:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._blurs_cond.wait(left)
        return True

    def __enter__(self) -> "NetFrontend":
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scrape surfaces -----------------------------------------------

    def debug_trace(self, trace_id: str) -> dict:
        """One trace's spans from this process (the flight ring plus
        the live tracer when ``--trace`` is on — the replicas are
        in-process, so one ring covers net → router → serve). The
        federation fans this lookup to its members for the
        cross-process tree."""
        spans = _obs_flight.local_trace_spans(trace_id)
        return {
            "schema_version": 1,
            "trace_id": trace_id,
            "span_count": len(spans),
            "processes": [{
                "source": "net",
                "span_count": len(spans),
                "spans": spans,
                "tree": _obs_flight.build_tree(spans),
            }] if spans else [],
        }

    def metrics_snapshot(self) -> dict:
        """The net registry with every replica's counters folded in as
        ``fleet_<name>`` — ONE snapshot under ONE prefix, so the
        exposition's exact parse round-trip holds for the whole scrape
        (per-replica histograms stay on ``/statusz``: reservoir merges
        are not well-defined, and faking one would lie to dashboards)."""
        snap = self.registry.snapshot()
        for k, v in sorted(self.fleet.merged_counters().items()):
            snap["counters"][f"fleet_{k}"] = v
        # "No silent caps": dumps the flight spool pruned past its cap
        # are a counter here (and on /statusz via the merged view), not
        # an invisible loss.
        snap["counters"]["flightrec_dropped_total"] = (
            _obs_flight.dropped_total()
        )
        snap["replicas"] = len(self.fleet)
        return snap

    def render_metrics(self) -> str:
        from tpu_stencil_torch.obs import exposition

        return exposition.render_text(
            self.metrics_snapshot(), prefix="tpu_stencil_net"
        )

    def timeseries_payload(self, window_s: float) -> dict:
        """The ``GET /debug/timeseries`` body: windowed deltas/rates
        from the sampler's ring, stamped with the source tier and the
        SLO engine's live view (when enabled)."""
        assert self.sampler is not None, "sampler is off"
        payload = self.sampler.ring.window(window_s)
        payload["source"] = "net"
        payload["slo"] = None if self.slo is None else self.slo.statusz()
        return payload

    def tenants_payload(self) -> dict:
        """The ``GET /debug/tenants`` body: the metering table plus the
        source tier stamp the fed merge keys on."""
        return {
            "schema_version": 1,
            "source": "net",
            "tenants": self.tenants.snapshot(),
        }

    def capacity_payload(self, window_s: float) -> dict:
        """The ``GET /debug/capacity`` body: the Retry-After math run
        FORWARD — instead of "how long should a rejected client wait",
        "how much more load fits". Static terms (backlog, slots, busy
        fractions) always answer; windowed terms (achieved rps, arrival
        trend, bandwidth-vs-roofline) need the sampler ring and degrade
        to None when it is off — absent, never fabricated. The roofline is
        the H100 SXM's host link (PCIe Gen5 x16, 64 GB/s a direction, the
        data sheet's: ``roofline.H100_PCIE_BYTES_PER_S``)."""
        assert self.router is not None, "not started"
        from tpu_stencil_torch.runtime.roofline import H100_PCIE_BYTES_PER_S

        link_gbps = H100_PCIE_BYTES_PER_S / 1e9

        terms = self.router.retry_terms()
        outstanding = self.router.outstanding()
        max_batch = max(1, self.cfg.max_batch)
        per_replica = {
            str(k): {
                "outstanding": v,
                "busy_fraction": min(1.0, v / max_batch),
            }
            for k, v in outstanding.items()
        }
        payload = {
            "schema_version": 1,
            "source": "net",
            "window_s": float(window_s),
            "retry_after": terms,
            "utilization": {
                "slot_fraction": min(
                    1.0, terms["backlog"] / terms["slots"]
                ),
                "busy_replicas": sum(
                    1 for v in outstanding.values() if v > 0
                ),
            },
            "per_replica": per_replica,
            "service_rate_rps": terms["service_rate_rps"],
            "achieved_rps": None,
            "headroom_rps": None,
            "time_to_saturation_s": None,
            "bandwidth": {
                "achieved_gbps": None,
                "roofline_gbps": link_gbps,
                "roofline_fraction": None,
            },
            "stale": False,
        }
        if self.sampler is None:
            return payload
        win = self.sampler.ring.window(window_s)
        lat = win["histograms"].get("request_latency_seconds")
        if lat is None or win["span_s"] <= 0:
            return payload
        achieved = lat["rate_per_s"]
        payload["achieved_rps"] = achieved
        svc = terms["service_rate_rps"]
        if svc is not None:
            payload["headroom_rps"] = max(0.0, svc - achieved)
            # Arrival trend: the recent half-window's rate against the
            # full window's — a positive slope projects when the
            # headroom runs out at the current ramp.
            half = self.sampler.ring.window(window_s / 2.0)
            hlat = half["histograms"].get("request_latency_seconds")
            if hlat is not None and half["span_s"] > 0:
                slope = (hlat["rate_per_s"] - achieved) / max(
                    window_s / 2.0, 1e-9
                )
                if payload["headroom_rps"] <= 0:
                    payload["time_to_saturation_s"] = 0.0
                elif slope > 0:
                    payload["time_to_saturation_s"] = (
                        payload["headroom_rps"] / slope
                    )
        # Achieved-vs-roofline GB/s from the ledger aggregates: bytes
        # moved across the host<->device hop per second of device time
        # actually spent in the window.
        ctr = win["counters"]
        moved = (ctr.get("fleet_h2d_bytes_total", {}).get("delta", 0)
                 + ctr.get("fleet_d2h_bytes_total", {}).get("delta", 0))
        spent = (
            ctr.get("fleet_goodput_device_seconds_total",
                    {}).get("delta", 0.0)
            + ctr.get("fleet_overhead_device_seconds_total",
                      {}).get("delta", 0.0)
        )
        if moved > 0 and spent > 0:
            gbps = moved / spent / 1e9
            payload["bandwidth"]["achieved_gbps"] = gbps
            payload["bandwidth"]["roofline_fraction"] = (
                gbps / link_gbps
            )
        return payload

    def statusz(self) -> dict:
        assert self.router is not None, "not started"
        return {
            "schema_version": STATUS_SCHEMA_VERSION,
            "ts": time.monotonic(),
            "uptime_s": time.monotonic() - self._t_start,
            "draining": self.router.draining,
            "replicas": len(self.fleet),
            "outstanding": {
                str(k): v for k, v in self.router.outstanding().items()
            },
            "quarantine": self.quarantine.statusz(),
            "cache": None if self.cache is None else self.cache.stats(),
            "slo": None if self.slo is None else self.slo.statusz(),
            "timeseries": None if self.sampler is None else {
                "interval_s": self.sampler.interval_s,
                "samples": len(self.sampler.ring),
            },
            "flightrec_dropped_total": _obs_flight.dropped_total(),
            # The Retry-After derivation's named terms: the opaque
            # integer a backpressured client sees
            # is auditable against the state that produced it.
            "retry_after": self.router.retry_terms(),
            "drain_report": (
                None if self._drain_report is None
                else {str(k): v for k, v in self._drain_report.items()}
            ),
            # The merged view (net registry + fleet_<name> counter
            # fold-in): the same snapshot /metrics renders, so a JSON
            # consumer and a scraper read identical numbers.
            "net": self.metrics_snapshot(),
            "per_replica": self.fleet.stats(),
            "config": {
                "replicas": self.cfg.replicas,
                "max_queue": self.cfg.max_queue,
                "max_batch": self.cfg.max_batch,
                "coalesce_window_us": self.cfg.coalesce_window_us,
                "ingest_arena": self.cfg.ingest_arena,
                "result_cache_mb": self.cfg.result_cache_mb,
                "max_inflight_mb": self.cfg.max_inflight_mb,
                "request_timeout_s": self.cfg.request_timeout_s,
                "drain_timeout_s": self.cfg.drain_timeout_s,
                "warm_fleet": self.cfg.warm_fleet,
                "backend": self.cfg.backend,
                "filter": self.cfg.filter_name,
                "integrity": self.cfg.integrity,
                "witness_rate": self.cfg.witness_rate,
                "quarantine_after": self.cfg.quarantine_after,
                "readmit_after": self.cfg.readmit_after,
                "flightrec_dir": _obs_flight.effective_spool(
                    self.cfg.flightrec_dir
                ),
                "flight_latency_threshold_s":
                    self.cfg.flight_latency_threshold_s,
                "sample_interval_s": self.cfg.sample_interval_s,
                "slo_error_budget": self.cfg.slo_error_budget,
                "prof_dir": self.cfg.prof_dir,
            },
        }
