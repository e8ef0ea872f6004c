"""Federation routing: placement, hedged forwarding, typed verdicts,
federation-scope admission with per-tenant quotas (the port's copy of the
JAX package's ``fed/router.py``).

The net tier's router places requests on in-process replicas; this one
places them on *member hosts* over HTTP, where every failure mode of a
distributed system is on the table. Robustness is the organizing
principle, not a bolt-on:

**Verdict taxonomy** (the transient/permanent classifier of
:mod:`~tpu_stencil_torch.resilience.retry` extended one hop). Each
forward attempt resolves to exactly one verdict, and each verdict has its
own consequence:

=================  ==============================  =====================
verdict            evidence                        consequence
=================  ==============================  =====================
``ok``             HTTP 200                        respond; breaker closes
``draining``       503 + "draining" body           member → draining, reroute
``shed``           other 503                       backpressure: reroute,
                                                   else 503 + Retry-After
``queue_full``     429                             backpressure: reroute,
                                                   else 429 + Retry-After
``deadline``       504                             DeadlineExceeded to the
                                                   client (permanent: the
                                                   request's budget burned)
``client_error``   other 4xx                       pass through verbatim
                                                   (deterministic — every
                                                   member answers the same)
``http_5xx``       500/502/...                     breaker counts, reroute
``connect``        refused/unreachable             breaker counts, reroute
``reset``          connection reset / no status    breaker counts, reroute
``eof``            mid-body EOF (IncompleteRead)   breaker counts, reroute
                                                   (the body never arrived,
                                                   so a re-send is safe —
                                                   the compute is pure)
``timeout``        socket timeout                  breaker counts, reroute
``injected``       armed ``fed.forward`` fault     breaker counts, reroute
``bad_payload``    200 whose body fails its        breaker counts, reroute
                   ``X-Result-Crc32c`` stamp or    (wrong bytes with a 200:
                   declared geometry length        a garbage-returning
                                                   member is ejected as
                                                   surely as a dead one)
=================  ==============================  =====================

**Hedged requests.** A forward still pending past the observed p99
forward latency (``forward_latency_seconds``, floored by
``hedge_min_s``) fires ONE hedge at the next least-outstanding
breaker-allowed member. First full response wins; the loser is
cancelled typed (its socket closed, ``hedge_cancelled_total``) — never
abandoned to run its course against a host we no longer care about. A
member whose first forward pays its cold start (program build, pinned
slots, the kernel library's load) can outlive the trigger, so the same
request may then run on two members: callers that count kernel launches
through the federation turn hedging off (``FedConfig.hedge``).

**Federation-scope admission**, the net tier's three-layer ladder one
hop up, applied BEFORE any forward: drain gate (503), inflight-bytes shed
(503 + Retry-After; premium tenants get 25% headroom past the standard
watermark), and per-tenant outstanding quotas keyed on the
``X-Tenant`` header (:class:`TenantQuotaExceeded` → 429 +
Retry-After) — one hot client degrades to *its* quota, never the
fleet.

All-member backpressure re-offers under the shared
:func:`~tpu_stencil_torch.resilience.retry.reoffer_call` contract for
``reoffer_s`` before the typed rejection surfaces.
"""

from __future__ import annotations

import collections
import http.client
import json
import math
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from tpu_stencil_torch.cache import affinity as _affinity
from tpu_stencil_torch.config import FedConfig
from tpu_stencil_torch.fed.breaker import BreakerBoard
from tpu_stencil_torch.fed.membership import Member, Membership
from tpu_stencil_torch.net.router import Draining, Overloaded
from tpu_stencil_torch.obs import context as _obs_ctx
from tpu_stencil_torch.obs import events as _obs_events
from tpu_stencil_torch.obs import ledger as _obs_ledger
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.resilience.errors import (
    DeadlineExceeded,
    HostUnavailable,
    InjectedFault,
)
from tpu_stencil_torch.serve.engine import QueueFull
from tpu_stencil_torch.serve.metrics import Registry

#: Premium tenants keep being admitted past the standard shed watermark
#: up to this factor — the two-priority-class degradation order: under
#: byte pressure, standard traffic sheds first.
PREMIUM_HEADROOM = 1.25

#: The tenant a request without an X-Tenant header is accounted to.
DEFAULT_TENANT = "anon"

#: Per-host forward-latency reservoir depth (hedge-trigger feed): deep
#: enough that a p99 over a few hosts is meaningful, bounded so a
#: long-lived router forgets ancient latency regimes on its own.
_FWD_RESERVOIR = 512


class TenantQuotaExceeded(RuntimeError):
    """This tenant is at its outstanding-request quota. Transient for
    the tenant (its own completions free quota), invisible to everyone
    else — the frontend answers 429 + Retry-After."""


class BadPayload(RuntimeError):
    """A member answered 200 but the body is provably wrong: it fails
    its own ``X-Result-Crc32c`` stamp, or its length contradicts the
    geometry it declares. The one failure mode a health check cannot
    see — treated as a transport-level forward failure
    (``bad_payload`` verdict): the breaker counts it, the request
    reroutes to a sibling (the compute is pure, a re-send is safe),
    and a member returning garbage consistently is breaker-ejected as
    surely as a dead one."""


def _verdict_exc(e: BaseException) -> str:
    """Classify a transport-level forward failure (module docstring
    table). Every one of these counts against the member's breaker."""
    if isinstance(e, InjectedFault):
        return "injected"
    if isinstance(e, BadPayload):
        return "bad_payload"
    if isinstance(e, TimeoutError):  # socket.timeout is an alias
        return "timeout"
    if isinstance(e, ConnectionRefusedError):
        return "connect"
    if isinstance(e, http.client.IncompleteRead):
        return "eof"
    if isinstance(e, (ConnectionResetError, BrokenPipeError,
                      http.client.RemoteDisconnected,
                      http.client.BadStatusLine)):
        return "reset"
    if isinstance(e, OSError):
        return "connect"  # unreachable/DNS/route: never got a byte back
    return "error"


def _error_type(body: bytes) -> str:
    """`` (TypeName)`` for a member's typed error body (the net tier's
    JSON ``{"error": "TypeName: detail", ...}``), else ``""``."""
    try:
        msg = json.loads(body)["error"]
    except (ValueError, KeyError, TypeError):
        return ""
    name = str(msg).split(":", 1)[0]
    return f" ({name})" if name.isidentifier() else ""


class _Attempt:
    """One forward attempt against one member, run on its own thread
    so the race loop can hedge and cancel. The thread owns ALL
    bookkeeping for its attempt (outstanding, breaker, verdict
    counters) — a cancelled loser whose result nobody reads still
    settles its accounts."""

    def __init__(self, router: "FedRouter", member: Member,
                 body: bytes, headers: Dict[str, str],
                 is_hedge: bool = False) -> None:
        self.router = router
        self.member = member
        self.body = body
        # Trace propagation: attempts are constructed on the handler
        # thread where the request's context is bound — each attempt
        # (first, reroute, hedge leg) forwards the ONE trace id with
        # its OWN freshly-minted span id, so the member's spans name
        # which leg they served.
        self._ctx = _obs_ctx.current()
        if self._ctx is not None:
            headers = dict(headers)
            headers.update(_obs_ctx.headers_for(
                self._ctx, span_id=_obs_ctx.new_span_id()
            ))
        self.headers = headers
        self.is_hedge = is_hedge
        self.cancelled = False
        self.elapsed: Optional[float] = None
        self._conn: Optional[http.client.HTTPConnection] = None

    def start(self, results: "queue.Queue") -> None:
        threading.Thread(
            target=self._run_into, args=(results,),
            name=f"tpu-stencil-torch-fed-fwd-{self.member.host_id}",
            daemon=True,
        ).start()

    def cancel(self) -> None:
        """Typed cancellation of a racing loser: closing the socket
        from here makes the attempt thread's in-flight read fail
        immediately — the member may finish the compute, but no one
        waits on it."""
        self.cancelled = True
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def _run(self) -> Tuple[int, Dict[str, str], bytes]:
        u = urlsplit(self.member.url)
        conn_cls = (http.client.HTTPSConnection if u.scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(
            u.hostname, u.port, timeout=self.router.cfg.forward_timeout_s
        )
        self._conn = conn
        try:
            conn.request("POST", "/v1/blur", body=self.body,
                         headers=self.headers)
            resp = conn.getresponse()
            data = resp.read()  # mid-body EOF raises IncompleteRead
            rh = {k.lower(): v for k, v in resp.getheaders()}
            if resp.status == 200:
                self._verify_payload(rh, data)
            return resp.status, rh, data
        finally:
            conn.close()

    def _verify_payload(self, rh: Dict[str, str], data: bytes) -> None:
        """The forward hop's own integrity check on a member 200: the
        body must match its ``X-Result-Crc32c`` stamp and the length
        its declared geometry implies. Raises :class:`BadPayload` —
        wrong bytes never reach the client just because they arrived
        with a happy status code. (A member with integrity disabled
        stamps nothing; absence is not a failure — the hop then only
        has the length to go on.)"""
        from tpu_stencil_torch.integrity import checksum as _checksum

        stamp = rh.get(_checksum.RESULT_HEADER.lower())
        if stamp is not None:
            try:
                want = _checksum.parse_crc(stamp, _checksum.RESULT_HEADER)
            except ValueError as e:
                raise BadPayload(str(e)) from None
            got = _checksum.crc32c(data)
            if got != want:
                raise BadPayload(
                    f"member 200 body crc32c {got} != stamped {want}"
                )
        try:
            w = int(rh["x-width"])
            h = int(rh["x-height"])
            c = int(rh.get("x-channels", "1"))
        except (KeyError, ValueError):
            return  # no declared geometry to check against
        if len(data) != w * h * c:
            raise BadPayload(
                f"member 200 body is {len(data)} bytes but declares "
                f"{w}x{h}x{c} = {w * h * c}"
            )

    def _run_into(self, results: "queue.Queue") -> None:
        # Re-bind the request's context on THIS thread (contextvars do
        # not cross thread starts): breaker transitions and spans
        # below inherit the trace id; bind(None) guards against a
        # stale context from any thread reuse.
        with _obs_ctx.bind(self._ctx):
            self._run_into_bound(results)

    def _run_into_bound(self, results: "queue.Queue") -> None:
        r = self.router
        hid = self.member.host_id
        r._track_launch(hid)
        t0 = time.monotonic()
        try:
            if r._fault_forward is not None:
                r._fault_forward()
            kind, payload = "resp", self._run()
        except BaseException as e:
            kind, payload = "exc", (_verdict_exc(e), e)
        finally:
            self.elapsed = time.monotonic() - t0
            r._track_done(hid)
        if self.cancelled:
            # Our own cancellation is not evidence about the host:
            # release any half-open probe slot, record nothing.
            r.breakers.get(hid).release_probe()
            r.registry.counter("hedge_cancelled_total").inc()
            r.registry.counter("hedge_cancelled_seconds_total").inc(
                self.elapsed
            )
            if kind == "resp" and payload[0] == 200:
                # The loser's 200 was fully written before the cancel
                # landed: the member's meter billed a response nobody
                # received. Note it (with the member's own cost stamp)
                # so the fed /debug/tenants merge can reconcile — the
                # no-double-count guarantee for hedged requests.
                rh = payload[1]
                tenant = _obs_ledger.sanitize_tenant(
                    self.headers.get("X-Tenant")
                )
                try:
                    dev_us = int(rh.get("x-cost-device-us") or 0)
                except ValueError:
                    dev_us = 0
                r._note_hedge_discard(hid, tenant, dev_us)
        elif kind == "resp":
            status = payload[0]
            if status >= 500 and status not in (503, 504):
                # 500/502/...: the host answered, but brokenly.
                r.breakers.record_failure(hid)
                r.registry.counter("forward_http_5xx_total").inc()
            else:
                # ANY coherent response (200, 4xx, 503, 504) proves
                # the host alive — the breaker's question, not the
                # request's.
                r.breakers.record_success(hid)
        else:
            r.breakers.record_failure(hid)
            r.registry.counter(f"forward_{payload[0]}_total").inc()
            # One event line per failed forward attempt: the verdict
            # taxonomy name, the leg (hedge or primary), the host —
            # grep the trace id, read the request's whole post-mortem.
            _obs_events.emit(
                "fed.forward",
                trace_id=self._ctx.trace_id if self._ctx else "",
                tier="fed", verdict=payload[0],
                duration_s=self.elapsed, host=hid,
                hedge=self.is_hedge,
            )
        results.put((self.member, self, kind, payload))


class FedRouter:
    """Admission + placement + the hedged forward race."""

    def __init__(self, cfg: FedConfig, membership: Membership,
                 breakers: BreakerBoard, registry: Registry) -> None:
        self.cfg = cfg
        self.membership = membership
        self.breakers = breakers
        self.registry = registry
        self._lock = threading.Lock()
        self._draining = False
        self._inflight_bytes = 0
        self._tenants: Dict[str, int] = {}
        self._host_outstanding: Dict[str, int] = {}
        self._premium = frozenset(cfg.premium_tenants)
        self._fault_forward = None  # resolved at start()
        self._fault_hedge = None
        m = registry
        self._m_requests = m.counter("requests_total")
        self._m_forwarded = m.counter("forwarded_total")
        self._m_rejected = m.counter("rejected_total")
        self._m_shed = m.counter("shed_total")
        self._m_tenant_rej = m.counter("tenant_quota_rejections_total")
        self._m_reroutes = m.counter("reroutes_total")
        self._m_drain_reroutes = m.counter("draining_reroutes_total")
        self._m_hedges = m.counter("hedges_total")
        self._m_hedge_wins = m.counter("hedge_wins_total")
        m.counter("hedge_cancelled_total")
        # Wall time burned by cancelled hedge losers — non-goodput
        # spend the cost plane keeps visible (the member's own
        # cancelled_response_* counters carry the device-time half).
        m.counter("hedge_cancelled_seconds_total")
        # Cumulative per-tenant admission ledger (bounded like the
        # obs.ledger tenant table) — the quota machinery has enforced
        # blind until now; /debug/tenants reads this back.
        self._tenant_admitted: Dict[str, int] = {}
        self._tenant_rejected: Dict[str, int] = {}
        # (host_id, tenant) -> the hedge-loser 200s that member wrote
        # but the race discarded; /debug/tenants subtracts them.
        self._hedge_discards: Dict[tuple, dict] = {}
        m.counter("hedge_discarded_200_total")
        self._m_affinity = m.counter("affinity_routed_total")
        self._m_inflight = m.gauge("inflight_bytes")
        self._g_tenants = m.gauge("tenants_active")
        self._h_fwd = m.histogram("forward_latency_seconds")
        # Per-host forward-latency reservoirs feeding the hedge
        # trigger. The GLOBAL forward_latency_seconds histogram stays
        # the metric surface (monotonic by contract), but it cannot
        # forget ONE host's samples — and a host that re-registers
        # after dying must not poison the p99 with its predecessor's
        # death throes. reset_host() drops exactly one reservoir.
        self._host_fwd: Dict[str, "collections.deque"] = {}
        m.histogram("request_bytes")
        m.gauge("draining").set(0)

    def start(self) -> "FedRouter":
        from tpu_stencil_torch.resilience import faults as _faults

        self._fault_forward = _faults.site("fed.forward")
        self._fault_hedge = _faults.site("fed.hedge")
        return self

    # -- drain gate ----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        with self._lock:
            was = self._draining
            self._draining = True
        self.registry.gauge("draining").set(1)
        if not was:  # tier-transition event, once per flip
            _obs_events.emit("fed.drain_begin", tier="fed",
                             verdict="draining")

    # -- admission (the net tier's ladder, one hop up) -----------------

    def _admit(self, tenant: str, nbytes: int) -> Callable[[], None]:
        """Drain gate → byte shed (premium headroom) → tenant quota.
        Returns the release callable; raises typed on rejection."""
        premium = tenant in self._premium
        quota = self.cfg.tenant_quota * (
            self.cfg.premium_quota_factor if premium else 1
        )
        with self._lock:
            if self._draining:
                raise Draining(
                    "draining: federation admission stopped; retry "
                    "against another front router"
                )
            watermark = self.cfg.max_inflight_bytes
            if watermark:
                limit = (
                    int(watermark * PREMIUM_HEADROOM) if premium
                    else watermark
                )
                if self._inflight_bytes + nbytes > limit:
                    self._m_shed.inc()
                    raise Overloaded(
                        f"shedding: {self._inflight_bytes + nbytes} "
                        f"in-flight bytes would exceed the {limit} "
                        f"federation watermark"
                        f"{' (standard class)' if not premium else ''}; "
                        f"retry later"
                    )
            cur = self._tenants.get(tenant, 0)
            if cur >= quota:
                self._m_tenant_rej.inc()
                self._m_rejected.inc()
                key = self._stat_key_locked(tenant)
                self._tenant_rejected[key] = (
                    self._tenant_rejected.get(key, 0) + 1
                )
                raise TenantQuotaExceeded(
                    f"tenant {tenant!r} is at its quota of {quota} "
                    f"outstanding requests "
                    f"({'premium' if premium else 'standard'} class); "
                    f"its own completions free slots — other tenants "
                    f"are unaffected"
                )
            self._tenants[tenant] = cur + 1
            key = self._stat_key_locked(tenant)
            self._tenant_admitted[key] = (
                self._tenant_admitted.get(key, 0) + 1
            )
            self._inflight_bytes += nbytes
            inflight, ntenants = self._inflight_bytes, len(self._tenants)
        self._m_inflight.set(inflight)
        self._g_tenants.set(ntenants)

        def release() -> None:
            with self._lock:
                self._tenants[tenant] -= 1
                if self._tenants[tenant] <= 0:
                    del self._tenants[tenant]
                self._inflight_bytes -= nbytes
                left, nt = self._inflight_bytes, len(self._tenants)
            self._m_inflight.set(left)
            self._g_tenants.set(nt)

        return release

    # -- placement -----------------------------------------------------

    def _track_launch(self, host_id: str) -> None:
        with self._lock:
            self._host_outstanding[host_id] = (
                self._host_outstanding.get(host_id, 0) + 1
            )
            depth = self._host_outstanding[host_id]
        self.registry.gauge(f"member_outstanding_{host_id}").set(depth)

    def _track_done(self, host_id: str) -> None:
        with self._lock:
            self._host_outstanding[host_id] -= 1
            depth = self._host_outstanding[host_id]
        self.registry.gauge(f"member_outstanding_{host_id}").set(depth)

    def _note_hedge_discard(self, host_id: str, tenant: str,
                            device_us: int) -> None:
        """A cancelled hedge loser whose 200 was fully written: the
        member billed it, nobody received it. Keyed by host so the
        merge only reconciles against members it actually folded."""
        with self._lock:
            row = self._hedge_discards.setdefault(
                (host_id, tenant), {"requests": 0, "device_seconds": 0.0}
            )
            row["requests"] += 1
            row["device_seconds"] += device_us / 1e6
        self.registry.counter("hedge_discarded_200_total").inc()

    def hedge_discards(self, host_ids=None) -> Dict[str, dict]:
        """Per-tenant discarded-hedge-200 totals, restricted to
        ``host_ids`` when given (the merge passes its fresh set)."""
        with self._lock:
            items = list(self._hedge_discards.items())
        out: Dict[str, dict] = {}
        for (hid, tenant), row in items:
            if host_ids is not None and hid not in host_ids:
                continue
            agg = out.setdefault(
                tenant, {"requests": 0, "device_seconds": 0.0}
            )
            agg["requests"] += row["requests"]
            agg["device_seconds"] += row["device_seconds"]
        return out

    def outstanding(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._host_outstanding)

    def tenants(self) -> Dict[str, int]:
        """Current outstanding requests per active tenant (empty
        entries are dropped on release, so the table is bounded by
        concurrency, not tenant cardinality)."""
        with self._lock:
            return dict(self._tenants)

    def _stat_key_locked(self, tenant: str) -> str:
        """The cumulative-stats key for a wire tenant name: sanitized,
        and folded into the overflow bucket past the cardinality cap
        (the obs.ledger discipline — a hostile client must not mint
        unbounded table rows)."""
        t = _obs_ledger.sanitize_tenant(tenant)
        if (t not in self._tenant_admitted
                and t not in self._tenant_rejected
                and len(self._tenant_admitted)
                + len(self._tenant_rejected) >= _obs_ledger.TENANT_CAP):
            return _obs_ledger.OVERFLOW_TENANT
        return t

    def tenant_stats(self) -> Dict[str, dict]:
        """The fed-local half of ``/debug/tenants``: per tenant, live
        quota utilization (outstanding / quota for its class) plus the
        cumulative admitted/quota-rejected counts since start."""
        with self._lock:
            raw_outstanding = dict(self._tenants)
            admitted = dict(self._tenant_admitted)
            rejected = dict(self._tenant_rejected)
        # Outstanding is keyed on the raw wire name (the quota table's
        # vocabulary); fold through the same sanitizer so one tenant is
        # one row here.
        outstanding: Dict[str, int] = {}
        for t, v in raw_outstanding.items():
            key = _obs_ledger.sanitize_tenant(t)
            outstanding[key] = outstanding.get(key, 0) + v
        premium_set = {_obs_ledger.sanitize_tenant(p)
                       for p in self._premium}
        out: Dict[str, dict] = {}
        for t in sorted(set(outstanding) | set(admitted) | set(rejected)):
            premium = t in premium_set
            quota = self.cfg.tenant_quota * (
                self.cfg.premium_quota_factor if premium else 1
            )
            cur = outstanding.get(t, 0)
            out[t] = {
                "outstanding": cur,
                "quota": quota,
                "quota_utilization": (cur / quota) if quota else None,
                "premium": premium,
                "admitted_total": admitted.get(t, 0),
                "quota_rejected_total": rejected.get(t, 0),
            }
        return out

    def _candidates(self, digest: Optional[bytes] = None) -> List[Member]:
        """Routable members in placement order: healthy before suspect
        (membership's contract). Within the healthy class a content
        ``digest`` places by rendezvous hash — identical frames land on
        the same member, so each member's result cache sees the whole
        repeat stream for its share of the keyspace instead of 1/N of
        it. Without a digest (affinity off, or nothing healthy) the
        order is least-outstanding first, host_id as the tie-break —
        and the suspect class always stays least-outstanding (affinity
        must not pin traffic to a wobbling host). Breaker admission
        happens at launch time (:meth:`_next_allowed`) so half-open
        probe slots are only consumed by attempts that actually
        launch; membership churn degrades affinity gracefully — a
        rendezvous hash moves only the keys owned by the departed
        member."""
        members = self.membership.routable()
        with self._lock:
            out = dict(self._host_outstanding)
        # routable() returns healthy-then-suspect; a stable sort on
        # outstanding preserves that class order on ties but must not
        # interleave classes — sort each class independently.
        healthy = [m for m in members if m.state == "healthy"]
        suspect = [m for m in members if m.state != "healthy"]
        key = lambda m: (out.get(m.host_id, 0), m.host_id)  # noqa: E731
        if digest is not None and healthy:
            rank = {
                hid: i for i, hid in enumerate(_affinity.rendezvous_order(
                    [m.host_id for m in healthy], digest
                ))
            }
            healthy = sorted(healthy, key=lambda m: rank[m.host_id])
            self._m_affinity.inc()
        else:
            healthy = sorted(healthy, key=key)
        return healthy + sorted(suspect, key=key)

    def _next_allowed(self, it) -> Optional[Member]:
        for m in it:
            if self.breakers.get(m.host_id).allow():
                return m
        return None

    def _observe_forward(self, host_id: str, elapsed: float) -> None:
        """One winning forward's latency: into the global histogram
        (the metric surface) AND the winner's bounded per-host
        reservoir (the hedge-trigger feed)."""
        self._h_fwd.observe(elapsed)
        with self._lock:
            d = self._host_fwd.get(host_id)
            if d is None:
                d = self._host_fwd[host_id] = collections.deque(
                    maxlen=_FWD_RESERVOIR
                )
            d.append(elapsed)

    def reset_host(self, host_id: str) -> None:
        """Forget one host's learned forward-latency reservoir — the
        re-registration reset: a fresh process on a reused netloc must
        not inherit the dead one's tail in the hedge p99 (its breaker
        is dropped by the same hook; see FedFrontend)."""
        with self._lock:
            self._host_fwd.pop(host_id, None)

    def _hedge_after(self) -> float:
        """The hedge trigger: the observed p99 forward latency over
        the LIVE per-host reservoirs (nearest-rank, matching the
        histogram's percentile), floored by ``hedge_min_s`` (empty
        reservoirs read 0.0, so the floor carries the cold start)."""
        with self._lock:
            samples = [s for d in self._host_fwd.values() for s in d]
        if not samples:
            return self.cfg.hedge_min_s
        samples.sort()
        idx = max(0, math.ceil(0.99 * len(samples)) - 1)
        return max(self.cfg.hedge_min_s, samples[idx])

    # -- the forward race ----------------------------------------------

    def submit(self, body: bytes, headers: Dict[str, str], nbytes: int,
               tenant: str = DEFAULT_TENANT,
               digest: Optional[bytes] = None,
               ) -> Tuple[int, Dict[str, str], bytes, str, bool]:
        """Admit + forward one request; returns ``(status,
        response_headers, response_body, member_host_id, hedged)``.
        ``digest`` (the request body's content digest, when the
        frontend computed one) turns placement into rendezvous-hash
        affinity so identical frames revisit the same member's result
        cache. Raises :class:`~tpu_stencil_torch.net.router.Draining` /
        :class:`~tpu_stencil_torch.net.router.Overloaded` /
        :class:`TenantQuotaExceeded` /
        :class:`~tpu_stencil_torch.serve.engine.QueueFull` /
        :class:`~tpu_stencil_torch.resilience.errors.HostUnavailable` /
        :class:`~tpu_stencil_torch.resilience.errors.DeadlineExceeded` —
        each mapped to its own HTTP status by the frontend."""
        release = self._admit(tenant, nbytes)
        try:
            self._m_requests.inc()
            # The frame itself, not the caller's 2x request+response
            # admission accounting in nbytes.
            self.registry.histogram("request_bytes").observe(len(body))
            if self.cfg.reoffer_s > 0:
                from tpu_stencil_torch.resilience import retry as _retry

                try:
                    return _retry.reoffer_call(
                        lambda: self._forward(body, headers, digest),
                        give_up_after_s=self.cfg.reoffer_s,
                        base_delay=0.01, max_delay=0.1,
                        label="fed.forward",
                    )
                except TimeoutError as te:
                    # Surface the LAST typed rejection, not the
                    # give-up wrapper — the client needs the real
                    # status (429 vs 503) and its Retry-After.
                    if te.__cause__ is not None:
                        raise te.__cause__ from None
                    raise
            return self._forward(body, headers, digest)
        finally:
            release()

    def _forward(self, body: bytes, headers: Dict[str, str],
                 digest: Optional[bytes] = None,
                 ) -> Tuple[int, Dict[str, str], bytes, str, bool]:
        cands = self._candidates(digest)
        if not cands:
            raise HostUnavailable(
                "no routable member host (every member is draining, "
                "evicted, or unregistered)"
            )
        it = iter(cands)
        first = self._next_allowed(it)
        if first is None:
            raise HostUnavailable(
                f"every routable member's circuit breaker is open "
                f"({len(cands)} member(s) failing)"
            )
        results: "queue.Queue" = queue.Queue()
        active: Dict[str, _Attempt] = {}
        backpressure: List[Tuple[int, Optional[str]]] = []
        failures: List[Tuple[str, str]] = []

        def launch(m: Member, is_hedge: bool = False) -> None:
            att = _Attempt(self, m, body, headers, is_hedge=is_hedge)
            active[m.host_id] = att
            att.start(results)

        def reroute() -> bool:
            nxt = self._next_allowed(it)
            if nxt is None:
                return False
            self._m_reroutes.inc()
            launch(nxt)
            return True

        def cancel_rest() -> None:
            for att in active.values():
                att.cancel()

        launch(first)
        hedged = False        # a hedge attempt actually LAUNCHED
        hedge_armed = self.cfg.hedge  # the one-shot trigger timer
        hedge_deadline = (
            time.monotonic() + self._hedge_after()
            if self.cfg.hedge else None
        )
        while active:
            timeout = None
            if hedge_deadline is not None and hedge_armed:
                timeout = max(0.0, hedge_deadline - time.monotonic())
            try:
                m, att, kind, payload = results.get(timeout=timeout)
            except queue.Empty:
                # The hedge trigger: the attempt has been pending past
                # the observed p99 — fire ONE hedge at the next
                # breaker-allowed member (the armed ``fed.hedge``
                # fault point suppresses it, chaos-testing the
                # no-hedge path).
                hedge_armed = False
                if self._fault_hedge is not None:
                    try:
                        self._fault_hedge()
                    except Exception:
                        continue
                nxt = self._next_allowed(it)
                if nxt is not None:
                    self._m_hedges.inc()
                    hedged = True
                    with _obs_span("fed.hedge", "fed",
                                   host=nxt.host_id):
                        launch(nxt, is_hedge=True)
                continue
            active.pop(m.host_id, None)
            if att.cancelled:
                continue
            if kind == "resp":
                status, rh, data = payload
                if status == 200:
                    cancel_rest()
                    if att.elapsed is not None:
                        self._observe_forward(m.host_id, att.elapsed)
                    self._m_forwarded.inc()
                    if att.is_hedge:
                        self._m_hedge_wins.inc()
                    return status, rh, data, m.host_id, (
                        hedged or att.is_hedge
                    )
                if status == 504:
                    # The member burned this request's deadline; a
                    # reroute can only expire again. Permanent.
                    cancel_rest()
                    raise DeadlineExceeded(
                        f"member {m.host_id}: "
                        f"{data.decode(errors='replace').strip()}"
                    )
                if status == 503 and b"draining" in data:
                    # Membership verdict, not a failure: bleed the
                    # host out of routing and move on.
                    self.membership.mark_draining(m.host_id)
                    self._m_drain_reroutes.inc()
                    if not reroute() and not active:
                        break
                    continue
                if status in (429, 503):
                    backpressure.append(
                        (status, rh.get("retry-after"))
                    )
                    if not reroute() and not active:
                        break
                    continue
                if 400 <= status < 500:
                    # Deterministic client error: every member answers
                    # the same, so pass the first one through verbatim.
                    cancel_rest()
                    return status, rh, data, m.host_id, hedged
                # Remaining 5xx: the attempt thread already charged
                # the breaker; reroute. The verdict names the member's
                # typed error, so the client's 503 says why.
                failures.append((m.host_id,
                                 f"http_{status}{_error_type(data)}"))
                if not reroute() and not active:
                    break
                continue
            # Transport-level failure (verdict already counted and
            # breaker-charged by the attempt thread).
            verdict, _exc = payload
            failures.append((m.host_id, verdict))
            if not reroute() and not active:
                break
        # Every candidate consumed, no winner.
        if backpressure:
            status, retry_after = backpressure[-1]
            if any(s == 503 for s, _ in backpressure):
                e: Exception = Overloaded(
                    f"every routable member is shedding "
                    f"({len(backpressure)} backpressure answers)"
                )
            else:
                e = QueueFull(
                    f"every routable member queue is at capacity "
                    f"({len(backpressure)} backpressure answers)"
                )
            if retry_after:
                try:
                    # HTTP-date Retry-After values are spec-legal; an
                    # unparseable hint is no hint, never a 500.
                    e.retry_after_s = float(retry_after)
                except ValueError:
                    pass
            raise e
        detail = ", ".join(f"{h}: {v}" for h, v in failures) or "none"
        raise HostUnavailable(
            f"every forward attempt failed ({detail}); breakers are "
            f"counting — retry after a cooldown",
            host=failures[-1][0] if failures else None,
        )

    # -- drain ---------------------------------------------------------

    def drain_wait(self, timeout_s: float) -> Dict[str, bool]:
        """Wait for every member's outstanding forwarded requests to
        bleed to zero; returns ``{host_id: clean}`` — False names a
        member still holding requests past the budget (the net CLI's
        drained-vs-abandoned discipline, per host)."""
        deadline = time.monotonic() + timeout_s
        hosts = {m.host_id for m in self.membership.members()}
        while time.monotonic() < deadline:
            out = self.outstanding()
            if all(out.get(h, 0) == 0 for h in hosts):
                break
            time.sleep(0.05)
        out = self.outstanding()
        return {h: out.get(h, 0) == 0 for h in sorted(hosts)}
