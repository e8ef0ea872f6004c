"""Per-request resource ledger + per-tenant metering (the cost plane).

The port's copy of the JAX package's ``obs/ledger.py``, unchanged in
behaviour, names and metric names.

The telemetry plane (obs.timeseries / obs.slo) answers *is the tier
healthy*; nothing answered *where the device time went, which tenant
spent it, and how much headroom is left*. This module is the
attribution primitive the capacity/metering surface is built on:

* :class:`RequestLedger` — one per admitted request, bound to a
  ``contextvar`` exactly like the trace context
  (:mod:`tpu_stencil_torch.obs.context`), so the edges bind it once and every
  layer below (router coalescer, serve engine worker) credits spend
  with zero call-site plumbing: queue delay, coalesce-window wait,
  arena/ingest time, H2D/D2H bytes, and **device time amortized over
  batch members by pixel share** at the engine's retire fence. The
  HTTP edge reads it back to answer the ``X-Cost-Device-Us`` /
  ``X-Cost-Queue-Us`` / ``X-Cost-Source`` headers on every 200.
* **kind** — ``"request"`` is client goodput; ``"warm"`` marks the
  fleet's warm/prewarm submits so their device share lands in
  ``overhead_device_seconds_total``, never in a tenant's meter. The
  engine treats a ledger-less request (bare in-process serve) as
  goodput — attribution is additive, never a behavior change.
* :class:`TenantMeter` — the per-tenant aggregate table behind
  ``GET /debug/tenants``: requests, device-seconds, bytes, cache hits,
  shed/429 counts. Folds into the registry as
  ``tenant_<id>_device_seconds_total`` / ``tenant_<id>_requests_total``
  so the scrape plane sees tenants too. Tenant names come off the wire
  (``X-Tenant``), so they are sanitized against :data:`_TENANT_RE` and
  the table is cardinality-bounded — past :data:`TENANT_CAP` distinct
  names, spend folds into the ``"other"`` bucket instead of minting
  unbounded metric names.

Threading: the engine worker, the coalescer timer, and the HTTP handler
all touch one request's ledger, but never concurrently for the same
field *transition* that matters (device credit happens before the
future resolves; the handler reads after ``fut.result()``). A lock
guards the accumulators anyway — a ledger must never be the data race
the rest of the stack avoids.

Dependency-free, like the rest of the wire-level obs.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import threading
from typing import Dict, Optional

#: The tenant header the whole stack shares (fed quota machinery, net
#: metering, loadgen stamping).
TENANT_HEADER = "X-Tenant"

#: Requests with no (or an invalid) X-Tenant meter under this name —
#: the same default the fed quota machinery admits under.
DEFAULT_TENANT = "anon"

#: Wire guard for tenant names: URL-safe, bounded. Anything failing
#: this meters as DEFAULT_TENANT — a hostile header must never ride
#: into metric names.
_TENANT_RE = re.compile(r"^[0-9A-Za-z_.-]{1,64}$")

#: Cardinality bound on the per-tenant table (and the tenant_* metric
#: family): past this many distinct names, new tenants fold into
#: :data:`OVERFLOW_TENANT`.
TENANT_CAP = 64
OVERFLOW_TENANT = "other"


def sanitize_tenant(raw) -> str:
    """The metered tenant name for a wire value: the value itself when
    it passes the guard, :data:`DEFAULT_TENANT` otherwise. Dots and
    dashes are squashed to underscores for metric-name safety."""
    if not isinstance(raw, str) or not _TENANT_RE.match(raw):
        return DEFAULT_TENANT
    return raw.replace(".", "_").replace("-", "_")


_current: "contextvars.ContextVar[Optional[RequestLedger]]" = (
    contextvars.ContextVar("tpu_stencil_torch_request_ledger", default=None)
)


class RequestLedger:
    """One request's resource spend, accumulated across tiers."""

    __slots__ = ("_lock", "tenant", "kind", "source", "queue_s",
                 "coalesce_s", "ingest_s", "device_s", "h2d_bytes",
                 "d2h_bytes", "saved_device_s")

    def __init__(self, tenant: str = DEFAULT_TENANT,
                 kind: str = "request") -> None:
        self._lock = threading.Lock()
        self.tenant = tenant
        #: "request" = client goodput; "warm" = fleet warm/prewarm
        #: submits (overhead at the engine's retire fence).
        self.kind = kind
        #: How the 200 was produced: "compute" (own device work),
        #: "cache" (result store), "coalesced" (rode another request's
        #: in-flight compute — the single-flight follower).
        self.source = "compute"
        self.queue_s = 0.0
        self.coalesce_s = 0.0
        self.ingest_s = 0.0
        self.device_s = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        #: A cache hit's avoided spend: what the stored entry cost to
        #: compute when it was admitted.
        self.saved_device_s = 0.0

    # -- accumulation (any thread) ------------------------------------

    def add_queue(self, seconds: float) -> None:
        with self._lock:
            self.queue_s += max(0.0, float(seconds))

    def add_coalesce(self, seconds: float) -> None:
        with self._lock:
            self.coalesce_s += max(0.0, float(seconds))

    def add_ingest(self, seconds: float) -> None:
        with self._lock:
            self.ingest_s += max(0.0, float(seconds))

    def add_device(self, seconds: float, h2d_bytes: int = 0,
                   d2h_bytes: int = 0) -> None:
        """One batch's amortized share lands here (the engine's retire
        fence): device wall by pixel share, plus this request's share
        of the batch's H2D/D2H bytes."""
        with self._lock:
            self.device_s += max(0.0, float(seconds))
            self.h2d_bytes += max(0, int(h2d_bytes))
            self.d2h_bytes += max(0, int(d2h_bytes))

    def set_source(self, source: str) -> None:
        self.source = source

    # -- readback (the HTTP edge, after the future resolved) -----------

    @property
    def device_us(self) -> int:
        with self._lock:
            return int(round(self.device_s * 1e6))

    @property
    def queue_us(self) -> int:
        """Queued time in the X-Cost-Queue-Us sense: engine queue wait
        plus the coalesce-window wait that preceded it."""
        with self._lock:
            return int(round((self.queue_s + self.coalesce_s) * 1e6))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tenant": self.tenant,
                "kind": self.kind,
                "source": self.source,
                "queue_s": self.queue_s,
                "coalesce_s": self.coalesce_s,
                "ingest_s": self.ingest_s,
                "device_s": self.device_s,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "saved_device_s": self.saved_device_s,
            }


# -- contextvar plumbing (mirrors obs.context) ------------------------

def current() -> Optional[RequestLedger]:
    return _current.get()


def push(ledger: Optional[RequestLedger]):
    """Non-contextmanager binding; pair with :func:`pop`."""
    return _current.set(ledger)


def pop(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def bind(ledger: Optional[RequestLedger]):
    """Install ``ledger`` for the block. Binding ``None`` explicitly
    clears it (a warm submit fired from a handler thread must not
    charge the client's ledger)."""
    token = _current.set(ledger)
    try:
        yield ledger
    finally:
        _current.reset(token)


class _TenantRow:
    """One tenant's cumulative meter (plain counters; the registry
    fold-in keeps the scrape plane in sync)."""

    __slots__ = ("requests", "device_s", "queue_s", "bytes_in",
                 "bytes_out", "cache_hits", "coalesced", "saved_device_s",
                 "rejected_429", "shed_503")

    def __init__(self) -> None:
        self.requests = 0
        self.device_s = 0.0
        self.queue_s = 0.0
        self.bytes_in = 0
        self.bytes_out = 0
        self.cache_hits = 0
        self.coalesced = 0
        self.saved_device_s = 0.0
        self.rejected_429 = 0
        self.shed_503 = 0

    def snapshot(self) -> dict:
        total = self.requests + self.rejected_429 + self.shed_503
        return {
            "requests": self.requests,
            "device_seconds": self.device_s,
            "queue_seconds": self.queue_s,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "cache_hits": self.cache_hits,
            "cache_hit_ratio": (
                self.cache_hits / self.requests if self.requests else 0.0
            ),
            "coalesced": self.coalesced,
            "saved_device_seconds": self.saved_device_s,
            "rejected_429": self.rejected_429,
            "shed_503": self.shed_503,
            "offered": total,
        }


class TenantMeter:
    """The billing table behind ``GET /debug/tenants``: bounded
    per-tenant rows plus the ``tenant_<id>_*`` registry fold."""

    def __init__(self, registry) -> None:
        self.registry = registry
        self._lock = threading.Lock()
        self._rows: Dict[str, _TenantRow] = {}

    def _row_locked(self, tenant: str):
        """(resolved-name, row) — past the cardinality cap new names
        resolve to the overflow bucket, for the row AND the metric."""
        row = self._rows.get(tenant)
        if row is None:
            if len(self._rows) >= TENANT_CAP:
                tenant = OVERFLOW_TENANT
                row = self._rows.get(tenant)
                if row is None:
                    row = self._rows[tenant] = _TenantRow()
            else:
                row = self._rows[tenant] = _TenantRow()
        return tenant, row

    def record(self, ledger: RequestLedger, bytes_in: int,
               bytes_out: int) -> None:
        """One successfully answered 200: fold the request's ledger
        into its tenant's row (and the registry family)."""
        snap = ledger.snapshot()
        with self._lock:
            t, row = self._row_locked(snap["tenant"])
            row.requests += 1
            row.device_s += snap["device_s"]
            row.queue_s += snap["queue_s"] + snap["coalesce_s"]
            row.bytes_in += max(0, int(bytes_in))
            row.bytes_out += max(0, int(bytes_out))
            if snap["source"] == "cache":
                row.cache_hits += 1
            elif snap["source"] == "coalesced":
                row.coalesced += 1
            row.saved_device_s += snap["saved_device_s"]
        self.registry.counter(f"tenant_{t}_requests_total").inc()
        if snap["device_s"] > 0:
            self.registry.counter(
                f"tenant_{t}_device_seconds_total"
            ).inc(snap["device_s"])

    def reject(self, tenant: str, code: int) -> None:
        """One shed/backpressure answer for ``tenant`` (429 queue-full
        vs 503 shed/draining — the abuse view's two columns)."""
        with self._lock:
            _, row = self._row_locked(tenant)
            if code == 429:
                row.rejected_429 += 1
            else:
                row.shed_503 += 1

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {t: row.snapshot()
                    for t, row in sorted(self._rows.items())}
