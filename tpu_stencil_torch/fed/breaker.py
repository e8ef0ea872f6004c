"""Per-host circuit breakers for the federation forward path (the port's
copy of the JAX package's ``fed/breaker.py``).

A member that keeps failing at the transport level (connect refused,
socket timeout, mid-body EOF, 5xx) must stop receiving traffic *before*
every request pays its failure latency — the membership heartbeat is
too slow for that (its window is seconds; a refused connect costs every
routed request milliseconds each). The breaker is the fast path:

* **closed** — traffic flows; consecutive transport failures count.
* **open** — after ``breaker_threshold`` consecutive failures the host
  is skipped in placement (a request that would have no other host
  fails typed :class:`~tpu_stencil_torch.resilience.errors.HostUnavailable`).
* **half-open** — after ``breaker_cooldown_s`` ONE probe request is
  let through; success closes the breaker, failure re-opens it for
  another cooldown. Exactly one probe: a thundering herd of
  "is it back?" traffic against a struggling host is how outages
  spread.

Backpressure (429/503) and client errors (4xx) are NOT breaker
failures — a host that answers anything at all is alive; the router's
verdict taxonomy (:mod:`~tpu_stencil_torch.fed.router`) decides what
counts.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from tpu_stencil_torch.serve.metrics import Registry

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class Breaker:
    """One host's breaker. Thread-safe; time base is ``monotonic``."""

    def __init__(self, threshold: int, cooldown_s: float) -> None:
        self._lock = threading.Lock()
        self._threshold = max(1, int(threshold))
        self._cooldown = float(cooldown_s)
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request be placed on this host right now? Open
        breakers let exactly one half-open probe through per
        cooldown."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if (time.monotonic() - self._opened_at
                        >= self._cooldown):
                    self._state = HALF_OPEN
                    self._probe_inflight = True
                    return True  # this caller IS the probe
                return False
            # HALF_OPEN: one probe at a time.
            if not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> bool:
        """A full HTTP response arrived (any status: the host is
        alive). Returns True when this closed a non-closed breaker."""
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._failures = 0
            self._probe_inflight = False
            return was != CLOSED

    def record_failure(self) -> bool:
        """A transport-level failure. Returns True when this OPENED
        the breaker (threshold crossed, or a half-open probe died)."""
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._failures >= self._threshold
            ):
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._probe_inflight = False
                return True
            if self._state == OPEN:
                self._opened_at = time.monotonic()
            return False

    def release_probe(self) -> None:
        """A half-open probe was cancelled before it produced
        evidence: free the probe slot without judging the host (the
        next placement may probe again)."""
        with self._lock:
            self._probe_inflight = False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "opened_at": self._opened_at or None,
            }


class BreakerBoard:
    """The per-host breaker table + its metrics: one breaker per
    member, created on first sight, dropped on eviction."""

    def __init__(self, threshold: int, cooldown_s: float,
                 registry: Registry) -> None:
        self._lock = threading.Lock()
        self._threshold = threshold
        self._cooldown = cooldown_s
        self._breakers: Dict[str, Breaker] = {}
        self.registry = registry
        self._m_opened = registry.counter("breaker_open_total")
        self._m_closed = registry.counter("breaker_close_total")
        self._g_open = registry.gauge("breakers_open")

    def get(self, host_id: str) -> Breaker:
        with self._lock:
            b = self._breakers.get(host_id)
            if b is None:
                b = Breaker(self._threshold, self._cooldown)
                self._breakers[host_id] = b
            return b

    def drop(self, host_id: str) -> None:
        with self._lock:
            self._breakers.pop(host_id, None)
        self._refresh_gauge()

    def record_success(self, host_id: str) -> None:
        if self.get(host_id).record_success():
            self._m_closed.inc()
        self._refresh_gauge()

    def record_failure(self, host_id: str) -> None:
        if self.get(host_id).record_failure():
            self._m_opened.inc()
            # The breaker-open anomaly: dump the flight ring + emit
            # the event. Attempt threads re-bind the request's trace
            # context, so the open that a specific forward provoked is
            # trace-scoped; an open with no context in scope dumps the
            # recent ring (the lead-up).
            from tpu_stencil_torch.obs import context as _obs_ctx
            from tpu_stencil_torch.obs import flight as _obs_flight

            ctx = _obs_ctx.current()
            _obs_flight.trigger(
                "breaker_open",
                trace_id=ctx.trace_id if ctx else "",
                tier="fed", host=host_id,
            )
        self._refresh_gauge()

    def _refresh_gauge(self) -> None:
        with self._lock:
            n = sum(1 for b in self._breakers.values()
                    if b.state != CLOSED)
        self._g_open.set(n)

    def statusz(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {hid: b.snapshot() for hid, b in items}
