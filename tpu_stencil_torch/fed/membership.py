"""Health-checked federation membership: register, heartbeat, evict (the
port's copy of the JAX package's ``fed/membership.py``).

The reference's MPI tier assumes a fixed, immortal set of ranks
(``MPI_Init`` once, every rank lives to ``MPI_Finalize``); a federation
of serving hosts cannot. This module owns the member lifecycle the
front router (:mod:`tpu_stencil_torch.fed.router`) places against:

* **register** — a backend host (one ``tpu_stencil_torch net`` process)
  announces its URL over HTTP (``POST /admin/register``); registration
  probes ``/healthz`` first, so a dead URL is rejected typed instead of
  silently absorbing traffic. Re-registering a known host (the same
  process restarted, or a fresh one on the same address) resurrects it
  healthy with a clean miss count.
* **heartbeat** — a background thread probes every member's
  ``/healthz`` each ``heartbeat_interval_s``. State moves on a
  *suspicion window*, never a single timeout: ``suspect_after``
  consecutive misses demote healthy → suspect (still routable, but
  placed after every healthy host), ``evict_after`` misses evict
  (``fed_evictions_total``; the host stops being probed and can only
  come back by re-registering). A probe that answers 503 marks the
  member **draining** — removed from routing *before* its in-flight
  drain starts refusing requests — and a later 200 from the same
  address (a fresh process) resurrects it.
* **admin drain** — :meth:`Membership.mark_draining` is the rolling
  whole-host-drain entry: the router bleeds traffic off the member
  while its own admin path drains its replicas.

The ``fed.heartbeat`` fault point injects at the probe: an injected
fault IS a missed heartbeat, so the suspicion window and eviction are
chaos-testable without killing a real process.

:func:`host_id_for` gives the JAX package's id for the same URL, so one
dashboard folds the members of both packages under the same names.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from tpu_stencil_torch.config import FedConfig
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.serve.metrics import Registry

HEALTHY = "healthy"
SUSPECT = "suspect"
DRAINING = "draining"
EVICTED = "evicted"

_STATES = (HEALTHY, SUSPECT, DRAINING, EVICTED)


def _netloc(url: str) -> str:
    """The scheme-less, slash-less address — what the fold prefix (and
    therefore collision detection) is actually keyed on."""
    return re.sub(r"^https?://", "", url.rstrip("/"))


def host_id_for(url: str) -> str:
    """The metric-safe member id for a URL: the netloc with every
    non-alphanumeric squashed to ``_`` (``http://127.0.0.1:8080`` →
    ``127_0_0_1_8080``) — usable verbatim inside a Prometheus metric
    name (the ``fleet_<host>_`` exposition fold). The squash is lossy
    (``host-1:80`` and ``host.1:80`` collide); ``Membership.register``
    detects that and suffixes a URL hash so two distinct netlocs never
    share a fold prefix."""
    netloc = re.sub(r"^https?://", "", url.rstrip("/"))
    return re.sub(r"[^0-9A-Za-z]", "_", netloc)


@dataclasses.dataclass
class Member:
    """One backend host in the federation."""

    host_id: str
    url: str
    state: str = HEALTHY
    misses: int = 0
    registered_at: float = 0.0
    last_ok: float = 0.0
    # An ADMIN drain is sticky: a heartbeat 200 must not quietly
    # re-admit a host the operator explicitly drained (the member may
    # not have flipped its healthz yet, or the drain POST to it may
    # have failed). Only re-registration clears it.
    pinned_draining: bool = False

    def snapshot(self) -> dict:
        return {
            "host_id": self.host_id,
            "url": self.url,
            "state": self.state,
            "misses": self.misses,
            "registered_at": self.registered_at,
            "last_ok": self.last_ok,
            "pinned_draining": self.pinned_draining,
        }


class Membership:
    """The member table + the heartbeat thread. Thread-safe; every
    transition is counted in the fed registry and visible in
    ``/statusz`` (and eviction in ``/metrics`` — the acceptance
    criterion's scrape-visible host loss)."""

    def __init__(self, cfg: FedConfig, registry: Registry) -> None:
        self.cfg = cfg
        self.registry = registry
        self._lock = threading.Lock()
        self._members: Dict[str, Member] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fault_heartbeat = None  # resolved at start()
        self._m_registrations = registry.counter("registrations_total")
        self._m_evictions = registry.counter("evictions_total")
        self._m_misses = registry.counter("heartbeat_misses_total")
        self._m_beats = registry.counter("heartbeats_total")
        # Fired (outside the lock) when a host re-registers after an
        # eviction or a drain: the frontend hooks this to drop the
        # dead process's breaker and forward-latency state — a fresh
        # process on a reused netloc must not inherit either.
        self.on_resurrect: Optional[Callable[[str], None]] = None
        for s in _STATES:
            registry.gauge(f"members_{s}").set(0)

    # -- registration --------------------------------------------------

    def register(self, url: str, check: bool = True) -> Member:
        """Add (or resurrect) a member. With ``check`` (the HTTP
        registration path), the URL's ``/healthz`` must answer 200
        first — registering a dead or draining host raises
        ``ValueError`` instead of poisoning the routing table."""
        url = url.rstrip("/")
        if not url.startswith(("http://", "https://")):
            raise ValueError(
                f"member URL must start with http:// or https://, got "
                f"{url!r}"
            )
        if check:
            status = self._probe(url)
            if status != 200:
                raise ValueError(
                    f"member {url} failed its registration health check "
                    f"(healthz answered "
                    f"{status if status else 'nothing'}); not added"
                )
        hid = host_id_for(url)
        now = time.monotonic()
        with self._lock:
            m = self._members.get(hid)
            if m is not None and _netloc(m.url) != _netloc(url):
                # Metric-name fold collision: two DISTINCT netlocs
                # sanitize to the same host_id (e.g. ``host-1:80`` and
                # ``host.1:80`` → ``host_1_80``), and sharing the id
                # would silently merge their ``fleet_<host_id>_*``
                # counters in the /metrics fold. Disambiguate with a
                # stable netloc-hash suffix — detected, counted, never
                # merged. Compared on NETLOC, not the full URL: the
                # same host re-registering under a new scheme
                # (http→https) is a re-registration (URL updated in
                # place below), never a phantom second member.
                import zlib

                hid = (f"{hid}_"
                       f"{zlib.crc32(_netloc(url).encode()) & 0xFFFF:04x}")
                self.registry.counter(
                    "host_id_collisions_total"
                ).inc()
                m = self._members.get(hid)
            if m is None:
                m = Member(host_id=hid, url=url, registered_at=now)
                self._members[hid] = m
            # A host coming back from the dead (evicted, or any form
            # of drain): the process behind the netloc is NEW — its
            # learned per-host state (breaker, hedge-p99 latency) died
            # with the old one and must be reset, not inherited.
            resurrected = (m.state in (DRAINING, EVICTED)
                           or m.pinned_draining)
            # Re-registration (or a seed re-announcing itself):
            # resurrect with a clean window whatever the prior state —
            # including an admin drain, which registration explicitly
            # un-pins (the operator's restarted host announcing back).
            m.url = url
            m.state = HEALTHY
            m.misses = 0
            m.pinned_draining = False
            m.last_ok = now if check else m.last_ok
        self._m_registrations.inc()
        if resurrected and self.on_resurrect is not None:
            try:
                self.on_resurrect(m.host_id)
            except Exception:  # noqa: BLE001 - reset hooks never block
                pass           # registration (routing heals regardless)
        self._refresh_gauges()
        return m

    def register_seed(self, url: str) -> Member:
        """Seed-list registration (CLI ``--member``): a seed that does
        not answer its probe is still admitted, as SUSPECT with its
        miss window already at the suspicion threshold — the heartbeat
        loop will either recover it (one 200 heals everything) or walk
        it to eviction. A federation must be startable before its
        members."""
        try:
            return self.register(url, check=True)
        except ValueError:
            m = self.register(url, check=False)
            with self._lock:
                m.state = SUSPECT
                m.misses = self.cfg.suspect_after
            self._refresh_gauges()
            return m

    # -- state transitions ---------------------------------------------

    def mark_draining(self, host_id: str,
                      pinned: bool = False) -> Optional[Member]:
        """Remove a member from routing because it is draining (its
        healthz said 503, or — with ``pinned`` — an admin drain is
        bleeding it; pinned drains survive heartbeat 200s until the
        host re-registers). Returns the member (None if unknown)."""
        with self._lock:
            m = self._members.get(host_id)
            if m is not None and m.state not in (DRAINING, EVICTED):
                m.state = DRAINING
                m.misses = 0
            if m is not None and pinned and m.state == DRAINING:
                m.pinned_draining = True
        self._refresh_gauges()
        return m

    def evict(self, host_id: str, reason: str) -> None:
        with self._lock:
            m = self._members.get(host_id)
            if m is None or m.state == EVICTED:
                return
            m.state = EVICTED
        self._m_evictions.inc()
        self._refresh_gauges()
        with _obs_span("fed.evict", "fed", host=host_id, reason=reason):
            pass  # zero-duration marker: the eviction moment
        from tpu_stencil_torch.obs import events as _obs_events

        _obs_events.emit("fed.evict", tier="fed", verdict="evicted",
                         host=host_id, reason=reason)

    # -- views ---------------------------------------------------------

    def get(self, host_id: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(host_id)

    def members(self) -> List[Member]:
        with self._lock:
            return list(self._members.values())

    def routable(self) -> List[Member]:
        """Members the router may place on: healthy first, then
        suspect (the window exists so ONE dropped probe does not
        un-route a live host). Draining and evicted never route."""
        with self._lock:
            healthy = [m for m in self._members.values()
                       if m.state == HEALTHY]
            suspect = [m for m in self._members.values()
                       if m.state == SUSPECT]
        return healthy + suspect

    def statusz(self) -> List[dict]:
        with self._lock:
            return [m.snapshot() for m in self._members.values()]

    def _refresh_gauges(self) -> None:
        with self._lock:
            counts = {s: 0 for s in _STATES}
            for m in self._members.values():
                counts[m.state] += 1
        for s, n in counts.items():
            self.registry.gauge(f"members_{s}").set(n)

    # -- heartbeats ----------------------------------------------------

    def _probe(self, url: str) -> Optional[int]:
        """One /healthz probe: the HTTP status (503 comes back as 503,
        not an exception), or None on any transport failure."""
        timeout = max(0.25, min(5.0, self.cfg.heartbeat_interval_s))
        try:
            with urllib.request.urlopen(url + "/healthz",
                                        timeout=timeout) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except Exception:
            return None

    def _beat_one(self, m: Member) -> None:
        self._m_beats.inc()
        if self._fault_heartbeat is not None:
            try:
                self._fault_heartbeat()
            except Exception:
                status = None  # an injected fault IS a missed beat
            else:
                status = self._probe(m.url)
        else:
            status = self._probe(m.url)
        if status == 200:
            with self._lock:
                # A 200 heals everything short of eviction — including
                # a self-reported DRAINING (a fresh process answering
                # on the same address is a new, healthy host) — but
                # NOT a pinned admin drain: the operator asked for
                # this host out, and its 200 may just mean the drain
                # POST never reached it. Re-registration un-pins.
                if m.state != EVICTED and not m.pinned_draining:
                    m.state = HEALTHY
                    m.misses = 0
                    m.last_ok = time.monotonic()
            return
        if status == 503:
            # Draining (or shedding so hard its probe was refused
            # typed): out of the routing set BEFORE its requests fail.
            self.mark_draining(m.host_id)
            return
        # Transport failure or an unexpected status: one miss in the
        # suspicion window.
        self._m_misses.inc()
        evict = False
        with self._lock:
            if m.state == EVICTED:
                return
            m.misses += 1
            if m.misses >= self.cfg.evict_after:
                evict = True
            elif m.misses >= self.cfg.suspect_after:
                m.state = SUSPECT
        if evict:
            self.evict(m.host_id,
                       f"{m.misses} consecutive missed heartbeats")
        else:
            self._refresh_gauges()

    def beat(self) -> None:
        """One heartbeat pass over every non-evicted member (the loop
        body; callable directly from tests for deterministic timing)."""
        for m in self.members():
            if m.state != EVICTED:
                self._beat_one(m)

    def start(self) -> "Membership":
        from tpu_stencil_torch.resilience import faults as _faults

        self._fault_heartbeat = _faults.site("fed.heartbeat")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="tpu-stencil-torch-fed-heartbeat",
                daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.heartbeat_interval_s):
            try:
                self.beat()
            except Exception:
                # The heartbeat thread must never die: a broken probe
                # is a miss, not a membership outage.
                pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
