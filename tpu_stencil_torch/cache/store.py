"""Byte-budgeted LRU result store with replica-distrust invalidation (the
port's copy of the JAX package's ``cache/store.py``).

The store holds the TRUE result bytes (pre-chaos-site, exactly what a
healthy cold compute returned) plus the already-computed
``X-Result-Crc32c`` stamp, so a hit re-serves both without touching a
replica. Eviction is strict LRU under a byte budget — the knob is
``--result-cache-mb``, the budget covers payload bytes only (bookkeeping
is noise next to image payloads).

**The store must never outlive distrust in its source.** Every entry
records which replica produced it. Two mechanisms keep poison out:

* *Synchronous invalidation* — a witness mismatch or a quarantine
  event on replica *i* drops every entry replica *i* produced, on the
  thread that delivered the verdict, before the verdict reaches the
  quarantine board (``cache_invalidations_total`` plus a per-cause
  counter say why).
* *Epoch-fenced admission* — :meth:`put` takes the token the caller
  drew (:meth:`token`) BEFORE dispatching the compute. If the replica
  was invalidated after that token was drawn — e.g. its witness verdict
  raced ahead of the HTTP thread's admission — the insert is refused
  (``result_cache_admission_refused_total``): a result from a replica
  distrusted at any point since the request was dispatched never
  enters the store. Entries from a currently-quarantined replica are
  refused by the same gate.

All counters live in the net registry under ``result_cache_*`` /
``cache_invalidations_*`` — the serve engine already owns
``cache_hits_total`` for its executable cache (folded into net scrapes
as ``fleet_cache_hits_total``), so the result cache uses a distinct
prefix rather than shadowing it.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Optional, Set

from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.serve.metrics import Registry

# Invalidation causes with pre-created counters (scrape-visible at
# zero). An unknown cause still counts — its counter is created on
# first use.
_CAUSES = ("witness_mismatch", "quarantine", "clear")


class Entry:
    """One cached result: payload bytes, the integrity stamp that was
    served with the cold response (None when integrity is off), the
    producing replica index, and what the entry cost to compute
    (device microseconds — a later hit reports this as its avoided
    spend in the cost ledger)."""

    __slots__ = ("payload", "stamp", "replica", "device_us")

    def __init__(self, payload: bytes, stamp: Optional[str],
                 replica: int, device_us: int = 0) -> None:
        self.payload = payload
        self.stamp = stamp
        self.replica = replica
        self.device_us = int(device_us)


class ResultStore:
    """Thread-safe LRU over full request keys (see
    :func:`tpu_stencil_torch.cache.digest.request_key`)."""

    def __init__(self, registry: Registry, capacity_bytes: int,
                 quarantined: Optional[Callable[[int], bool]] = None)\
            -> None:
        self.registry = registry
        self.capacity_bytes = int(capacity_bytes)
        # Predicate wired to the quarantine board: entries from a
        # currently-quarantined replica are never admitted.
        self._quarantined = quarantined
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, Entry]" = (
            collections.OrderedDict()
        )
        self._by_replica: Dict[int, Set[tuple]] = {}
        self._bytes = 0
        # Distrust epochs: _epoch advances on every invalidation;
        # _distrust[i] is the epoch of replica i's most recent one.
        # put() refuses when the producer was distrusted after the
        # caller's token — the fence that closes the witness/admission
        # race (the witness runs on the replica worker thread and can
        # beat the HTTP thread to the store).
        self._epoch = 0
        self._distrust: Dict[int, int] = {}
        m = registry
        self._m_hits = m.counter("result_cache_hits_total")
        self._m_misses = m.counter("result_cache_misses_total")
        self._m_inserts = m.counter("result_cache_insertions_total")
        self._m_evictions = m.counter("result_cache_evictions_total")
        self._m_refused = m.counter("result_cache_admission_refused_total")
        self._m_invalidations = m.counter("cache_invalidations_total")
        for cause in _CAUSES:
            m.counter(f"cache_invalidations_{cause}_total")
        self._g_bytes = m.gauge("result_cache_bytes")
        self._g_entries = m.gauge("result_cache_entries")

    # -- admission fence ----------------------------------------------

    def token(self) -> int:
        """Draw an admission token. Call BEFORE dispatching the compute
        whose result may later be :meth:`put`; any invalidation of the
        producing replica after this point refuses the insert."""
        with self._lock:
            return self._epoch

    # -- cache operations ---------------------------------------------

    def get(self, key: tuple) -> Optional[Entry]:
        """LRU lookup. Counts a hit or a miss; a hit refreshes
        recency."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._m_misses.inc()
                return None
            self._entries.move_to_end(key)
            self._m_hits.inc()
            return ent

    def put(self, key: tuple, payload: bytes, stamp: Optional[str],
            replica: int, token: int, device_us: int = 0) -> bool:
        """Admit one result. Returns False (counted) when the producer
        is distrusted — currently quarantined, or invalidated since
        ``token`` was drawn — or when the payload alone exceeds the
        whole budget."""
        replica = int(replica)
        nbytes = len(payload)
        quarantined = self._quarantined
        if replica < 0 or (quarantined is not None and quarantined(replica)):
            self._m_refused.inc()
            return False
        if nbytes > self.capacity_bytes:
            self._m_refused.inc()
            return False
        with _obs_span("cache.insert", "net", replica=replica,
                       nbytes=nbytes):
            with self._lock:
                if self._distrust.get(replica, -1) > token:
                    self._m_refused.inc()
                    return False
                old = self._entries.pop(key, None)
                if old is not None:
                    self._drop_locked(key, old)
                self._entries[key] = Entry(payload, stamp, replica,
                                           device_us)
                self._by_replica.setdefault(replica, set()).add(key)
                self._bytes += nbytes
                self._m_inserts.inc()
                while self._bytes > self.capacity_bytes and self._entries:
                    victim_key, victim = self._entries.popitem(last=False)
                    self._drop_locked(victim_key, victim)
                    self._m_evictions.inc()
                self._update_gauges_locked()
        return True

    def _drop_locked(self, key: tuple, ent: Entry) -> None:
        """Bookkeeping for an entry already removed from the LRU map."""
        self._bytes -= len(ent.payload)
        keys = self._by_replica.get(ent.replica)
        if keys is not None:
            keys.discard(key)
            if not keys:
                self._by_replica.pop(ent.replica, None)

    # -- invalidation --------------------------------------------------

    def invalidate_replica(self, replica: int, cause: str) -> int:
        """Synchronously drop every entry replica ``replica`` produced
        and advance its distrust epoch (so in-flight results from it
        are refused admission). Returns how many entries went."""
        replica = int(replica)
        with self._lock:
            self._epoch += 1
            self._distrust[replica] = self._epoch
            keys = self._by_replica.pop(replica, None)
            n = 0
            if keys:
                for key in keys:
                    ent = self._entries.pop(key, None)
                    if ent is not None:
                        self._bytes -= len(ent.payload)
                        n += 1
            self._count_invalidation_locked(cause, n)
            self._update_gauges_locked()
        with _obs_span("cache.invalidate", "net", replica=replica,
                       cause=cause, entries=n):
            pass
        return n

    def clear(self, cause: str = "clear") -> int:
        """Operator wipe (``/admin/cache?action=clear``): drop every
        entry and distrust nothing — the fleet is fine, the operator
        just wants a cold cache."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_replica.clear()
            self._bytes = 0
            self._count_invalidation_locked(cause, n)
            self._update_gauges_locked()
        return n

    def _count_invalidation_locked(self, cause: str, n: int) -> None:
        self._m_invalidations.inc(n)
        self.registry.counter(f"cache_invalidations_{cause}_total").inc(n)

    def _update_gauges_locked(self) -> None:
        self._g_bytes.set(float(self._bytes))
        self._g_entries.set(float(len(self._entries)))

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        """The ``/statusz`` block: sizes and budget (counters ride the
        registry snapshot separately)."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "replicas_indexed": sorted(self._by_replica),
            }
