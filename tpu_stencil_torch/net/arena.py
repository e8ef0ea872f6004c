"""Per-bucket staging arenas for zero-copy HTTP ingest (the port's copy of
the JAX package's ``net/arena.py``).

Request bodies are ``readinto`` reusable bucket-capacity buffers, the
ingest CRC runs over the buffer in place, and the frame view rides into
the engine under the ``submit(owned=True)`` contract: the buffer goes back
to its pool when the engine signals consumption (or the request fails
first). One body, one host write before the engine's canvas.

The buffers are pageable numpy memory and are never the source of an
asynchronous copy to the card: the serving engine's worker copies each
frame into its own pinned batch canvas and only then fires
``on_consumed`` (:meth:`tpu_stencil_torch.serve.engine.StencilServer.
submit`), so a released lease may be rewritten at once.

Bounding: the pool population is client-controlled (bucket capacities),
so both the free-list depth per capacity and the number of capacities
are capped; past the key cap the coldest bucket's pool is evicted (LRU,
``arena_ingest_evictions_total``). Leases release idempotently: the
consumption hook and the request's done-callback may both fire.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from tpu_stencil_torch.serve.metrics import Registry

#: Free buffers kept per capacity bucket — bounds steady-state arena
#: memory at ``per_key * capacity`` bytes per active bucket while still
#: covering a handler-thread pool's worth of concurrent uploads.
DEFAULT_PER_KEY = 16

#: Distinct capacity buckets tracked (LRU): clients sweeping shapes
#: cannot grow the arena without bound — cold buckets age out and their
#: free buffers are freed with them.
DEFAULT_MAX_KEYS = 32


class Lease:
    """One staging buffer on loan: ``array`` is a 1-D uint8 buffer of at
    least the leased capacity. :meth:`release` returns it to the pool
    (idempotent — consumption hooks and failure-path done-callbacks may
    both call it)."""

    __slots__ = ("array", "_arena", "_capacity", "_released")

    def __init__(self, array: np.ndarray, arena: "StagingArena",
                 capacity: int) -> None:
        self.array = array
        self._arena = arena
        self._capacity = capacity
        self._released = False

    def view(self, nbytes: int) -> np.ndarray:
        """The leading ``nbytes`` of the buffer — the frame-sized
        window an upload is read into."""
        return self.array[:nbytes]

    def release(self) -> None:
        arena = self._arena
        with arena._lock:
            if self._released:
                return
            self._released = True
            arena._return_locked(self._capacity, self.array)


class StagingArena:
    """Bounded pools of preallocated ingest buffers, keyed by bucket
    capacity in bytes. Thread-safe (handler threads lease and release
    concurrently)."""

    def __init__(self, registry: Registry,
                 per_key: int = DEFAULT_PER_KEY,
                 max_keys: int = DEFAULT_MAX_KEYS) -> None:
        self._lock = threading.Lock()
        # capacity -> deque of free 1-D uint8 buffers (LRU over keys).
        self._pools: "collections.OrderedDict" = collections.OrderedDict()
        self._per_key = max(1, int(per_key))
        self._max_keys = max(1, int(max_keys))
        self._bytes = 0
        self._m_reuse = registry.counter("arena_ingest_reuse_total")
        self._m_alloc = registry.counter("arena_ingest_alloc_total")
        self._m_evict = registry.counter("arena_ingest_evictions_total")
        self._m_bytes = registry.gauge("arena_ingest_free_bytes")

    def lease(self, capacity: int) -> Lease:
        """A buffer of at least ``capacity`` bytes (the request's
        BUCKET capacity, so every request of a bucket reuses the same
        pool regardless of its true frame size)."""
        capacity = int(capacity)
        with self._lock:
            pool = self._pools.get(capacity)
            if pool is None:
                while len(self._pools) >= self._max_keys:
                    # Key population capped: age out the COLDEST
                    # bucket's pool so a traffic shift re-earns pooling
                    # for its new hot shapes (outstanding leases of the
                    # evicted pool just let their buffers die at
                    # release).
                    cold_cap, cold = self._pools.popitem(last=False)
                    self._bytes -= cold_cap * len(cold)
                    self._m_evict.inc()
                pool = self._pools[capacity] = collections.deque()
                self._m_bytes.set(self._bytes)
            self._pools.move_to_end(capacity)
            if pool:
                buf = pool.popleft()
                self._bytes -= capacity
                self._m_bytes.set(self._bytes)
                self._m_reuse.inc()
                return Lease(buf, self, capacity)
        self._m_alloc.inc()
        return Lease(np.empty(capacity, np.uint8), self, capacity)

    def _return_locked(self, capacity: int, buf: np.ndarray) -> None:
        pool = self._pools.get(capacity)
        if pool is None or len(pool) >= self._per_key:
            return  # key evicted or pool full: let the buffer die
        pool.append(buf)
        self._bytes += capacity
        self._m_bytes.set(self._bytes)
