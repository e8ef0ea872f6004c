"""Single-flight collapse: one launch per distinct in-flight key (the
port's copy of the JAX package's ``cache/singleflight.py``).

The router's coalescer merges compatible requests (same bucket) into one
batched launch; this merges identical requests (same full content key)
into one launch in all. The first arrival for a key is the leader and
runs the real admission and dispatch path; every concurrent arrival with
the same key is a follower parked on its own future, which never touches
the router.

* Followers wait under their own deadline: an expired follower fails
  (a 504 at the edge) without cancelling the leader.
* A leader failure propagates the typed exception to every follower and
  caches nothing.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.serve.metrics import Registry


class SingleFlight:
    """In-flight key table. ``join``, then exactly one of ``resolve`` /
    ``fail`` from the leader; both are no-ops for unknown keys."""

    def __init__(self, registry: Registry) -> None:
        self._lock = threading.Lock()
        self._flights: Dict[tuple, List[Future]] = {}
        self._m_leaders = registry.counter("singleflight_leaders_total")
        self._m_collapsed = registry.counter("singleflight_collapsed_total")

    def join(self, key: tuple) -> Tuple[bool, Optional[Future]]:
        """``(True, None)`` for the leader, which must later
        :meth:`resolve` or :meth:`fail` the key; ``(False, future)`` for a
        follower, which waits on it under its own deadline."""
        with self._lock:
            followers = self._flights.get(key)
            if followers is None:
                self._flights[key] = []
                self._m_leaders.inc()
                return True, None
            fut: Future = Future()
            followers.append(fut)
            self._m_collapsed.inc()
        with _obs_span("cache.collapse", "net"):
            pass
        return False, fut

    def resolve(self, key: tuple, value) -> None:
        """Leader success: hand ``value`` to every follower."""
        for fut in self._pop(key):
            if fut.set_running_or_notify_cancel():
                fut.set_result(value)

    def fail(self, key: tuple, exc: BaseException) -> None:
        """Leader failure: the typed exception to every follower."""
        for fut in self._pop(key):
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

    def _pop(self, key: tuple) -> List[Future]:
        with self._lock:
            return self._flights.pop(key, [])

    def inflight(self) -> int:
        """How many keys have a leader in flight."""
        with self._lock:
            return len(self._flights)
