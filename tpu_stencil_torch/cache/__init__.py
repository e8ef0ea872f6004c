"""Content-addressed result caching at the edge (the port's copy of the
JAX package's ``cache``).

With ``--result-cache-mb`` the net tier never pays a launch twice for
bytes it has already blurred. Four pieces:

* :mod:`~tpu_stencil_torch.cache.digest`: BLAKE2b-160 content digest
  fused into the CRC scan of the staging buffer; the full cache key.
* :mod:`~tpu_stencil_torch.cache.store`: byte-budgeted LRU of true result
  bytes and their integrity stamps, with synchronous replica-distrust
  invalidation and epoch-fenced admission.
* :mod:`~tpu_stencil_torch.cache.singleflight`: concurrent identical
  requests collapse onto one leader launch.
* :mod:`~tpu_stencil_torch.cache.affinity`: rendezvous hashing, so a
  router over several hosts sends repeated content where its entry lives.

:class:`ResultCache` is the handle the net tier holds: store and
single-flight behind one object, ``None`` when the cache is off.
"""

from __future__ import annotations

from typing import Callable, Optional

from tpu_stencil_torch.cache import affinity, digest, singleflight, store
from tpu_stencil_torch.cache.affinity import rendezvous_order
from tpu_stencil_torch.cache.digest import (
    DIGEST_SIZE,
    content_digest,
    digest_and_crc,
    request_key,
)
from tpu_stencil_torch.cache.singleflight import SingleFlight
from tpu_stencil_torch.cache.store import Entry, ResultStore
from tpu_stencil_torch.serve.metrics import Registry

__all__ = [
    "DIGEST_SIZE", "Entry", "ResultCache", "ResultStore", "SingleFlight",
    "affinity", "content_digest", "digest", "digest_and_crc",
    "rendezvous_order", "request_key", "singleflight", "store",
]


class ResultCache:
    """Store and single-flight behind the one handle the HTTP layer
    threads around. The leader's contract: draw :meth:`token` before
    dispatch, then exactly one of :meth:`complete` (admits and resolves
    the followers) or :meth:`fail` (propagates typed, caches nothing)."""

    def __init__(self, registry: Registry, capacity_bytes: int,
                 quarantined: Optional[Callable[[int], bool]] = None)\
            -> None:
        self.store = ResultStore(registry, capacity_bytes,
                                 quarantined=quarantined)
        self.flights = SingleFlight(registry)

    key = staticmethod(request_key)

    def token(self) -> int:
        return self.store.token()

    def lookup(self, key: tuple) -> Optional[Entry]:
        return self.store.get(key)

    def join(self, key: tuple):
        return self.flights.join(key)

    def complete(self, key: tuple, payload: bytes, stamp: Optional[str],
                 replica: int, token: int, device_us: int = 0) -> bool:
        """Leader success: admit (subject to the distrust fence) and
        resolve every follower with the true bytes. Followers get the
        result even when admission is refused: refusal is about the store
        not trusting the replica from now on, while these bytes already
        passed the path a cache-off response takes. ``device_us`` is what
        the leader's compute cost, so a later hit can report its avoided
        spend."""
        admitted = self.store.put(key, payload, stamp, replica, token,
                                  device_us=device_us)
        self.flights.resolve(key, (payload, stamp, replica))
        return admitted

    def fail(self, key: tuple, exc: BaseException) -> None:
        self.flights.fail(key, exc)

    def invalidate_replica(self, replica: int, cause: str) -> int:
        return self.store.invalidate_replica(replica, cause)

    def clear(self) -> int:
        return self.store.clear()

    def stats(self) -> dict:
        return self.store.stats()
