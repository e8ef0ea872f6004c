"""Digest-affinity placement: rendezvous hashing over fleet members (the
port's copy of the JAX package's ``cache/affinity.py``).

For a given content digest every router ranks the same member first, so
repeated content lands where its cache entry lives; when a member drops
out only the keys it owned move. The weight is BLAKE2b-64 over
``digest || host_id``, deterministic across processes.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List


def _weight(digest: bytes, host_id: str) -> bytes:
    return hashlib.blake2b(
        digest + host_id.encode("utf-8", "surrogatepass"), digest_size=8
    ).digest()


def rendezvous_order(host_ids: Iterable[str], digest: bytes) -> List[str]:
    """Member ids ranked by highest random weight for ``digest``; index 0
    is the affinity home. Ties (duplicate ids only) break on the id, so
    the order is total and stable."""
    return sorted(host_ids,
                  key=lambda hid: (_weight(digest, hid), hid),
                  reverse=True)
