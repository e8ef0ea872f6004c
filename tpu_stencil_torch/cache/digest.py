"""Content digests for the edge result cache (the port's copy of the JAX
package's ``cache/digest.py``).

A CRC is the right tool for wire corruption and the wrong one for content
addressing: 32 bits collide at cache scale, and a collision here would
serve the wrong pixels with a 200. The cache keys on BLAKE2b-160 instead
(20 bytes, in hashlib everywhere).

:func:`digest_and_crc` is the fusion point: one pass over the request
body feeds both the BLAKE2b state and the incremental CRC32C
(``crc32c(chunk, value)`` extends a running checksum), so arming the cache
adds no second scan to the ingest path. The CRC is the port's own
(:func:`tpu_stencil_torch.integrity.checksum.crc32c`: its C++ library for
chunks of 4 KiB or more), and its value is the JAX package's on the same
bytes.

The full cache key is the digest plus every parameter that changes the
result bytes: filter, reps, geometry (H, W, channels) and boundary.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

from tpu_stencil_torch.integrity import checksum as _checksum

# BLAKE2b-160: 20-byte digests.
DIGEST_SIZE = 20

# Scan granularity: one chunk per MiB keeps the Python loop's cost small
# against the C hash cores and bounds the memoryview slices.
_CHUNK = 1 << 20


def _flat_view(data) -> memoryview:
    """A 1-D byte view of ``data`` (bytes, bytearray, memoryview or a
    contiguous ndarray) without copying."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return mv


def content_digest(data) -> bytes:
    """BLAKE2b-160 over ``data``."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    h.update(_flat_view(data))
    return h.digest()


def digest_and_crc(data) -> Tuple[bytes, int]:
    """One scan, both checks: ``(blake2b_160_digest, crc32c)`` over the
    same pass through the buffer. The net tier calls this on the arena's
    staging view, so the cache key and the claim check share one read of
    the request body."""
    mv = _flat_view(data)
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    crc = 0
    for off in range(0, len(mv), _CHUNK):
        chunk = mv[off:off + _CHUNK]
        h.update(chunk)
        crc = _checksum.crc32c(chunk, crc)
    return h.digest(), crc


def request_key(digest: bytes, filter_name: str, reps: int, h: int,
                w: int, channels: int, boundary: int) -> tuple:
    """The full cache key: content digest plus every request parameter
    that reaches the kernel. Omitting any would alias distinct results."""
    return (
        digest, str(filter_name), int(reps), int(h), int(w),
        int(channels), int(boundary),
    )
