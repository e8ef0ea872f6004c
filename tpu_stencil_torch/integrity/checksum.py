"""CRC32C (Castagnoli) content checksum, and the typed integrity failures.

The port's own copy of what it needs from the JAX package's
``integrity/checksum.py``: :func:`crc32c`, which guards the autotune
cache's entries and the checkpoint sidecars (a digit flipped on disk
inside ``"fuse": 8`` still parses as JSON; the CRC sees it) and every
frame of a stream (:mod:`tpu_stencil_torch.stream.engine` checksums each
staging slot when the reader fills it and again before its copy to the
card); :func:`verify`, :class:`ChecksumMismatch`, :class:`WitnessMismatch`
the deterministic corruption of the chaos sites (:func:`fired`,
:func:`corrupt_array`, :func:`corrupt_bytes`), the wire stamps a client
checks (:data:`CRC_HEADER`, :data:`RESULT_HEADER`, :func:`stamp_matches`)
and the network tier's request-claim rule (:func:`claim_error`). The same
values as any standard CRC32C (poly 0x1EDC6F41 reflected;
``crc32c(b"123456789") == 0xE3069283``).

Buffers of :data:`NATIVE_MIN_BYTES` or more go through the port's own C++
library (``ops/csrc/crc32c.cpp``: the SSE4.2 ``crc32`` instruction over
three lanes, or slicing-by-8), built at first use by
:mod:`tpu_stencil_torch.ops._build` and called through ctypes, which
releases the GIL for the call; a failed build raises
:class:`~tpu_stencil_torch.ops._build.KernelBuildError`, and nothing falls
back to the byte loop. Smaller buffers (cache entries, sidecars) take the
pure-Python table, which is also the tests' oracle; a stream's frames
take the library whatever their size (:func:`native_crc32c`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

#: Optional request header: the client's CRC32C of the request body.
CRC_HEADER = "X-Content-Crc32c"

#: Response header on every 200 payload: the CRC32C of the result bytes,
#: computed server-side after the compute.
RESULT_HEADER = "X-Result-Crc32c"

# Below this many bytes the table loop is cheaper than a ctypes call, and
# a cache entry or a sidecar never needs the built library.
NATIVE_MIN_BYTES = 4096


class ChecksumMismatch(ValueError):
    """Bytes no longer match the CRC32C taken when they were produced: a
    torn host buffer, a flipped bit on disk or on the wire. Permanent for
    this payload (``ValueError``): its true bytes are gone, and no retry
    or restart can bring them back."""

    def __init__(self, where: str, expected: int, got: int) -> None:
        super().__init__(
            f"ChecksumMismatch at {where}: crc32c {got} != expected "
            f"{expected} (bytes changed after they were checksummed)"
        )
        self.where = where
        self.expected = expected
        self.got = got


class WitnessMismatch(ValueError):
    """A witness re-execution disagreed bit-exact with the result it
    checks. Two measured-equivalent programs must agree, so a divergence
    is a hardware or runtime fault on the serving path: permanent for
    this result (``ValueError``)."""

    def __init__(self, where: str, detail: str = "") -> None:
        super().__init__(
            f"WitnessMismatch at {where}: witness re-execution disagrees "
            f"with the served result{': ' if detail else ''}{detail}"
        )
        self.where = where


# -- the CRC32C implementation ------------------------------------------

def _make_table() -> list:
    poly = 0x82F63B78  # 0x1EDC6F41 reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _make_table()


def _crc32c_py(data: bytes, value: int = 0) -> int:
    """Table-driven, a byte at a time: slow (tens of MB/s), and enough
    for cache entries and sidecars."""
    crc = (~value) & 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return (~crc) & 0xFFFFFFFF


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def native_library() -> ctypes.CDLL:
    """The built ``crc32c`` library (built at first use), its entry points
    bound. Raises ``KernelBuildError`` when it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from tpu_stencil_torch.ops import _build

            lib = _build.load("crc32c")
            for fn in (lib.crc32c_extend, lib.crc32c_extend_portable):
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                               ctypes.c_size_t]
            lib.crc32c_hardware.restype = ctypes.c_int
            lib.crc32c_hardware.argtypes = []
            _lib = lib
        return _lib


def implementation() -> str:
    """Which native path runs: ``"sse4.2"`` or ``"slicing-by-8"``."""
    return "sse4.2" if native_library().crc32c_hardware() else "slicing-by-8"


def _as_array(data) -> np.ndarray:
    """A flat contiguous uint8 view of ``data`` (no copy when it already
    is one)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return np.frombuffer(data, np.uint8)


def native_crc32c(data, value: int = 0) -> int:
    """:func:`crc32c` through the built library whatever the size: the
    stream's checksum of every frame, which never takes the byte loop."""
    arr = _as_array(data)
    return int(native_library().crc32c_extend(
        value & 0xFFFFFFFF, arr.ctypes.data, arr.size))


def crc32c(data, value: int = 0) -> int:
    """The CRC32C of ``data`` (bytes-like or a uint8 ndarray), optionally
    extending a running ``value``. Arrays are checksummed over their
    contiguous row-major bytes, so an array's CRC and the CRC of its
    ``.tobytes()`` agree."""
    arr = _as_array(data)
    if arr.size < NATIVE_MIN_BYTES:
        return _crc32c_py(arr.tobytes(), value)
    return native_crc32c(arr, value)


def verify(data, expected: int, where: str) -> None:
    """Raise :class:`ChecksumMismatch` unless the CRC32C of ``data``
    (:func:`native_crc32c`, as the stream took it) equals ``expected``."""
    got = native_crc32c(data)
    if got != int(expected):
        raise ChecksumMismatch(where, int(expected), got)


def parse_crc(value: str, where: str) -> int:
    """Parse a wire CRC header (unsigned decimal). A malformed header is
    a plain ``ValueError``."""
    try:
        n = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{where}: malformed crc32c {value!r} (unsigned decimal "
            f"expected)"
        ) from None
    if not 0 <= n <= 0xFFFFFFFF:
        raise ValueError(f"{where}: crc32c {n} outside uint32 range")
    return n


def claim_error(claim: str, body, computed: Optional[int] = None):
    """Validate a client ``X-Content-Crc32c`` claim against ``body``: the
    one request-validation rule of the HTTP edge. Returns None when the
    claim matches, else ``(error_text, is_mismatch)`` for the 400:
    ``is_mismatch`` tells a real corruption (counted) from a malformed
    header (a client bug, not a detection). ``computed`` is a CRC the
    caller already holds for these exact bytes (the cache's fused
    digest and CRC scan), so the body is not read twice."""
    try:
        want = parse_crc(claim, CRC_HEADER)
    except ValueError as e:
        return f"bad request parameters: {e}", False
    got = int(computed) if computed is not None else crc32c(body)
    if got != want:
        return (
            f"ChecksumMismatch: request body crc32c {got} != declared "
            f"{want} (body corrupted in flight or torn at the sender)",
            True,
        )
    return None


def stamp_matches(stamp: Optional[str], data: bytes) -> bool:
    """Whether a response's ``X-Result-Crc32c`` stamp verifies ``data``
    (the client-side check). A missing or malformed stamp is a failure:
    wire corruption can hit the header bytes as easily as the body."""
    if stamp is None:
        return False
    try:
        want = parse_crc(stamp, RESULT_HEADER)
    except ValueError:
        return False
    return crc32c(data) == want


# -- deterministic corruption (the chaos side of the contract) ----------
#
# The integrity.corrupt_ingest / integrity.corrupt_result / net.corrupt_body
# fault points do not RAISE like other points: they flip bits, so every
# detection path is exercised against genuinely wrong bytes. The flip is
# deterministic (middle byte, low bit), so a detected corruption replays
# exactly.

def fired(site, index: Optional[int] = None) -> bool:
    """Fire an armed corruption rule at ``site``; True when it fired. The
    harness signals a firing by raising; here the raise is the signal to
    corrupt, not an error (``FatalInjectedFault`` still escapes)."""
    if site is None:
        return False
    try:
        site(index)
    except Exception:
        return True
    return False


def corrupt_bytes(data: bytes) -> bytes:
    """``data`` with one deterministic bit flipped (the middle byte, bit
    0). Empty payloads return empty: nothing to corrupt."""
    if not data:
        return data
    out = bytearray(data)
    out[len(data) // 2] ^= 0x01
    return bytes(out)


def corrupt_array(arr: np.ndarray) -> np.ndarray:
    """A uint8 array with one deterministic bit flipped (the middle byte,
    bit 0, as :func:`corrupt_bytes` and the JAX package's). Writable
    arrays are corrupted IN PLACE (a torn staging buffer must damage the
    real buffer); read-only views are copied first."""
    if arr.size == 0:
        return arr
    if not arr.flags.writeable:
        arr = arr.copy()
    flat = arr.reshape(-1)
    flat[flat.size // 2] ^= 0x01
    return arr
