"""CRC32C (Castagnoli) content checksum.

The port's own copy of what it needs from the JAX package's
``integrity/checksum.py``: :func:`crc32c`, which guards the autotune
cache's entries (a digit flipped on disk inside ``"fuse": 8`` still parses
as JSON; the CRC sees it). The same values as any standard CRC32C (poly
0x1EDC6F41 reflected; ``crc32c(b"123456789") == 0xE3069283``):
``google_crc32c`` when importable, else a pure-Python table.
"""

from __future__ import annotations

import numpy as np


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
    """Table-driven, a byte at a time: slow, and enough for cache entries."""
    crc = (~value) & 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return (~crc) & 0xFFFFFFFF


try:  # the C fast path, when the wheel is present
    import google_crc32c as _gcrc

    def _crc32c_fast(data: bytes, value: int = 0) -> int:
        return _gcrc.extend(value, data)

    IMPLEMENTATION = f"google_crc32c ({_gcrc.implementation})"
except ImportError:  # pragma: no cover - exercised where the wheel is absent
    _crc32c_fast = _crc32c_py
    IMPLEMENTATION = "python"


def crc32c(data, value: int = 0) -> int:
    """The CRC32C of ``data`` (bytes-like or a uint8 ndarray), optionally
    extending a running ``value``. Arrays are checksummed over their
    contiguous row-major bytes."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).view(np.uint8)
        data = memoryview(data.reshape(-1)).cast("B")
    return _crc32c_fast(bytes(data) if isinstance(data, memoryview)
                        else data, value)
