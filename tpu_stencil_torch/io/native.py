"""ctypes binding to the native C++ I/O runtime, with a pure-Python fallback.

The native library (``native/io_runtime.cpp`` -> ``native/build/
libtpustencil_io.so``, built by ``make -C native``) provides robust
full-read/full-write positional I/O — the C++ equivalent of the
reference's short-read/short-write loops in ``cuda/functions.c:31-45``.
It is loaded when present and never built or moved from here; the
Python fallbacks implement the same contracts.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

_LIB_NAMES = ("libtpustencil_io.so",)


def _find_library() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [
        os.path.join(here, "..", "..", "native", "build", name)
        for name in _LIB_NAMES
    ]
    env = os.environ.get("TPU_STENCIL_NATIVE_LIB")
    if env:
        candidates.insert(0, env)
    for cand in candidates:
        cand = os.path.normpath(cand)
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            try:
                lib.ts_pread_full.restype = ctypes.c_int64
                lib.ts_pread_full.argtypes = [
                    ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ]
                lib.ts_pwrite_full.restype = ctypes.c_int64
                lib.ts_pwrite_full.argtypes = [
                    ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int,
                ]
                lib.ts_ensure_size.restype = ctypes.c_int
                lib.ts_ensure_size.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            except AttributeError:
                continue
            return lib
    return None


_LIB = _find_library()


def pread_full(path: str, offset: int, nbytes: int) -> bytes:
    """Read exactly ``nbytes`` at ``offset``; raises on short read."""
    if _LIB is not None:
        buf = ctypes.create_string_buffer(nbytes)
        got = _LIB.ts_pread_full(path.encode(), buf, offset, nbytes)
        if got != nbytes:
            raise IOError(f"{path}: short read {got}/{nbytes} at offset {offset}")
        return buf.raw
    with open(path, "rb") as f:
        f.seek(offset)
        chunks = []
        remaining = nbytes
        while remaining:
            chunk = f.read(remaining)
            if not chunk:
                raise IOError(
                    f"{path}: short read {nbytes - remaining}/{nbytes} at offset {offset}"
                )
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)


def pwrite_full(path: str, offset: int, data: bytes, truncate: bool = False) -> None:
    """Write all of ``data`` at ``offset``. ``truncate`` recreates the file."""
    if _LIB is not None:
        wrote = _LIB.ts_pwrite_full(path.encode(), data, offset, len(data), int(truncate))
        if wrote != len(data):
            raise IOError(f"{path}: short write {wrote}/{len(data)} at offset {offset}")
        return
    mode = "wb" if truncate else ("r+b" if os.path.exists(path) else "wb")
    with open(path, mode) as f:
        f.seek(offset)
        f.write(data)


def ensure_size(path: str, nbytes: int) -> None:
    """Extend (never shrink) ``path`` to at least ``nbytes`` bytes."""
    if _LIB is not None:
        if _LIB.ts_ensure_size(path.encode(), nbytes) != 0:
            raise IOError(f"{path}: ensure_size({nbytes}) failed")
        return
    if not os.path.exists(path) or os.path.getsize(path) < nbytes:
        with open(path, "ab") as f:
            f.truncate(nbytes)


def set_size(path: str, nbytes: int) -> None:
    """Set ``path`` to exactly ``nbytes`` bytes (creating it if missing);
    idempotent, so every writer of a sharded output may call it before
    writing its in-bounds tiles."""
    with open(path, "ab"):
        pass
    if os.path.getsize(path) != nbytes:
        with open(path, "r+b") as f:
            f.truncate(nbytes)
