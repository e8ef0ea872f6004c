"""Headerless .raw uint8 image I/O.

File format (identical to the reference's): row-major bytes, grey = 1
byte/pixel (H*W bytes), RGB = 3 interleaved bytes/pixel (H*W*3 bytes), no
header — width/height supplied out of band.

Whole-image reads and atomic writes (the CUDA variant's model,
``cuda/main.c:22-44``) plus the row-range reader and the row/block writers
the per-rank MPI-IO pattern uses (``mpi/mpi_convolution.c:126-141,
247-263``). The native C++ library
from ``native/`` does the positional I/O when it is built; otherwise a
pure-Python fallback with identical semantics.
"""

from __future__ import annotations

import os
import stat as _stat

import numpy as np

from tpu_stencil_torch.io import native as _native


def _expected_bytes(width: int, height: int, channels: int) -> int:
    return width * height * channels


def require_regular(path: str, why: str) -> None:
    """Fail loudly when ``path`` is not a regular file: a caller that
    issues several positioned reads of one path (the sharded per-band
    read) cannot be served by a FIFO, whose every open goes on consuming
    the same byte stream."""
    if not _stat.S_ISREG(os.stat(path).st_mode):
        raise ValueError(
            f"{path}: not a regular file — {why} needs positioned "
            "re-reads, which a FIFO/pipe cannot serve"
        )


def fsync_path(path: str) -> None:
    """fsync ``path``'s data to stable storage (before the rename of the
    tmp-then-rename discipline)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """fsync the directory containing ``path`` (the rename lives in
    directory metadata). Best-effort: some filesystems refuse directory
    fsync, which degrades durability, never correctness."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_stream_into(f, view: memoryview) -> int:
    """Fill ``view`` from a sequential stream via ``readinto``; returns
    the bytes read, stopping early only at EOF."""
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            break
        got += n
    return got


def discard_stream_bytes(f, nbytes: int, what: str) -> None:
    """Read and drop ``nbytes`` from a sequential stream; raises naming
    ``what`` if the stream ends first."""
    remaining = nbytes
    while remaining:
        chunk = f.read(min(remaining, 1 << 20))
        if not chunk:
            raise IOError(
                f"{what}: stream ended {remaining} bytes short of the "
                f"{nbytes} to skip"
            )
        remaining -= len(chunk)


def _read_stream_bytes(path: str, offset: int, nbytes: int) -> bytes:
    """Sequential read of ``nbytes`` from a non-seekable source (FIFO /
    pipe / character device) after discarding ``offset`` bytes; short
    reads raise."""
    with open(path, "rb", buffering=0) as f:
        discard_stream_bytes(f, offset, path)
        buf = bytearray(nbytes)
        got = read_stream_into(f, memoryview(buf))
        if got < nbytes:
            raise IOError(
                f"{path}: short read {got}/{nbytes} from stream "
                f"(after {offset} skipped bytes)"
            )
        return bytes(buf)


def read_raw(path: str, width: int, height: int, channels: int) -> np.ndarray:
    """Read a whole raw image into an (H, W, C) uint8 array (C in {1, 3})."""
    return read_raw_rows(path, 0, height, width, channels)


def read_raw_rows(
    path: str, row_start: int, n_rows: int, width: int, channels: int
) -> np.ndarray:
    """Read rows [row_start, row_start + n_rows) into (n_rows, W, C) uint8.

    Regular files must hold at least the bytes addressed (the reference
    reads garbage from short files; this fails loudly). Non-regular
    sources (FIFO/pipe/stdin) skip the size check and read sequentially,
    failing loudly on short reads.
    """
    offset = row_start * width * channels
    nbytes = n_rows * width * channels
    if not _stat.S_ISREG(os.stat(path).st_mode):
        buf = _read_stream_bytes(path, offset, nbytes)
        return np.frombuffer(buf, dtype=np.uint8).reshape(
            n_rows, width, channels
        )
    size = os.path.getsize(path)
    if offset + nbytes > size:
        raise ValueError(
            f"{path}: need bytes [{offset}, {offset + nbytes}) but file has {size} "
            f"(rows {row_start}..{row_start + n_rows}, width {width}, "
            f"channels {channels})"
        )
    buf = _native.pread_full(path, offset, nbytes)
    return np.frombuffer(buf, dtype=np.uint8).reshape(n_rows, width, channels)


def write_raw(path: str, img: np.ndarray) -> None:
    """Write an (H, W, C) or (H, W) uint8 array as raw interleaved bytes,
    atomically: bytes land in a tmp file, are fsynced, and ``os.replace``
    publishes the final name, so a crash never leaves a torn output."""
    arr = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        _native.pwrite_full(tmp, 0, arr.tobytes(), truncate=True)
        fsync_path(tmp)
        os.replace(tmp, path)
    except BaseException:
        # Never leave a stray tmp beside the output on failure.
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise
    fsync_dir(path)


def write_raw_rows(
    path: str, row_start: int, rows: np.ndarray, width: int, channels: int,
    total_height: int,
) -> None:
    """Write a row shard at its global offset into a shared file, extended
    to the full image size first — every MPI rank ``MPI_File_write``-ing
    its rows at computed offsets (``mpi/mpi_convolution.c:247-263``)."""
    arr = np.ascontiguousarray(np.asarray(rows, dtype=np.uint8))
    if arr.ndim == 2:
        arr = arr[..., None]
    n_rows = arr.shape[0]
    if arr.shape[1] != width or arr.shape[2] != channels:
        raise ValueError(f"shard shape {arr.shape} != (*, {width}, {channels})")
    if row_start < 0 or row_start + n_rows > total_height:
        raise ValueError(f"rows [{row_start}, {row_start + n_rows}) outside image")
    _native.ensure_size(path, _expected_bytes(width, total_height, channels))
    offset = row_start * width * channels
    _native.pwrite_full(path, offset, arr.tobytes(), truncate=False)


def write_raw_block(
    path: str, row_start: int, col_start: int, block: np.ndarray,
    width: int, channels: int, total_height: int,
) -> None:
    """Write a rectangular (n_rows, n_cols, C) block at its global offsets
    into a shared file, one positioned write per row — the MPI subarray
    write (``mpi/mpi_convolution.c:247-263``) for column tiles. Bytes
    outside the block's columns are never touched, so writers of
    different column tiles of the same rows do not clobber each other."""
    arr = np.ascontiguousarray(np.asarray(block, dtype=np.uint8))
    if arr.ndim == 2:
        arr = arr[..., None]
    n_rows, n_cols = arr.shape[0], arr.shape[1]
    if arr.shape[2] != channels:
        raise ValueError(f"block shape {arr.shape} != (*, *, {channels})")
    if col_start < 0 or col_start + n_cols > width:
        raise ValueError(f"cols [{col_start}, {col_start + n_cols}) outside image")
    if row_start < 0 or row_start + n_rows > total_height:
        raise ValueError(f"rows [{row_start}, {row_start + n_rows}) outside image")
    if n_cols == width:
        write_raw_rows(path, row_start, arr, width, channels, total_height)
        return
    _native.ensure_size(path, _expected_bytes(width, total_height, channels))
    fd = os.open(path, os.O_WRONLY)
    try:
        row_bytes = arr.reshape(n_rows, -1)
        for k in range(n_rows):
            offset = ((row_start + k) * width + col_start) * channels
            view = memoryview(row_bytes[k]).cast("B")
            while view:
                written = os.pwrite(fd, view, offset)
                view = view[written:]
                offset += written
    finally:
        os.close(fd)
