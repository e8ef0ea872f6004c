"""Frame sources and sinks for the streaming engine.

The port's counterpart of the JAX package's ``stream/frames.py`` (all of
it but the sharded stream's ``TileScatter``, which comes with that
engine). The container contract is ``io/raw.py``'s, lifted to streams: a
frame is
``H*W*C`` headerless bytes (trust-the-geometry — width/height/channels
are supplied out of band), and a *stream* is either

* one concatenated ``.raw`` stream — a regular file, a FIFO/pipe, or
  stdin/stdout (``"-"``); no header, no framing, EOF is the only
  terminator; or
* a directory of per-frame ``.raw`` files, consumed/produced in sorted
  name order (``frame_000000.raw`` ...).

Sources fill caller-owned staging buffers in place (``read_into``: the
engine hands it a numpy view of one pinned host slot of its ring, and the
bytes land there with ``readinto``, no intermediate ``bytes``; steady
state allocates nothing on the host) and
fail loudly on short reads: a stream that ends mid-frame is an error
with the frame index, never silent garbage (the same discipline
``io/raw.py`` applies to short files). A :class:`NullSink` discards
output for benchmarking the pipeline without a disk-write stage.
"""

from __future__ import annotations

import os
import stat as _stat
import sys
from typing import BinaryIO, List

import numpy as np

from tpu_stencil_torch.io.raw import discard_stream_bytes, read_stream_into

FRAME_PATTERN = "frame_{:06d}.raw"


class FrameSource:
    """Sequential frame producer. Context-managed; single consumer."""

    def read_into(self, buf: np.ndarray) -> bool:
        """Fill ``buf`` (1-D uint8, one frame) with the next frame.
        Returns False on clean EOF (no bytes read); raises ``IOError``
        on a short read (stream ended mid-frame)."""
        raise NotImplementedError

    def skip(self, n: int) -> None:
        """Advance past ``n`` frames (resume support). Seekable sources
        seek; pipes read and discard."""
        raise NotImplementedError

    def mark(self):
        """A rewind point for transient-read retries: a zero-arg
        callable restoring the source to its current position, or None
        when the position cannot be restored (a pipe's consumed bytes
        are gone): the engine only retries reads when a mark exists
        (:mod:`tpu_stencil_torch.resilience.retry`)."""
        return None

    def close(self) -> None:
        pass

    def __enter__(self) -> "FrameSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FrameSink:
    """In-order frame consumer. Context-managed; single producer. The
    engine guarantees ``write`` is called with strictly increasing
    frame indices starting at the resume point.

    ``retryable_writes``: True when ``write(index, frame)`` is
    idempotent (re-writing an index lands the same bytes in the same
    place — positioned file writes, per-frame directory files), so the
    engine may retry a transient write failure; append-only streams
    (stdout, pipes) are False — a retried partial write would duplicate
    bytes."""

    retryable_writes = False

    def write(self, index: int, frame: np.ndarray) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Durability point before a progress checkpoint commits."""
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "FrameSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RawStreamSource(FrameSource):
    """Concatenated headerless frames from one byte stream: a regular
    file, a FIFO/pipe path, or stdin (``"-"``). Regular files validate
    total size divisibility lazily (EOF mid-frame raises); pipes are
    pure sequential reads — the contract ``io/raw.py:read_raw_rows``
    applies to non-regular files."""

    def __init__(self, path: str, frame_bytes: int):
        self.path = path
        self.frame_bytes = frame_bytes
        self._frames_read = 0
        if path == "-":
            self._f: BinaryIO = sys.stdin.buffer
            self._owns = False
        else:
            self._f = open(path, "rb", buffering=0)
            self._owns = True

    def read_into(self, buf: np.ndarray) -> bool:
        view = memoryview(buf).cast("B")
        assert len(view) == self.frame_bytes
        got = read_stream_into(self._f, view)
        if got == 0:
            return False
        if got < self.frame_bytes:
            raise IOError(
                f"{self.path}: stream ended mid-frame "
                f"(frame {self._frames_read}: {got}/{self.frame_bytes} bytes)"
            )
        self._frames_read += 1
        return True

    def skip(self, n: int) -> None:
        if n <= 0:
            return
        nbytes = n * self.frame_bytes
        if self._f.seekable():
            self._f.seek(nbytes, os.SEEK_CUR)
        else:
            discard_stream_bytes(
                self._f, nbytes, f"{self.path} (skipping {n} resumed frames)"
            )
        self._frames_read += n

    def mark(self):
        if not self._f.seekable():
            return None  # a pipe's consumed bytes cannot be re-read
        pos = self._f.tell()
        frames = self._frames_read

        def restore() -> None:
            self._f.seek(pos)
            self._frames_read = frames

        return restore

    def close(self) -> None:
        if self._owns:
            self._f.close()


class RawDirectorySource(FrameSource):
    """A sorted directory of per-frame ``.raw`` files. Each file must be
    exactly one frame; a wrong-sized file fails loudly with its name
    (the directory analog of the short-read contract)."""

    def __init__(self, path: str, frame_bytes: int):
        self.path = path
        self.frame_bytes = frame_bytes
        self._names: List[str] = sorted(
            n for n in os.listdir(path) if n.endswith(".raw")
        )
        self._i = 0

    def __len__(self) -> int:
        return len(self._names)

    def read_into(self, buf: np.ndarray) -> bool:
        if self._i >= len(self._names):
            return False
        name = os.path.join(self.path, self._names[self._i])
        size = os.path.getsize(name)
        if size != self.frame_bytes:
            raise IOError(
                f"{name}: frame file holds {size} bytes, "
                f"expected {self.frame_bytes}"
            )
        view = memoryview(buf).cast("B")
        with open(name, "rb", buffering=0) as f:
            got = read_stream_into(f, view)
        if got != self.frame_bytes:
            raise IOError(f"{name}: short read {got}/{self.frame_bytes}")
        self._i += 1
        return True

    def skip(self, n: int) -> None:
        self._i += max(0, n)

    def mark(self):
        i = self._i

        def restore() -> None:
            self._i = i

        return restore


class RawStreamSink(FrameSink):
    """Concatenated headerless frames to one byte stream: a regular
    file, a FIFO/pipe path, or stdout (``"-"``). ``start_frame``
    (resume) positions a regular file at the resume offset; pipes
    cannot resume mid-stream and refuse."""

    def __init__(self, path: str, frame_bytes: int, start_frame: int = 0):
        self.path = path
        self.frame_bytes = frame_bytes
        if path == "-":
            self._f: BinaryIO = sys.stdout.buffer
            self._owns = False
            if start_frame:
                raise ValueError("cannot resume a stream into stdout")
        else:
            exists = os.path.exists(path)
            if start_frame and not exists:
                raise ValueError(
                    f"cannot resume: sink {path} does not exist"
                )
            self._f = open(path, "r+b" if (start_frame and exists) else "wb")
            self._owns = True
            if start_frame:
                if not self._f.seekable():
                    self._f.close()
                    raise ValueError(
                        f"cannot resume a stream into non-seekable {path}"
                    )
                self._f.seek(start_frame * frame_bytes)
                self._f.truncate()
        # Positioned writes on seekable files make write(index, ...)
        # idempotent — frame i's home is exactly i*frame_bytes — so a
        # transient failure can be retried without duplicating bytes.
        # Pipes stay append-only and non-retryable, and stdout is
        # excluded unconditionally (a capture harness can make it
        # claim seekability it must not be trusted with).
        self.retryable_writes = self._owns and self._f.seekable()

    def write(self, index: int, frame: np.ndarray) -> None:
        if self.retryable_writes:
            self._f.seek(index * self.frame_bytes)
        # Buffer-protocol write: ascontiguousarray is a no-op view for
        # the already-contiguous uint8 arrays the engine drains, so a
        # frame is NOT copied again on its way out (tobytes() would
        # memcpy every frame inside the stage that bounds a write-bound
        # stream's throughput).
        arr = np.ascontiguousarray(frame, dtype=np.uint8)
        self._f.write(memoryview(arr).cast("B"))

    def flush(self) -> None:
        """Durability point (a progress checkpoint is about to commit):
        flush AND fsync owned regular files — a checkpoint recording
        "frames [0, n) are durable" must not be ordered ahead of the
        frames themselves in the page cache. Pipes/stdout only flush
        (fsync is meaningless there, and their sinks are not resumable
        anyway)."""
        self._f.flush()
        if self._owns:
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass  # non-regular sink (FIFO): flush is all there is

    def close(self) -> None:
        self.flush()
        if self._owns:
            self._f.close()


class RawDirectorySink(FrameSink):
    """One ``frame_%06d.raw`` file per frame, atomic per frame: bytes
    land in a tmp file and ``os.replace`` publishes the final name
    (the checkpoint sidecars' discipline), so a crash mid-write
    can never leave a torn frame under a complete-looking name. Resume
    is natural — frame files are keyed by index, rewrites idempotent."""

    retryable_writes = True  # per-index atomic files: rewrites idempotent

    def __init__(self, path: str, frame_bytes: int, start_frame: int = 0):
        self.path = path
        self.frame_bytes = frame_bytes
        os.makedirs(path, exist_ok=True)

    def write(self, index: int, frame: np.ndarray) -> None:
        name = os.path.join(self.path, FRAME_PATTERN.format(index))
        arr = np.ascontiguousarray(frame, dtype=np.uint8)
        tmp = name + ".tmp"
        with open(tmp, "wb") as f:
            f.write(memoryview(arr).cast("B"))
            # fsync BEFORE the rename: without it a power cut can
            # publish the name over still-dirty data — a torn frame
            # under a complete-looking name, the exact hole the atomic
            # publish exists to close.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, name)


class NullSink(FrameSink):
    """Discard frames — benchmark the pipeline without a write stage."""

    retryable_writes = True  # discarding is trivially idempotent

    def __init__(self, *a, **k):
        self.frames_written = 0

    def write(self, index: int, frame: np.ndarray) -> None:
        self.frames_written += 1


def _is_dir_spec(spec: str) -> bool:
    return spec.endswith(os.sep) or os.path.isdir(spec)


def open_source(spec: str, frame_bytes: int) -> FrameSource:
    """Resolve a source spec: ``"-"`` = stdin, an existing directory =
    sorted per-frame files, anything else = one concatenated byte
    stream (regular file or FIFO — non-regular paths are read purely
    sequentially)."""
    if spec != "-" and _is_dir_spec(spec):
        return RawDirectorySource(spec.rstrip(os.sep), frame_bytes)
    return RawStreamSource(spec, frame_bytes)


def open_sink(spec: str, frame_bytes: int, start_frame: int = 0) -> FrameSink:
    """Resolve a sink spec: ``"null"`` = discard, ``"-"`` = stdout, a
    directory (existing, or a trailing-separator path) = per-frame
    files, anything else = one concatenated stream file/pipe."""
    if spec == "null":
        return NullSink()
    if spec != "-" and _is_dir_spec(spec):
        return RawDirectorySink(spec.rstrip(os.sep), frame_bytes, start_frame)
    return RawStreamSink(spec, frame_bytes, start_frame)


def is_restartable_source(spec: str) -> bool:
    """True when a fresh ``open_source`` of ``spec`` can re-serve frames
    an earlier open already consumed (a regular file seeks, a frame
    directory re-lists) — the gate on the engine's mid-stream restart:
    a pipe/FIFO/stdin's consumed frames are gone, so restarting one
    would silently drop them."""
    if spec == "-":
        return False
    if _is_dir_spec(spec):
        return True
    return os.path.exists(spec) and _stat.S_ISREG(os.stat(spec).st_mode)


def is_resumable_sink(spec: str) -> bool:
    """True when progress into this sink survives a restart (a real
    filesystem artifact): checkpointing into 'null', stdout, or a FIFO
    would record progress no one can resume from."""
    if spec in ("null", "-"):
        return False
    if _is_dir_spec(spec):
        return True
    if os.path.exists(spec):
        return _stat.S_ISREG(os.stat(spec).st_mode)
    return True  # a not-yet-created regular stream file
