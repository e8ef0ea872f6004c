"""``halo_fill``: the pieces of one tile's ghost ring copied in one launch.

The kernel (``csrc/halo_fill.cu``) runs on the card of the ring it
fills and reads each piece from a neighbour's memory, on that card through
peer access or on its own: the pull of the mesh's exchange
(:mod:`tpu_stencil_torch.parallel.fill`). A :class:`Table` holds one
launch's pieces, each a ``(src, dst)`` pair of equal-shaped 2-D uint8
windows (unit lane stride, any row pitch), and is built once: its C table
of pointers and pitches is reused by every launch, so a CUDA graph that
captured one replays it. The library is built and loaded at the first
launch (``ShardedRunner.prepare`` builds it ahead). CPU tensors run the
plain version, :func:`fill_plain`, a ``copy_`` a piece.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Sequence, Tuple

import torch

from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops.cuda_stencil import (KernelLaunchError,
                                                 _check_window, row_pitch)

MAX_PIECES = 8


class _Piece(ctypes.Structure):
    # Mirrors HaloFillPiece in csrc/halo_fill.cu.
    _fields_ = [
        ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
        ("src_pitch", ctypes.c_longlong), ("dst_pitch", ctypes.c_longlong),
        ("rows", ctypes.c_int), ("width", ctypes.c_int),
    ]


class _Table(ctypes.Structure):
    # Mirrors HaloFillTable in csrc/halo_fill.cu.
    _fields_ = [("n", ctypes.c_int), ("pad", ctypes.c_int),
                ("piece", _Piece * MAX_PIECES)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("halo_fill")
    lib.halo_fill_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.halo_fill_launch.restype = ctypes.c_int
    lib.halo_fill_enable_peer.argtypes = [ctypes.c_int]
    lib.halo_fill_enable_peer.restype = ctypes.c_int
    lib.halo_fill_error_string.argtypes = [ctypes.c_int]
    lib.halo_fill_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().halo_fill_error_string(rc).decode(errors="replace")
        raise KernelLaunchError(
            f"{what} failed: cudaError_t {rc} ({msg})", rc)


def enable_peer(device: torch.device, peer: torch.device) -> None:
    """Let ``device`` read ``peer``'s memory (a no-op for one card, and
    when it already may)."""
    if device.index == peer.index:
        return
    with torch.cuda.device(device):
        _raise_on(_lib().halo_fill_enable_peer(peer.index),
                  f"peer access {device} -> {peer}")


class Table:
    """One launch's pieces: ``pairs`` of ``(src, dst)`` windows, every
    ``dst`` on ``device``, at most :data:`MAX_PIECES`. The views are kept
    (their memory must outlive the table); ``peer_pieces`` counts the
    pieces read from another device, ``nbytes`` every piece's bytes."""

    def __init__(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 device: torch.device) -> None:
        if len(pairs) > MAX_PIECES:
            raise ValueError(f"at most {MAX_PIECES} pieces a launch, got "
                             f"{len(pairs)}")
        self.pairs: List[Tuple[torch.Tensor, torch.Tensor]] = list(pairs)
        self.device = torch.device(device)
        for src, dst in self.pairs:
            _check_window(src)
            _check_window(dst)
            if src.shape != dst.shape or dst.device != self.device:
                raise ValueError(
                    f"a piece copies {tuple(src.shape)} on {src.device} "
                    f"into {tuple(dst.shape)} on {dst.device}, expected "
                    f"equal shapes into {self.device}")
        self.peer_pieces = sum(src.device != dst.device
                               for src, dst in self.pairs)
        self.nbytes = sum(dst.numel() for _, dst in self.pairs)
        self._c = None
        if self.device.type == "cuda" and self.pairs:
            self._c = _Table(n=len(self.pairs))
            for k, (src, dst) in enumerate(self.pairs):
                self._c.piece[k] = _Piece(
                    src.data_ptr(), dst.data_ptr(), row_pitch(src),
                    row_pitch(dst), dst.shape[0], dst.shape[1])

    def __len__(self) -> int:
        return len(self.pairs)


def fill_plain(table: Table) -> None:
    """The plain version: every piece by ``copy_``."""
    for src, dst in table.pairs:
        dst.copy_(src)


_COUNT_LOCK = threading.Lock()


def launch(table: Table) -> None:
    """One launch of ``halo_fill`` on the current stream of the table's
    card, which must already follow every write of the pieces' sources and
    every read of their destinations; nothing for a table of no pieces.
    CPU tables run :func:`fill_plain`."""
    if not table.pairs:
        return
    if table.device.type == "cpu":
        fill_plain(table)
        return
    lib = _lib()
    with torch.cuda.device(table.device):
        rc = lib.halo_fill_launch(
            ctypes.addressof(table._c),
            torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(rc, "halo_fill launch")
    with _COUNT_LOCK:
        launch.launches += 1


launch.launches = 0
