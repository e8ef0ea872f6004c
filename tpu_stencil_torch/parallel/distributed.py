"""Several processes: bring-up, rank 0's config, per-process sharded I/O.

The port's counterpart of the JAX package's ``parallel/distributed.py``
and of the reference's multi-node MPI machinery:

* process bring-up (``MPI_Init``, ``mpi/mpi_convolution.c:23``;
  ``mpiexec -n P``) -> :func:`initialize`, a ``torch.distributed`` gloo
  group from the environment ``python -m torch.distributed.run`` sets
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
  explicit arguments;
* rank 0 validates and ``MPI_Bcast``\\ s the job
  (``mpi/mpi_convolution.c:50-70``) -> :func:`broadcast_config`;
* per-rank MPI-IO reads and writes (``mpi/mpi_convolution.c:126-141,
  247-263``) -> :func:`read_sharded` / :func:`write_sharded`: a process
  touches only the row bands and column rectangles of the tiles it owns
  (:attr:`Mesh.owners`), reads each band once, and merges contiguous
  column tiles of a band into one write.

gloo is asked for by name and nothing else is tried: it carries the
host-side collectives here and the staged strips of
:mod:`tpu_stencil_torch.parallel.transport`, on the CPU and between ranks
that share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_stencil_torch.config import ImageType, JobConfig
from tpu_stencil_torch.io import native
from tpu_stencil_torch.io import raw as raw_io
from tpu_stencil_torch.parallel.halo import Grid
from tpu_stencil_torch.parallel.mesh import Mesh


def _dist():
    import torch.distributed as dist

    return dist


def _group_active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _dist().get_rank() if _group_active() else 0


def process_count() -> int:
    """The number of processes of the job (1 without a process group)."""
    return _dist().get_world_size() if _group_active() else 1


def _looks_multiprocess() -> bool:
    """Whether the environment names a job of several processes (what
    ``torch.distributed.run`` sets)."""
    return os.environ.get("WORLD_SIZE", "1").strip() not in ("", "1")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 0.0,
) -> None:
    """Join the job's gloo process group; a no-op when the group exists
    already, or when no argument is given and ``WORLD_SIZE`` is unset or
    1. Call it first in the process (the CLI does), like ``MPI_Init``
    leading ``main``.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` name the rendezvous explicitly; without them it comes
    from the environment (``env://``). A multi-process environment whose
    bring-up fails raises: a rank that went on alone while its peers wait
    in collectives would write the shared output by itself.

    ``timeout_s`` > 0 (the job's ``--dispatch-timeout``) bounds the
    rendezvous and every collective of the group, so a dead peer fails
    the run in that time and not in gloo's default 30 minutes."""
    if _group_active():
        return
    kw = {}
    if timeout_s and timeout_s > 0:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None or num_processes is not None:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "initialize() with explicit arguments needs "
                "coordinator_address, num_processes and process_id")
        _dist().init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kw)
        return
    if not _looks_multiprocess():
        return
    _dist().init_process_group("gloo", init_method="env://", **kw)


def wait(work, timeout_s: float = 0.0, label: str = "collective") -> None:
    """Wait for one ``torch.distributed`` operation: at most ``timeout_s``
    seconds when > 0 (a peer that never answers raises
    :class:`~tpu_stencil_torch.resilience.errors.DispatchTimeout`, counted
    in ``resilience_dispatch_timeouts_total``), else as long as the group's
    own timeout allows."""
    if not timeout_s or timeout_s <= 0:
        work.wait()
        return
    try:
        work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        if "Timed out" not in str(e):
            raise
        from tpu_stencil_torch import obs
        from tpu_stencil_torch.resilience.errors import DispatchTimeout

        obs.registry().counter("resilience_dispatch_timeouts_total").inc()
        raise DispatchTimeout(label, timeout_s) from e


def barrier(timeout_s: float = 0.0) -> None:
    """Every process reaches this point before any goes on (the
    reference's ``MPI_Barrier``), waiting as :func:`wait` does; a no-op
    with one process."""
    if process_count() > 1:
        wait(_dist().barrier(async_op=True), timeout_s, "barrier")


# ---------------------------------------------------------------------------
# Host-side broadcast and gather
# ---------------------------------------------------------------------------

_STR_BUF = 1024


def _encode_strs(strs: Sequence[str]) -> np.ndarray:
    # \x01 terminator so empty trailing strings survive the zero-padding
    blob = "\x00".join(strs).encode() + b"\x01"
    if len(blob) > _STR_BUF:
        raise ValueError("config strings too long to broadcast")
    out = np.zeros(_STR_BUF, np.uint8)
    out[: len(blob)] = np.frombuffer(blob, np.uint8)
    return out


def _decode_strs(arr: np.ndarray) -> List[str]:
    blob = bytes(np.asarray(arr, np.uint8)).rstrip(b"\x00")
    if not blob.endswith(b"\x01"):
        raise ValueError("malformed config string broadcast")
    return blob[:-1].decode().split("\x00")


def broadcast_strs(strs: Sequence[str]) -> List[str]:
    """Rank 0's ``strs`` on every rank (what the others pass is ignored;
    it must have the same length). Identity with one process."""
    if process_count() == 1:
        return list(strs)
    buf = torch.from_numpy(_encode_strs(strs) if process_index() == 0
                           else np.zeros(_STR_BUF, np.uint8))
    _dist().broadcast(buf, src=0)
    return _decode_strs(buf.numpy())


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's ``payload``, in rank order, on every rank."""
    if process_count() == 1:
        return [payload]
    dist = _dist()
    n = process_count()
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, size)
    cap = max(int(s.item()) for s in sizes)
    buf = torch.zeros(cap, dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload),
                                               dtype=torch.uint8)
    bufs = [torch.zeros(cap, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [bytes(b[: int(s.item())].numpy()) for b, s in zip(bufs, sizes)]


def broadcast_config(cfg: Optional[JobConfig]) -> JobConfig:
    """Rank 0 validates and broadcasts the job config; other ranks pass
    None (or their own, ignored) and receive rank 0's (the ``MPI_Bcast``
    x6 of ``mpi/mpi_convolution.c:65-70``). Every field crosses. One
    process: identity."""
    if process_count() == 1:
        assert cfg is not None
        return cfg
    mr, mc = (-1, -1)
    strs = [""] * 11
    if process_index() == 0:
        assert cfg is not None
        mr, mc = cfg.mesh_shape if cfg.mesh_shape is not None else (-1, -1)
        strs = [cfg.image, cfg.filter_name, cfg.backend,
                cfg.output if cfg.output is not None else "",
                cfg.schedule if cfg.schedule is not None else "",
                cfg.boundary, cfg.overlap, cfg.fallback_backend or "",
                repr(float(cfg.dispatch_timeout_s)), cfg.image_type.value,
                " ".join(str(v) for v in (
                    cfg.width, cfg.height, cfg.repetitions, mr, mc,
                    cfg.frames,
                    cfg.block_h if cfg.block_h is not None else -1,
                    cfg.fuse if cfg.fuse is not None else -1))]
    (image, filter_name, backend, output, schedule, boundary, overlap,
     fallback, timeout, image_type, ints) = broadcast_strs(strs)
    width, height, reps, mr, mc, frames, block_h, fuse = (
        int(v) for v in ints.split())
    return JobConfig(
        image=image,
        width=width,
        height=height,
        repetitions=reps,
        image_type=ImageType(image_type),
        filter_name=filter_name,
        backend=backend,
        mesh_shape=(mr, mc) if mr > 0 else None,
        output=output or None,
        frames=frames,
        schedule=schedule or None,
        boundary=boundary,
        block_h=block_h if block_h > 0 else None,
        fuse=fuse if fuse > 0 else None,
        dispatch_timeout_s=float(timeout),
        fallback_backend=fallback or None,
        overlap=overlap,
    )


# ---------------------------------------------------------------------------
# Per-process sharded I/O
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowRange:
    """Rows [start, stop) owned by one device tile."""

    start: int
    stop: int


def device_row_ranges(
    padded_h: int, padded_w: int, mesh_shape: Tuple[int, int]
) -> dict:
    """Map (mesh row, mesh col) -> (RowRange, col_start, n_cols) in pixel
    units for sharded file access — the ``offset`` arithmetic of
    ``mpi/mpi_convolution.c:324-326`` generalized to a 2-D grid."""
    r, c = mesh_shape
    th, tw = padded_h // r, padded_w // c
    out = {}
    for i in range(r):
        for j in range(c):
            out[(i, j)] = (RowRange(i * th, (i + 1) * th), j * tw, tw)
    return out


def read_sharded(path: str, height: int, width: int, channels: int,
                 mesh: Mesh) -> Grid:
    """The tile grid of a raw image over ``mesh``, padded with zeros to the
    tile grid: each tile this process holds is cut from its mesh row's
    band of rows, read from disk once (:func:`raw_io.read_raw_rows`), and
    placed on its device; another rank's tile is ``None`` and its band is
    not read here."""
    raw_io.require_regular(path, "sharded per-band input")
    r, c = mesh.grid
    padded_h = -(-height // r) * r
    padded_w = -(-width // c) * c
    ranges = device_row_ranges(padded_h, padded_w, (r, c))
    th, tw = padded_h // r, padded_w // c
    tiles = []
    for i, drow in enumerate(mesh.devices):
        band = None
        row = []
        for j, dev in enumerate(drow):
            if not mesh.is_local(i, j):
                row.append(None)
                continue
            rr, col0, tile_cols = ranges[(i, j)]
            tile = np.zeros((th, tw, channels), np.uint8)
            n_rows = max(0, min(rr.stop, height) - rr.start)
            n_cols = max(0, min(col0 + tile_cols, width) - col0)
            if n_rows and n_cols:
                if band is None:
                    band = raw_io.read_raw_rows(path, rr.start, n_rows,
                                                width, channels)
                tile[:n_rows, :n_cols] = band[:, col0:col0 + n_cols]
            if channels == 1:
                tile = tile[..., 0]
            row.append(torch.from_numpy(tile).to(dev))
        tiles.append(row)
    return tiles


def write_sharded(path: str, tiles: Grid, height: int, width: int,
                  channels: int) -> None:
    """Write the in-bounds rectangle of every tile this process holds at
    its global offsets into one raw file, sized to exactly ``height *
    width * channels`` bytes first (idempotent, so every process may size
    it; a stale larger file keeps no trailing bytes). Contiguous column
    tiles of one mesh row are merged into one write; no byte outside the
    process's own tiles is touched."""
    native.set_size(path, height * width * channels)
    held = [t for row in tiles for t in row if t is not None]
    if not held:
        return
    th, tw = held[0].shape[0], held[0].shape[1]
    for i, row in enumerate(tiles):
        r0 = i * th
        n_rows = min(th, height - r0)
        if n_rows <= 0:
            continue
        run_c0, parts = 0, []
        for j, t in enumerate(list(row) + [None]):
            n_cols = min(tw, width - j * tw)
            if t is not None and n_cols > 0:
                if not parts:
                    run_c0 = j * tw
                parts.append(t.cpu().numpy()[:n_rows, :n_cols])
                continue
            if parts:
                block = (parts[0] if len(parts) == 1
                         else np.concatenate(parts, axis=1))
                raw_io.write_raw_block(path, r0, run_c0, block, width,
                                       channels, height)
                parts = []
