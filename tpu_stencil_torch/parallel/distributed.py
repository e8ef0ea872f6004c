"""Sharded file I/O of one process: each mesh row's band read once, each
tile's in-bounds rectangle written at its global offsets.

The single-process part of the JAX package's ``parallel/distributed.py``
(``device_row_ranges``, ``read_sharded``, ``write_sharded``) — the MPI-IO
pattern of the reference (``mpi/mpi_convolution.c:126-141,247-263``).
Several processes (``torch.distributed`` set-up and the per-process
reads and writes) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpu_stencil_torch.io import native
from tpu_stencil_torch.io import raw as raw_io
from tpu_stencil_torch.parallel.halo import Grid
from tpu_stencil_torch.parallel.mesh import Mesh


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
    tile grid: each mesh row's band of rows is read from disk once
    (:func:`raw_io.read_raw_rows`) and cut into its column tiles, each
    placed on its device."""
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
    """Write every tile's in-bounds rectangle at its global offsets into
    one raw file, sized to exactly ``height * width * channels`` bytes
    first (a stale larger file keeps no trailing bytes)."""
    native.set_size(path, height * width * channels)
    th, tw = tiles[0][0].shape[0], tiles[0][0].shape[1]
    for i, row in enumerate(tiles):
        r0 = i * th
        n_rows = min(th, height - r0)
        if n_rows <= 0:
            continue
        for j, t in enumerate(row):
            c0 = j * tw
            n_cols = min(tw, width - c0)
            if n_cols <= 0:
                continue
            block = t.cpu().numpy()[:n_rows, :n_cols]
            raw_io.write_raw_block(path, r0, c0, block, width, channels,
                                   height)
