"""Halo exchange between the tiles of an R x C grid, by strip copies.

The port's counterpart of the JAX package's ``parallel/halo.py``
(``lax.ppermute`` shifts inside ``shard_map``) and of the reference's
derived-datatype ``Isend/Irecv`` ghost ring
(``mpi/mpi_convolution.c:75-83,156-192``). All tiles live in one process
(:mod:`tpu_stencil_torch.parallel.mesh`), so a send is a slice of the
neighbour's tile moved to the receiving tile's device with ``.to``.

* Ranks with no neighbour receive zeros — the reference's never-written
  calloc'd ghost ring; ``boundary='periodic'`` wraps to the opposite edge.
* An axis of one tile degrades to a zero pad (or, periodic, a wrap of the
  tile onto itself), as ``halo.py:70-75`` of the JAX package does.
* Corner ghosts need no diagonal copies: exchanging rows first, then
  columns *of the row-extended tiles*, routes corner data through the
  edge-adjacent neighbour.
* Every extended tile is a fresh tensor built from the tiles as they were
  before the exchange, so tiles that share one device never read a strip
  another tile's exchange has already overwritten.

A grid is a list of R rows of C tiles; tile dims 0 and 1 are its rows and
columns (a trailing channel dim rides along).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

Grid = List[List[torch.Tensor]]


def _edge(x: torch.Tensor, dim: int, lo: bool, halo: int) -> torch.Tensor:
    n = x.shape[dim]
    return x.narrow(dim, 0, halo) if lo else x.narrow(dim, n - halo, halo)


def _zeros_strip(x: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = halo
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def halo_exchange_axis(tiles: Grid, halo: int, dim: int,
                       boundary: str = "zero") -> Grid:
    """Extend every tile by ``halo`` ghost elements on both sides of
    ``dim`` (0 = rows, 1 = cols), filled from its neighbours along that
    axis of the grid."""
    if boundary not in ("zero", "periodic"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if halo == 0:
        return [list(row) for row in tiles]
    n_r, n_c = len(tiles), len(tiles[0])
    n = n_r if dim == 0 else n_c

    def tile_at(i: int, j: int, k: int) -> torch.Tensor:
        # The tile at position k along the exchange axis, in (i, j)'s line.
        return tiles[k][j] if dim == 0 else tiles[i][k]

    out: Grid = []
    for i in range(n_r):
        row = []
        for j in range(n_c):
            x = tiles[i][j]
            k = i if dim == 0 else j
            if k > 0 or boundary == "periodic":
                lo = _edge(tile_at(i, j, (k - 1) % n), dim, False, halo)
                lo = lo.to(x.device)
            else:
                lo = _zeros_strip(x, dim, halo)
            if k < n - 1 or boundary == "periodic":
                hi = _edge(tile_at(i, j, (k + 1) % n), dim, True, halo)
                hi = hi.to(x.device)
            else:
                hi = _zeros_strip(x, dim, halo)
            row.append(torch.cat([lo, x, hi], dim))
        out.append(row)
    return out


def halo_exchange(tiles: Grid, halo: int, dims: Sequence[int] = (0, 1),
                  boundary: str = "zero") -> Grid:
    """Full 2-D halo exchange: one phase per entry of ``dims``, each on the
    previous phase's extended tiles (rows then cols routes the corners)."""
    for dim in dims:
        tiles = halo_exchange_axis(tiles, halo, dim, boundary)
    return tiles
