"""Halo exchange between the tiles of an R x C grid, by strip copies.

The port's counterpart of the JAX package's ``parallel/halo.py``
(``lax.ppermute`` shifts inside ``shard_map``) and of the reference's
derived-datatype ``Isend/Irecv`` ghost ring
(``mpi/mpi_convolution.c:75-83,156-192``). Between two tiles of one
process a send is a slice of the neighbour's tile moved to the receiving
tile's device with ``.to``. When the tiles live in several processes
(``peers``, :class:`~tpu_stencil_torch.parallel.transport.Peers`), the
grid holds ``None`` for a tile another rank owns: a remote neighbour's
strip arrives by ``irecv``, and a local tile whose neighbour is remote
sends its edge by ``isend`` (one :class:`~tpu_stencil_torch.parallel.
transport.Batch` per phase).

* Ranks with no neighbour receive zeros — the reference's never-written
  calloc'd ghost ring; ``boundary='periodic'`` wraps to the opposite edge.
* An axis of one tile degrades to a zero pad (or, periodic, a wrap of the
  tile onto itself), as ``halo.py:70-75`` of the JAX package does.
* Corner ghosts need no diagonal copies: exchanging rows first, then
  columns *of the row-extended tiles*, routes corner data through the
  edge-adjacent neighbour.
* Every extended tile is a fresh tensor built from the tiles as they were
  before the exchange, so tiles that share one device never read a strip
  another tile's exchange has already overwritten; a strip sent to
  another process is taken from the same tiles.

A grid is a list of R rows of C tiles; tile dims 0 and 1 are its rows and
columns (a trailing channel dim rides along).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

Grid = List[List[Optional[torch.Tensor]]]


def _edge(x: torch.Tensor, dim: int, lo: bool, halo: int) -> torch.Tensor:
    n = x.shape[dim]
    return x.narrow(dim, 0, halo) if lo else x.narrow(dim, n - halo, halo)


def _zeros_strip(x: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = halo
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def halo_exchange_axis(tiles: Grid, halo: int, dim: int,
                       boundary: str = "zero", peers=None) -> Grid:
    """Extend every tile by ``halo`` ghost elements on both sides of
    ``dim`` (0 = rows, 1 = cols), filled from its neighbours along that
    axis of the grid. ``peers``: the tile owners when the grid spans
    several processes (remote tiles are ``None`` and stay so)."""
    if boundary not in ("zero", "periodic"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if halo == 0:
        return [list(row) for row in tiles]
    n_r, n_c = len(tiles), len(tiles[0])
    n = n_r if dim == 0 else n_c
    slots = ("n", "s") if dim == 0 else ("w", "e")
    batch = None if peers is None else peers.batch(
        f"halo.exchange[{'rows' if dim == 0 else 'cols'}]")

    def at(i: int, j: int, k: int):
        # The position k along the exchange axis, in (i, j)'s line.
        return (k, j) if dim == 0 else (i, k)

    out: Grid = [[None] * n_c for _ in range(n_r)]
    ghosts = {}
    for i in range(n_r):
        for j in range(n_c):
            x = tiles[i][j]
            k = i if dim == 0 else j
            for side, step, slot in ((0, -1, slots[0]), (1, 1, slots[1])):
                if not 0 <= k + step < n and boundary != "periodic":
                    if x is not None:
                        ghosts[i, j, side] = _zeros_strip(x, dim, halo)
                    continue
                si, sj = at(i, j, (k + step) % n)
                src = tiles[si][sj]
                if x is not None and src is not None:
                    ghosts[i, j, side] = _edge(src, dim, side == 1,
                                               halo).to(x.device)
                elif x is not None:
                    ghosts[i, j, side] = _zeros_strip(x, dim, halo)
                    batch.recv((i, j), slot, (si, sj), ghosts[i, j, side])
                elif src is not None:
                    batch.send((i, j), slot, _edge(src, dim, side == 1, halo))
    if batch is not None:
        batch.run()
    for i in range(n_r):
        for j in range(n_c):
            if tiles[i][j] is not None:
                out[i][j] = torch.cat([ghosts[i, j, 0], tiles[i][j],
                                       ghosts[i, j, 1]], dim)
    return out


def halo_exchange(tiles: Grid, halo: int, dims: Sequence[int] = (0, 1),
                  boundary: str = "zero", peers=None) -> Grid:
    """Full 2-D halo exchange: one phase per entry of ``dims``, each on the
    previous phase's extended tiles (rows then cols routes the corners)."""
    for dim in dims:
        tiles = halo_exchange_axis(tiles, halo, dim, boundary, peers)
    return tiles
