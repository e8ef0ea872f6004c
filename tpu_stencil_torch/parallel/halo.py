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

Every phase (one axis here, one edge or corner hop of
:mod:`tpu_stencil_torch.parallel.overlap`) is counted in the process
counter :func:`exchange_counts` (its strips, and the strips and bytes that
cross devices) and, while a ``torch.profiler`` collects, recorded as a
profiler-only ``sharded.exchange`` span (:func:`phase_span`).

The cards' own exchange (:mod:`tpu_stencil_torch.parallel.fill`) moves no
strip: each tile's ghost ring is pulled into a persistent slab by one
launch of ``halo_fill`` a chunk. Its geometry is :func:`ring_pieces`, the
up to eight rectangles (four edge strips, four corners) of a tile's ring
and the neighbour interiors they come from; corners come straight from the
diagonal neighbour, which equals the rows-then-cols routing here. Its
launches are counted in :func:`fill_counts`, never in
:func:`exchange_counts`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from tpu_stencil_torch.obs import tracing as _tracing

Grid = List[List[Optional[torch.Tensor]]]

# Rect = (row_lo, row_hi, lane_lo, lane_hi), lanes flat (pixel * C).
Rect = Tuple[int, int, int, int]

_COUNT_LOCK = threading.Lock()
_counts = {"phases": 0, "strips": 0, "peer_strips": 0, "peer_bytes": 0}
_fills = {"fills": 0, "pieces": 0, "peer_pieces": 0, "bytes": 0}


def exchange_counts() -> Dict[str, int]:
    """This process's exchange so far, a copy: ``phases`` (an axis, or an
    edge or corner hop), ``strips`` (ghost strips filled from a neighbour
    tile this process holds, or received from another process; a zero
    boundary strip is none), and of those ``peer_strips`` and
    ``peer_bytes``, the ones that crossed to another device or process."""
    with _COUNT_LOCK:
        return dict(_counts)


def reset_exchange_counts() -> None:
    with _COUNT_LOCK:
        for k in _counts:
            _counts[k] = 0


class Tally:
    """One phase's strips, counted as they are issued and added to
    :func:`exchange_counts` at once when the phase closes."""

    __slots__ = ("strips", "peer_strips", "nbytes", "peer_bytes")

    def __init__(self) -> None:
        self.strips = self.peer_strips = self.nbytes = self.peer_bytes = 0

    def add(self, strip: torch.Tensor, peer: bool) -> None:
        n = strip.numel() * strip.element_size()
        self.strips += 1
        self.nbytes += n
        if peer:
            self.peer_strips += 1
            self.peer_bytes += n

    def close(self, span) -> None:
        with _COUNT_LOCK:
            _counts["phases"] += 1
            _counts["strips"] += self.strips
            _counts["peer_strips"] += self.peer_strips
            _counts["peer_bytes"] += self.peer_bytes
        if span.recording:
            span.args.update(strips=self.strips,
                             peer_strips=self.peer_strips, bytes=self.nbytes)


def fill_counts() -> Dict[str, int]:
    """This process's ghost-ring fills so far
    (:mod:`tpu_stencil_torch.parallel.fill`), a copy: ``fills`` (launches
    of ``halo_fill``, one a tile a chunk that has a neighbour), ``pieces``
    (the ring pieces they filled), of those ``peer_pieces`` (read from
    another card) and ``bytes`` (every piece's)."""
    with _COUNT_LOCK:
        return dict(_fills)


def reset_fill_counts() -> None:
    with _COUNT_LOCK:
        for k in _fills:
            _fills[k] = 0


def count_fill(pieces: int, peer_pieces: int, nbytes: int) -> None:
    """One fill of ``pieces`` pieces, added to :func:`fill_counts`."""
    with _COUNT_LOCK:
        _fills["fills"] += 1
        _fills["pieces"] += pieces
        _fills["peer_pieces"] += peer_pieces
        _fills["bytes"] += nbytes


class RingPiece(NamedTuple):
    """One rectangle of a tile's ghost ring: ``name`` (an edge ``n s w e``
    or a corner ``nw ne sw se``), ``src`` the neighbour tile (i, j) it
    comes from, ``src_rect`` in that neighbour's (th, tw*C) interior,
    ``dst_rect`` in the receiving tile's d-deep ghost-extended window
    ((th + 2d, (tw + 2d) * C), the tile at rows [d, d + th))."""

    name: str
    src: Tuple[int, int]
    src_rect: Rect
    dst_rect: Rect


# Ring piece -> its neighbour's grid step.
RING_STEPS = {"n": (-1, 0), "s": (1, 0), "w": (0, -1), "e": (0, 1),
              "nw": (-1, -1), "ne": (-1, 1), "sw": (1, -1), "se": (1, 1)}


def ring_pieces(grid: Tuple[int, int], i: int, j: int, th: int, twc: int,
                channels: int, d: int) -> List[RingPiece]:
    """The pieces of tile (i, j)'s ``d``-deep ghost ring under the zero
    boundary, in :data:`RING_STEPS` order: one for each of the eight
    neighbours the ``grid`` has. A piece with no neighbour is left out:
    that ghost is the never-written zero ring. Needs ``d <= th`` and ``d *
    channels <= twc`` (one neighbour supplies the whole piece)."""
    dc = d * channels
    if d < 0 or d > th or dc > twc:
        raise ValueError(
            f"a {d}-deep ring needs a tile of at least {d} rows and {dc} "
            f"lanes, got {th}x{twc}")
    if d == 0:
        return []
    # Step along an axis -> (source range, destination range).
    rows = {-1: ((th - d, th), (0, d)), 0: ((0, th), (d, d + th)),
            1: ((0, d), (d + th, 2 * d + th))}
    lanes = {-1: ((twc - dc, twc), (0, dc)), 0: ((0, twc), (dc, dc + twc)),
             1: ((0, dc), (dc + twc, 2 * dc + twc))}
    out = []
    for name, (si, sj) in RING_STEPS.items():
        ni, nj = i + si, j + sj
        if 0 <= ni < grid[0] and 0 <= nj < grid[1]:
            (sr, dr), (sl, dl) = rows[si], lanes[sj]
            out.append(RingPiece(name, (ni, nj), sr + sl, dr + dl))
    return out


def phase_span(depth: int, **args):
    """The profiler-only ``sharded.exchange`` span of one phase (arg
    ``depth``, the ghost width; :meth:`Tally.close` adds ``strips``,
    ``peer_strips`` and ``bytes``): a shared no-op unless a profiler
    collects."""
    return _tracing.span("sharded.exchange", "sharded", profiler_only=True,
                         depth=depth, **args)


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
    several processes (remote tiles are ``None`` and stay so). One
    phase: one ``sharded.exchange`` span (arg ``axis``), the ghost
    assembly inside it."""
    if boundary not in ("zero", "periodic"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if halo == 0:
        return [list(row) for row in tiles]
    axis = "rows" if dim == 0 else "cols"
    with phase_span(halo, axis=axis) as span:
        tally = Tally()
        out = _exchange_axis(tiles, halo, dim, boundary, peers, axis, tally)
        tally.close(span)
    return out


def _exchange_axis(tiles: Grid, halo: int, dim: int, boundary: str, peers,
                   axis: str, tally: Tally) -> Grid:
    n_r, n_c = len(tiles), len(tiles[0])
    n = n_r if dim == 0 else n_c
    slots = ("n", "s") if dim == 0 else ("w", "e")
    batch = None if peers is None else peers.batch(f"halo.exchange[{axis}]")

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
                    g = ghosts[i, j, side] = _edge(src, dim, side == 1,
                                                   halo).to(x.device)
                    tally.add(g, src.device != x.device)
                elif x is not None:
                    g = ghosts[i, j, side] = _zeros_strip(x, dim, halo)
                    batch.recv((i, j), slot, (si, sj), g)
                    tally.add(g, True)
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
