"""The ``off`` chunk in place on a persistent slab, its ghost ring pulled
by the receiving card.

Where a mesh's tiles all lie on CUDA cards of one process that reach each
other's memory, the sharded runner's ``off`` schedule under K3 runs here
(:class:`Filler`) instead of through the strip exchange of
:mod:`tpu_stencil_torch.parallel.halo`:

* **Slab.** One :class:`~tpu_stencil_torch.parallel.overlap.Slab` of depth
  ``G = fuse * halo`` a filler, made at its first job and kept: two
  zeroed ghost-extended buffers a tile. A job copies its tiles into
  the interior of one buffer; chunk ``k`` reads buffer ``cur`` and K3
  writes straight into the interior of buffer ``1 - cur`` (its ext window
  and its output each a window of the slab with the slab's pitch); the
  last chunk writes fresh tiles, which the job returns, so no later job
  rewrites a result.
* **Ghost fill.** Before each chunk, each tile's ``d``-deep ring in buffer
  ``cur`` is filled by one launch of ``halo_fill``
  (:mod:`tpu_stencil_torch.ops.halo_fill`) on the tile's card: up to eight
  pieces (:func:`halo.ring_pieces`: four edge strips, four corners), each
  read from the interior of a neighbour's buffer ``cur``, through peer
  access where the neighbour is on another card. A piece with no
  neighbour is never written: the slab's zeros are the boundary. The
  tables of pointers are built once a (depth, buffer, tile).
* **One-way waits.** After a job's copies into the slab, and after each
  chunk's K3 launches, every card records one event on its stream. Before
  each fill, every card's stream waits on the events of the cards that
  hold its tiles' neighbours, and on no other. No copy crosses cards.

Why these waits suffice (tiles A and B neighbours, on cards a and b; chunk
``k`` reads buffer ``c``):

1. Read after write. A's fill(k) reads B's interior of buffer ``c``, which
   B's K3(k-1) wrote (B's copy-in for ``k = 0``); a's stream waits on b's
   event recorded after it before a issues fill(k).
2. Write after read. B's K3(k+1) writes the interior of buffer ``c``
   again. b's stream issues it after B's fill(k+1), which waits on a's
   event recorded after A's K3(k), which a's stream orders after A's
   fill(k). So B cannot overwrite what A's fill(k) reads before A has
   read it.
3. The ring. A's ring in a buffer is read by A's own K3 alone, on a's
   stream, in order with A's next fill of it.
4. Between jobs. A job starts with every card's stream waiting on that
   card's own last event, so it follows the card's whole last job even
   when it is issued on other streams. The last chunk's reads are the only
   ones that no later event of a job covers, so the next job copies its
   tiles into the other buffer (:attr:`Slab.cur` is left on the buffer the
   last chunk read). Its first K3 writes the buffer the last chunk read
   only after its chunk-0 fill waited on every neighbour's copy-in event,
   which each neighbour's stream orders after the whole of its last job.

One slab's jobs are issued under a lock. A CUDA graph that captures a job
holds the slab's pointers and is replayed with no event from outside it,
so the runner's captured job (:class:`~tpu_stencil_torch.parallel.
sharded._Replay`) runs a filler of its own, whose slab nothing else uses;
under capture a job skips the waits of point 4 (the capture follows a
synchronisation, and replays run one after another).
``tests/test_torch_halo_fill.py`` checks the argument on a log of the
accesses, waits and records, the jobs on changing streams: every two
accesses of one buffer region from two streams, one of them a write, are
ordered.

Where it engages (:meth:`Filler.engages`): K3 (``pallas``) under ``off``
in one process with no pad mask (the runner builds a :class:`Filler`
then), on tiles that all lie on CUDA cards, every two of them able to
reach each other's memory or the same card. Everything else (the CPU,
several processes, the overlap schedules, the torch-ops and periodic path,
padded images) keeps the strip exchange. Each fill is counted in
:func:`halo.fill_counts`. While a ``torch.profiler`` collects, each
chunk's waits and fills are one profiler-only ``sharded.exchange`` span
(args ``depth``, ``fill``, and the chunk's ``pieces``, ``peer_pieces``
and ``bytes``) and its K3 launches one ``sharded.issue`` span
(:func:`overlap.issued`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import halo_fill
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.parallel import halo
from tpu_stencil_torch.parallel.halo import Grid
from tpu_stencil_torch.parallel.overlap import Slab, issued


class _State:
    """One slab and what its jobs reuse: each card's event and the
    neighbour cards it waits on, and the fill tables."""

    def __init__(self, tiles: Grid, depth: int, cards) -> None:
        self.slab = Slab(tiles, depth)
        r, c = self.slab.grid
        self.order = list(dict.fromkeys(x for row in cards for x in row))
        near: Dict[object, dict] = {x: {} for x in self.order}
        for i in range(r):
            for j in range(c):
                for si, sj in halo.RING_STEPS.values():
                    if 0 <= i + si < r and 0 <= j + sj < c:
                        nb = cards[i + si][j + sj]
                        if nb != cards[i][j]:
                            near[cards[i][j]][nb] = None
        self.neighbours = {x: list(n) for x, n in near.items()}
        self.events = {x: torch.cuda.Event() for x in self.order
                       if isinstance(x, torch.device) and x.type == "cuda"}
        for x, nbs in self.neighbours.items():
            for nb in nbs:
                if x in self.events:
                    halo_fill.enable_peer(x, nb)
        self.tables: Dict[tuple, halo_fill.Table] = {}

    def table(self, i: int, j: int, d: int) -> halo_fill.Table:
        """Tile (i, j)'s ``d``-deep ring in the current buffer, as one
        launch's pieces (built at first use)."""
        s = self.slab
        key = (i, j, d, s.cur)
        t = self.tables.get(key)
        if t is None:
            ext = s.ext(i, j, d)
            pairs = []
            for p in halo.ring_pieces(s.grid, i, j, s.th, s.twc, s.channels,
                                      d):
                (a0, a1, b0, b1), (c0, c1, e0, e1) = p.src_rect, p.dst_rect
                pairs.append((s.tile2(*p.src)[a0:a1, b0:b1],
                              ext[c0:c1, e0:e1]))
            t = self.tables[key] = halo_fill.Table(pairs, ext.device)
        return t


class Filler:
    """The ``off`` chunks of K3 on a persistent slab with pulled ghost
    rings (see the module docstring): ``run(tiles, reps)`` as the strip
    path's rep loop, same launches of K3 (``fuse`` reps a chunk, then the
    single-rep tails, :func:`cuda_stencil.launch_schedule`)."""

    def __init__(self, plan: _lowering.StencilPlan, fuse: int,
                 global_shape: Tuple[int, int],
                 block_h: Optional[int] = None) -> None:
        self.plan, self.fuse = plan, fuse
        self.global_shape, self.block_h = global_shape, block_h
        self.depth = fuse * plan.halo
        self._lock = threading.Lock()
        self._states: Dict[tuple, _State] = {}
        self._reach: Dict[Tuple[int, int], bool] = {}

    def engages(self, tiles: Grid, mask: Optional[Grid]) -> bool:
        """Whether ``tiles`` run here: no pad mask, every tile held by this
        process on a CUDA card, at least ``fuse * halo`` rows and lanes
        deep, and every two of the cards able to read each other's
        memory."""
        if mask is not None:
            return False
        cards = set()
        for row in tiles:
            for t in row:
                if t is None or t.device.type != "cuda" or (
                        min(t.shape[0], t.shape[1]) < self.depth):
                    return False
                cards.add(t.device.index)
        return all(self._reaches(a, b) for a in cards for b in cards
                   if a != b)

    def _reaches(self, a: int, b: int) -> bool:
        ok = self._reach.get((a, b))
        if ok is None:
            ok = self._reach[a, b] = torch.cuda.can_device_access_peer(a, b)
        return ok

    def run(self, tiles: Grid, reps: int) -> Grid:
        """``reps`` reps on the grid ``tiles`` (not written); returns fresh
        tiles of the same shapes."""
        depths = cs.launch_schedule(int(reps), self.fuse)
        if not depths:
            return [list(row) for row in tiles]
        with self._lock:
            return self._job(self._state(tiles), tiles, depths)

    # The steps of a job, one method each.

    def _cards(self, tiles: Grid) -> List[list]:
        """The card of each tile, the unit of streams and events."""
        return [[t.device for t in row] for row in tiles]

    def _state(self, tiles: Grid) -> _State:
        cards = self._cards(tiles)
        key = (tuple(tiles[0][0].shape), tuple(map(tuple, cards)))
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _State(tiles, self.depth, cards)
        return st

    def _record(self, st: _State, card) -> None:
        ev = st.events.get(card)
        if ev is not None:
            ev.record(torch.cuda.current_stream(card))

    def _record_all(self, st: _State) -> None:
        for card in st.order:
            self._record(st, card)

    def _wait(self, st: _State, card, other) -> None:
        ev = st.events.get(other)
        if ev is not None:
            torch.cuda.current_stream(card).wait_event(ev)

    def _copy_in(self, st: _State, i: int, j: int, x: torch.Tensor) -> None:
        s = st.slab
        s.tile2(i, j).copy_(x.reshape(s.th, s.twc))

    def _fill(self, st: _State, i: int, j: int,
              d: int) -> halo_fill.Table:
        table = st.table(i, j, d)
        if len(table):
            halo_fill.launch(table)
            halo.count_fill(len(table), table.peer_pieces, table.nbytes)
        return table

    def _exchange(self, st: _State, idx, d: int) -> None:
        """A chunk's exchange: every card's waits on its neighbours' last
        events, then every tile's fill, in one ``sharded.exchange`` span."""
        with halo.phase_span(d, fill=True) as span:
            for card in st.order:
                for nb in st.neighbours[card]:
                    self._wait(st, card, nb)
            tables = [self._fill(st, i, j, d) for i, j in idx]
            if span.recording:
                span.args.update(
                    pieces=sum(len(t) for t in tables),
                    peer_pieces=sum(t.peer_pieces for t in tables),
                    bytes=sum(t.nbytes for t in tables))

    def _k3(self, st: _State, i: int, j: int, n: int,
            out: torch.Tensor) -> None:
        s = st.slab
        cs.valid_fused(s.ext(i, j, n * self.plan.halo), self.plan, n,
                       s.channels, i * s.th, j * s.twc, self.global_shape,
                       block_h=self.block_h, out=out)

    def _capturing(self, st: _State) -> bool:
        return bool(st.events) and torch.cuda.is_current_stream_capturing()

    def _job(self, st: _State, tiles: Grid, depths: Sequence[int]) -> Grid:
        s = st.slab
        idx = s.local_tiles()
        if not self._capturing(st):
            for card in st.order:
                self._wait(st, card, card)
        s.cur = 1 - s.cur
        for i, j in idx:
            self._copy_in(st, i, j, tiles[i][j])
        self._record_all(st)
        out: Grid = []
        for k, n in enumerate(depths):
            last = k == len(depths) - 1
            self._exchange(st, idx, n * self.plan.halo)
            out = issued(lambda: self._chunk(st, idx, n, last, tiles), n)
            self._record_all(st)
            if not last:
                s.cur = 1 - s.cur
        return out

    def _chunk(self, st: _State, idx, n: int, last: bool,
               tiles: Grid) -> Grid:
        """K3 at ``n`` reps on every tile: into the other buffer, or into
        fresh tiles (returned, in the input tiles' shapes) when ``last``."""
        s = st.slab
        out: Grid = [[None] * s.grid[1] for _ in range(s.grid[0])]
        for i, j in idx:
            if last:
                dst = torch.empty((s.th, s.twc), dtype=torch.uint8,
                                  device=s.devices[i][j])
                out[i][j] = dst.view(tiles[i][j].shape)
            else:
                dst = s.tile2(i, j, 1 - s.cur)
            self._k3(st, i, j, n, dst)
        return out
