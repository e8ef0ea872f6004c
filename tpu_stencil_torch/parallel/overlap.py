"""Explicit interior/border overlap schedules for the sharded path.

The port's counterpart of the JAX package's ``parallel/overlap.py``
(``--overlap split|fused-split|edge``), and of the reference's
hand-scheduled overlap: post the halo ``Isend/Irecv``, compute the
interior rows that need no ghost while the wires are busy, then finish
the border rows from the arrived ghosts (``mpi/mpi_convolution.c:194-224``).

The JAX package expresses the schedule as data dependence and leaves the
ordering to XLA. Here it is written out with CUDA streams and events:

* the exchange is per edge: four strip copies (N and S along the rows
  axis, W and E along the cols axis, each over the bare tile) plus one
  packed second hop per side for the four ``g x g`` corner patches
  (:func:`exchange_edge`, :func:`exchange_corners`,
  :func:`exchange_edge_slab`), issued on the caller's stream;
* the interior piece reads only the local tile, so it runs on a side
  stream while the copies run;
* ``split``/``fused-split`` (:func:`split_step`, :func:`fused_split_chunk`)
  finish four border bands after the whole exchange (one join);
* ``edge`` (:func:`edge_step_from`, :func:`fused_edge_chunk`) finishes
  eight border pieces on a border stream, each waiting only on its own
  edge's event (the corner pieces on the corner hop's).

When the mesh spans several processes the slab holds this process's
tiles only (``Slab.peers``), and a strip between tiles of two processes
moves by ``isend``/``irecv`` through host buffers
(:mod:`tpu_stencil_torch.parallel.transport`): the edge's receive lands in
the ghost band on the caller's stream before the edge's event is
recorded, and the corner hop is still a second hop after the N and S
strips it reads.

All of it works on a :class:`Slab`: per tile two ghost-extended buffers,
allocated once per run and refilled in place every chunk (the port's
counterpart of the loop-carried slab of :func:`edge_iterate`). Chunk ``c``
reads buffer ``c % 2`` and every piece writes straight into its rectangle
of the interior of buffer ``(c + 1) % 2``, which is the next chunk's tile:
a border band is a strided window of the buffer, never a copy, and the
output tile is never stitched. Under the kernels (``pallas``) a piece is
one launch of K3 (:func:`cuda_stencil.valid_fused`) on its window; under
torch ops it is :func:`lowering.valid_window`.

Exactness: a piece's window is its output rectangle grown by the chunk's
ghost depth on each side, holding the values the monolithic ghost-extended
tile holds there, and K3 and ``valid_window`` compute each output pixel
from its own window alone; K3 re-zeroes outside the global extent from the
global origin each piece passes, as the monolithic launch would. A tile
with no ghost-free interior at a chunk's depth (``min(tile) <= 2g``) runs
that chunk as one whole-tile piece (the monolithic chunk).

Mode vocabulary (``--overlap``): ``off`` (the monolithic exchange then
compute of :mod:`tpu_stencil_torch.parallel.sharded`), ``split`` (per-rep
split), ``fused-split`` (chunked split; ``split`` off the kernels),
``edge`` (the per-edge pipeline), ``auto`` (resolved by
:func:`tpu_stencil_torch.runtime.autotune.best_overlap` from measured
probes, cached).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_stencil_torch.config import OVERLAP_MODES
from tpu_stencil_torch.obs import tracing as _tracing
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.parallel.halo import Grid, Tally, phase_span

# Numeric codes the ``overlap_mode`` gauge reports (resolved modes only:
# "auto" always resolves to one of these before anything runs). AUTO_CODE
# is for contexts with no mesh to resolve against: a requested but
# unresolved "auto".
MODE_CODES = {"off": 0, "split": 1, "fused-split": 2, "edge": 3}
AUTO_CODE = 4

# The per-edge vocabulary: four edge strips plus the four corner patches
# the packed second hop delivers. The order is load-bearing: the copies
# are issued in it (a later multi-process slice must issue the same
# sequence on every rank), and the probe and breakdown tables list it.
EDGE_NAMES = ("n", "s", "w", "e")
CORNER_NAMES = ("nw", "ne", "sw", "se")

# Rect = (row_lo, row_hi, lane_lo, lane_hi) of a tile's flat (th, tw*C)
# output.
Rect = Tuple[int, int, int, int]


def check_mode(mode: str) -> str:
    if mode not in OVERLAP_MODES:
        raise ValueError(
            f"unknown overlap mode {mode!r}; expected one of "
            f"{'|'.join(OVERLAP_MODES)}"
        )
    return mode


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


class Streams:
    """The side and border streams of a runner and its per-edge events,
    one set per CUDA device, made at first use; nothing on the CPU, where
    every piece runs in order.

    ``main`` is the caller's current stream of the device: it issues the
    exchange copies and owns the tiles between chunks."""

    def __init__(self) -> None:
        self._sets: Dict[torch.device, dict] = {}

    @staticmethod
    def _key(dev: torch.device) -> Optional[torch.device]:
        dev = torch.device(dev)
        if dev.type != "cuda":
            return None
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)

    def _set(self, dev) -> Optional[dict]:
        key = self._key(dev)
        if key is None:
            return None
        s = self._sets.get(key)
        if s is None:
            s = {"side": torch.cuda.Stream(key),
                 "border": torch.cuda.Stream(key), "events": {}}
            self._sets[key] = s
        return s

    def begin(self, devices: Sequence[torch.device]) -> None:
        """Let the side stream of every device start after what ``main``
        has issued so far (the previous chunk and its join)."""
        for dev in _distinct(devices):
            s = self._set(dev)
            if s is not None:
                s["side"].wait_stream(torch.cuda.current_stream(dev))

    def on(self, which: str, dev) -> contextlib.AbstractContextManager:
        """Make ``which`` ('side' or 'border') the current stream of
        ``dev`` inside the block; a no-op off the card."""
        s = self._set(dev)
        return (contextlib.nullcontext() if s is None
                else torch.cuda.stream(s[which]))

    def record(self, name: str, devices: Sequence[torch.device]) -> None:
        """Record event ``name`` on ``main`` of every device: the copies
        issued so far (the edge ``name``'s among them) are done when it
        fires."""
        for dev in _distinct(devices):
            s = self._set(dev)
            if s is not None:
                ev = s["events"].get(name)
                if ev is None:
                    ev = s["events"][name] = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))

    def wait(self, name: str, dev) -> None:
        """Make the border stream of ``dev`` wait for event ``name``."""
        s = self._set(dev)
        if s is not None:
            s["border"].wait_event(s["events"][name])

    def join(self, devices: Sequence[torch.device]) -> None:
        """Make ``main`` of every device wait for its side and border
        streams: the chunk's output tile is complete after this on
        ``main``."""
        for dev in _distinct(devices):
            s = self._set(dev)
            if s is not None:
                main = torch.cuda.current_stream(dev)
                main.wait_stream(s["side"])
                main.wait_stream(s["border"])

    def keep(self, t: torch.Tensor) -> None:
        """Tell the caching allocator that ``t`` (allocated on ``main``) is
        used on the side and border streams too, so its memory is not
        handed out again before their work on it is done."""
        s = self._set(t.device)
        if s is not None:
            t.record_stream(s["side"])
            t.record_stream(s["border"])


def _distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    return list(dict.fromkeys(torch.device(d) for d in devices))


# ---------------------------------------------------------------------------
# The slab: two ghost-extended buffers per tile
# ---------------------------------------------------------------------------


class Slab:
    """The persistent exchange buffers of one sharded run.

    Per tile two flat ``(th + 2G, (tw + 2G) * C)`` uint8 buffers (``G``:
    the deepest ghost band of the run), allocated once, zero: a ghost band
    with no neighbour (the zero boundary) is never written and stays zero.
    The current tile lives in the interior of buffer :attr:`cur`; a chunk
    of ghost depth ``d <= G`` fills the ``d``-wide ring around it and
    writes the next tile into the interior of the other buffer.
    :attr:`buffers` is every buffer of the slab: their ``data_ptr``\\ s do
    not change over a run."""

    def __init__(self, tiles: Grid, depth: int,
                 streams: Optional[Streams] = None, peers=None) -> None:
        t = next(x for row in tiles for x in row if x is not None)
        self.grid = (len(tiles), len(tiles[0]))
        self.th, self.tw = int(t.shape[0]), int(t.shape[1])
        self.channels = int(t.shape[2]) if t.dim() == 3 else 1
        self.twc = self.tw * self.channels
        self.depth = depth
        self.peers = peers
        shape = (self.th + 2 * depth,
                 self.twc + 2 * depth * self.channels)
        self.devices = [[None if x is None else x.device for x in row]
                        for row in tiles]
        self.bufs = [[None if x is None else tuple(
            torch.zeros(shape, dtype=torch.uint8, device=x.device)
            for _ in range(2)) for x in row] for row in tiles]
        self.cur = 0
        if streams is not None:
            for b in self.buffers:
                streams.keep(b)
        for i, row in enumerate(tiles):
            for j, x in enumerate(row):
                if x is not None:
                    self.tile2(i, j).copy_(x.reshape(self.th, self.twc))

    @property
    def buffers(self) -> List[torch.Tensor]:
        return [b for row in self.bufs for pair in row if pair is not None
                for b in pair]

    def flat_devices(self) -> List[torch.device]:
        return [d for row in self.devices for d in row if d is not None]

    def local(self, i: int, j: int) -> bool:
        """Whether this process holds tile (i, j)."""
        return self.bufs[i][j] is not None

    def local_tiles(self) -> List[Tuple[int, int]]:
        """The (i, j) of this process's tiles, row-major."""
        return [(i, j) for i in range(self.grid[0])
                for j in range(self.grid[1]) if self.local(i, j)]

    def ext(self, i: int, j: int, d: int, k: Optional[int] = None
            ) -> torch.Tensor:
        """Tile (i, j)'s ghost-extended window at depth ``d`` in buffer
        ``k`` (default the current one): ``(th + 2d, (tw + 2d) * C)``, the
        tile at rows ``[d, d + th)`` and lanes ``[d*C, d*C + tw*C)``."""
        buf = self.bufs[i][j][self.cur if k is None else k]
        o, oc = self.depth - d, (self.depth - d) * self.channels
        return buf[o:o + self.th + 2 * d,
                   oc:oc + self.twc + 2 * d * self.channels]

    def tile2(self, i: int, j: int, k: Optional[int] = None
              ) -> torch.Tensor:
        """Tile (i, j) as a flat ``(th, tw * C)`` window of buffer ``k``."""
        return self.ext(i, j, 0, k)

    def tiles(self) -> Grid:
        """The current tiles, each an ``(th, tw[, C])`` view of its
        buffer (valid until the next chunk of this slab writes)."""
        def shaped(x):
            return x if self.channels == 1 else x.unflatten(
                1, (self.tw, self.channels))
        return [[shaped(self.tile2(i, j)) if self.local(i, j) else None
                 for j in range(self.grid[1])]
                for i in range(self.grid[0])]


# ---------------------------------------------------------------------------
# Per-edge exchange
# ---------------------------------------------------------------------------

# Edge -> (grid step of the neighbour that supplies it, axis).
_EDGE_STEP = {"n": ((-1, 0), 0), "s": ((1, 0), 0),
              "w": ((0, -1), 1), "e": ((0, 1), 1)}


def _neighbour(grid: Tuple[int, int], i: int, j: int, step,
               boundary: str) -> Optional[Tuple[int, int]]:
    """The tile one ``step`` from (i, j): wrapped under 'periodic', None
    past the grid under 'zero' (that ghost is the calloc'd zero ring)."""
    if boundary not in ("zero", "periodic"):
        raise ValueError(f"unknown boundary {boundary!r}")
    ni, nj = i + step[0], j + step[1]
    if boundary == "periodic":
        return ni % grid[0], nj % grid[1]
    if 0 <= ni < grid[0] and 0 <= nj < grid[1]:
        return ni, nj
    return None


def _strip(slab: Slab, i: int, j: int, name: str, d: int, ghost: bool
           ) -> torch.Tensor:
    """Tile (i, j)'s ``d``-deep strip on edge ``name`` of the current
    buffer: its ghost band (``ghost``) or the edge of its own tile that a
    neighbour's ghost mirrors."""
    e = slab.ext(i, j, d)
    th, twc, dc = slab.th, slab.twc, d * slab.channels
    if name == "n":
        return e[0:d, dc:dc + twc] if ghost else e[d:2 * d, dc:dc + twc]
    if name == "s":
        return (e[d + th:2 * d + th, dc:dc + twc] if ghost
                else e[th:th + d, dc:dc + twc])
    if name == "w":
        return e[d:d + th, 0:dc] if ghost else e[d:d + th, dc:2 * dc]
    return (e[d:d + th, dc + twc:2 * dc + twc] if ghost
            else e[d:d + th, twc:twc + dc])


def _move(slab: Slab, batch, tally: Tally, into: Tuple[int, int],
          slot: str, frm: Tuple[int, int], dst: Callable[[], torch.Tensor],
          src: Callable[[], torch.Tensor]) -> None:
    """One strip from tile ``frm`` to slot ``slot`` of tile ``into``:
    a copy when this process holds both, a receive or a send on ``batch``
    when it holds one, nothing when it holds neither; a strip that lands
    here is counted on ``tally``."""
    here, there = slab.local(*into), slab.local(*frm)
    if here and there:
        tally.add(dst().copy_(src()),
                  slab.devices[into[0]][into[1]]
                  != slab.devices[frm[0]][frm[1]])
    elif here:
        strip = dst()
        batch.recv(into, slot, frm, strip)
        tally.add(strip, True)
    elif there:
        batch.send(into, slot, src())


def exchange_edge(slab: Slab, name: str, d: int,
                  boundary: str = "zero") -> None:
    """ONE edge's ghost strips, ``d`` deep, for every tile: the strip copy
    from the neighbour on that side, issued on the current stream, with no
    dependence on any other edge. N's ghost of tile (i, j) is the bottom of
    tile (i-1, j), and so on; a tile with no neighbour there keeps its zero
    band ('zero'), or takes the opposite tile's strip ('periodic', which is
    its own on an axis of one tile). Across processes the edge's strips
    are one batch, received into the ghost bands before this returns."""
    step, _ = _EDGE_STEP[name]
    mirror = {"n": "s", "s": "n", "w": "e", "e": "w"}[name]
    batch = (None if slab.peers is None
             else slab.peers.batch(f"overlap.exchange_edge[{name}]"))
    with phase_span(d, edge=name) as span:
        tally = Tally()
        for i in range(slab.grid[0]):
            for j in range(slab.grid[1]):
                nb = _neighbour(slab.grid, i, j, step, boundary)
                if nb is not None:
                    _move(slab, batch, tally, (i, j), name, nb,
                          lambda: _strip(slab, i, j, name, d, True),
                          lambda: _strip(slab, nb[0], nb[1], mirror, d,
                                         False))
        if batch is not None:
            batch.run()
        tally.close(span)


def _corner_pack(slab: Slab, i: int, j: int, d: int, lane0: int
                 ) -> torch.Tensor:
    """The two ``d x d*C`` corner blocks of tile (i, j)'s window at lanes
    ``[lane0, lane0 + d*C)``, rows ``[0, d)`` and ``[d + th, 2d + th)``,
    as one (2, d, d*C) strided view: the packed payload of one hop."""
    e = slab.ext(i, j, d)
    p = e.stride(0)
    return e.as_strided((2, d, d * slab.channels), (p * (slab.th + d), p, 1),
                        e.storage_offset() + lane0)


def exchange_corners(slab: Slab, d: int, boundary: str = "zero") -> None:
    """The four ``d x d`` corner ghosts of every tile, by ONE packed copy
    per side (no diagonal copy): my NW and SW corners are my west
    neighbour's N and S ghosts' east columns, which it already holds, so
    they come across in one (2, d, d*C) copy; NE and SE likewise from my
    east neighbour's west columns. Must follow the N and S strips of the
    neighbours (:func:`exchange_edge`) on the same stream. Where the rows
    axis supplies no ghost at all (one tile row under 'zero') every corner
    is zero and nothing is copied."""
    if slab.grid[0] == 1 and boundary == "zero":
        return
    twc, dc = slab.twc, d * slab.channels
    batch = (None if slab.peers is None
             else slab.peers.batch("overlap.exchange_corners"))
    with phase_span(d, edge="corners") as span:
        tally = Tally()
        for i in range(slab.grid[0]):
            for j in range(slab.grid[1]):
                west = _neighbour(slab.grid, i, j, (0, -1), boundary)
                if west is not None:
                    _move(slab, batch, tally, (i, j), "corners_w", west,
                          lambda: _corner_pack(slab, i, j, d, 0),
                          lambda: _corner_pack(slab, west[0], west[1], d,
                                               twc))
                east = _neighbour(slab.grid, i, j, (0, 1), boundary)
                if east is not None:
                    _move(slab, batch, tally, (i, j), "corners_e", east,
                          lambda: _corner_pack(slab, i, j, d, dc + twc),
                          lambda: _corner_pack(slab, east[0], east[1], d,
                                               dc))
        if batch is not None:
            batch.run()
        tally.close(span)


def exchange_edge_slab(slab: Slab, d: int, boundary: str = "zero",
                       streams: Optional[Streams] = None) -> None:
    """The full per-edge exchange, ``d`` deep: the four edges in
    :data:`EDGE_NAMES` order, then the corner hop, each recorded as its
    own event when ``streams`` is given (``"corners"`` for the hop)."""
    devices = slab.flat_devices()
    for name in EDGE_NAMES:
        exchange_edge(slab, name, d, boundary)
        if streams is not None:
            streams.record(name, devices)
    exchange_corners(slab, d, boundary)
    if streams is not None:
        streams.record("corners", devices)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def degenerate(th: int, tw: int, d: int) -> bool:
    """Whether a tile has no ghost-free interior at ghost depth ``d``."""
    return d == 0 or th <= 2 * d or tw <= 2 * d


def split_rects(th: int, twc: int, d: int, channels: int
                ) -> Dict[str, Rect]:
    """The split's five output rectangles at ghost depth ``d``: the
    interior and four border bands (top and bottom full width)."""
    dc = d * channels
    return {"interior": (d, th - d, dc, twc - dc),
            "top": (0, d, 0, twc), "bottom": (th - d, th, 0, twc),
            "left": (d, th - d, 0, dc), "right": (d, th - d, twc - dc, twc)}


def edge_rects(th: int, twc: int, d: int, channels: int
               ) -> Dict[str, Rect]:
    """The per-edge pipeline's nine output rectangles at ghost depth
    ``d``: the interior, the four edge strips (named by the edge each
    waits on) and the four corner patches."""
    dc = d * channels
    rows = {"n": (0, d), "s": (th - d, th), "": (d, th - d)}
    lanes = {"w": (0, dc), "e": (twc - dc, twc), "": (dc, twc - dc)}
    out = {"interior": rows[""] + lanes[""]}
    for name in EDGE_NAMES:
        out[name] = (rows[name] + lanes[""] if name in ("n", "s")
                     else rows[""] + lanes[name])
    for name in CORNER_NAMES:
        out[name] = rows[name[0]] + lanes[name[1]]
    return out


def piece_rects(mode: str, th: int, tw: int, d: int, channels: int
                ) -> Dict[str, Rect]:
    """The output rectangles one chunk of ``mode`` computes per tile at
    ghost depth ``d``: one whole-tile piece where the tile is degenerate
    (the monolithic chunk)."""
    twc = tw * channels
    if degenerate(th, tw, d):
        return {"whole": (0, th, 0, twc)}
    if mode == "edge":
        return edge_rects(th, twc, d, channels)
    return split_rects(th, twc, d, channels)


def launches_per_chunk(mode: str, th: int, tw: int, d: int) -> int:
    """K3 launches one chunk of ``mode`` makes per tile at ghost depth
    ``d``, one per piece: 1 under ``off`` and on a degenerate tile, 5
    under the split, 9 under ``edge``."""
    return 1 if mode == "off" else len(piece_rects(mode, th, tw, d, 1))


class PieceKernel:
    """How a piece computes: K3 at ``n_fused`` reps (``backend`` 'pallas',
    global extent and tile height given) or one torch-ops rep
    (:func:`lowering.valid_window`)."""

    def __init__(self, plan: _lowering.StencilPlan, backend: str,
                 n_fused: int = 1,
                 global_shape: Optional[Tuple[int, int]] = None,
                 block_h: Optional[int] = None) -> None:
        if backend != "pallas" and n_fused != 1:
            raise ValueError("the torch-ops pieces run one rep per chunk")
        self.plan, self.backend = plan, backend
        self.n_fused = n_fused
        self.global_shape, self.block_h = global_shape, block_h

    @property
    def depth(self) -> int:
        return self.n_fused * self.plan.halo

    def __call__(self, slab: Slab, i: int, j: int, rect: Rect,
                 k_out: int) -> None:
        r0, r1, l0, l1 = rect
        d = self.depth
        c = slab.channels
        ext = slab.ext(i, j, d)
        out = slab.tile2(i, j, k_out)[r0:r1, l0:l1]
        if self.backend == "pallas":
            # The window is the rectangle grown by d rows and d*C lanes.
            win = ext[r0:r1 + 2 * d, l0:l1 + 2 * d * c]
            cs.valid_fused(win, self.plan, self.n_fused, c,
                           i * slab.th + r0, j * slab.twc + l0,
                           self.global_shape, block_h=self.block_h, out=out)
            return
        ext3 = ext if c == 1 else ext.unflatten(1, (-1, c))
        res = _lowering.valid_window(ext3, self.plan, r0, r1 - r0, l0 // c,
                                     (l1 - l0) // c)
        out.copy_(res.reshape(out.shape))


def issued(run: Callable[[], object], reps: int):
    """``run()``, K3's launches of one chunk of ``reps`` reps, inside a
    profiler-only ``sharded.issue`` span while a profiler collects: args
    ``reps``, ``launches`` (the chunk's delta of
    :func:`cuda_stencil.launch_counts`, 0 for the kernels' plain versions
    on the CPU) and ``kernel`` (the kernels launched, else ``pallas``)."""
    if not _tracing.profiling():
        return run()
    with _tracing.span("sharded.issue", "sharded", profiler_only=True) as s:
        before = cs.launch_counts()
        out = run()
        if s.recording:
            moved = {k: n - before[k] for k, n in cs.launch_counts().items()
                     if n != before[k]}
            s.args.update(kernel="+".join(moved) or "pallas", reps=int(reps),
                          launches=sum(moved.values()))
        return out


def _on(streams: Optional[Streams], which: str, dev):
    """``streams.on(which, dev)``, or nothing without streams."""
    return (contextlib.nullcontext() if streams is None
            else streams.on(which, dev))


def _finish(slab: Slab, k_out: int, mask: Optional[Grid],
            streams: Optional[Streams]) -> None:
    """Join the streams, make buffer ``k_out`` current and re-zero the
    pad (``mask``: a grid of (th, tw[, C]) 0/1 tiles)."""
    if streams is not None:
        streams.join(slab.flat_devices())
    slab.cur = k_out
    if mask is not None:
        for i, j in slab.local_tiles():
            slab.tile2(i, j).mul_(mask[i][j].reshape(slab.th, slab.twc))


def _chunk(slab: Slab, kernel: PieceKernel, mode: str, boundary: str,
           mask: Optional[Grid], streams: Optional[Streams],
           exchanged: bool = False) -> None:
    """One chunk of ``mode`` ('split' family or 'edge') on ``slab``: the
    interior pieces on the side stream, the exchange (unless
    ``exchanged``) on the caller's, the border pieces after it (all of it
    under the split, each after its own edge under ``edge``), then the
    join. Under K3 the chunk is one ``sharded.issue`` span
    (:func:`issued`), its exchange's spans inside it."""
    if kernel.backend == "pallas":
        issued(lambda: _pieces(slab, kernel, mode, boundary, mask, streams,
                               exchanged), kernel.n_fused)
    else:
        _pieces(slab, kernel, mode, boundary, mask, streams, exchanged)


def _pieces(slab: Slab, kernel: PieceKernel, mode: str, boundary: str,
            mask: Optional[Grid], streams: Optional[Streams],
            exchanged: bool) -> None:
    d = kernel.depth
    k_out = 1 - slab.cur
    rects = piece_rects(mode, slab.th, slab.tw, d, slab.channels)
    idx = slab.local_tiles()
    dev = slab.devices
    if streams is not None:
        streams.begin(slab.flat_devices())
    if "interior" in rects:
        for i, j in idx:
            with _on(streams, "side", dev[i][j]):
                kernel(slab, i, j, rects["interior"], k_out)
    per_edge = mode == "edge" and "interior" in rects
    if not exchanged:
        exchange_edge_slab(slab, d, boundary,
                           streams if per_edge else None)
    elif per_edge and streams is not None:
        # Exchanged by the caller on main: every piece waits for all of it.
        for name in EDGE_NAMES + ("corners",):
            streams.record(name, slab.flat_devices())
    border = [n for n in rects if n != "interior"]
    if per_edge:
        for name in border:
            for i, j in idx:
                if streams is not None:
                    streams.wait(name if name in EDGE_NAMES else "corners",
                                 dev[i][j])
                with _on(streams, "border", dev[i][j]):
                    kernel(slab, i, j, rects[name], k_out)
    else:
        for name in border:
            for i, j in idx:
                kernel(slab, i, j, rects[name], k_out)
    _finish(slab, k_out, mask, streams)


def split_step(slab: Slab, plan: _lowering.StencilPlan,
               mask: Optional[Grid] = None, boundary: str = "zero",
               streams: Optional[Streams] = None) -> None:
    """One rep as an explicit interior/border split in torch ops: the
    ``halo``-deep exchange, the interior from the local tile alone, four
    border strips by :func:`lowering.valid_window` from the exchanged
    slab, each written into its rectangle of the next tile; then the pad
    re-zero."""
    _chunk(slab, PieceKernel(plan, "xla"), "split", boundary, mask,
           streams)


def fused_split_chunk(slab: Slab, plan: _lowering.StencilPlan, fuse: int,
                      global_shape: Tuple[int, int],
                      block_h: Optional[int] = None,
                      mask: Optional[Grid] = None,
                      streams: Optional[Streams] = None) -> None:
    """``fuse`` reps as an explicit interior/border split through K3: one
    ``g = fuse*halo``-deep exchange covers the chunk; the interior is one
    launch on the local tile (its outer g rows and g*C lanes play the
    ghosts) on the side stream, then four launches on g-wide windows of
    the exchanged slab. Zero boundary (K3's)."""
    _chunk(slab, PieceKernel(plan, "pallas", fuse, global_shape, block_h),
           "split", "zero", mask, streams)


def edge_step_from(slab: Slab, plan: _lowering.StencilPlan,
                   mask: Optional[Grid] = None,
                   streams: Optional[Streams] = None) -> None:
    """One torch-ops rep of the per-edge pipeline from an already
    exchanged slab: nine pieces, each from its own window."""
    _chunk(slab, PieceKernel(plan, "xla"), "edge", "zero", mask, streams,
           exchanged=True)


def edge_step(slab: Slab, plan: _lowering.StencilPlan,
              mask: Optional[Grid] = None, boundary: str = "zero",
              streams: Optional[Streams] = None) -> None:
    """One torch-ops rep of the per-edge pipeline, exchange included;
    every border piece waits only on its own edge."""
    _chunk(slab, PieceKernel(plan, "xla"), "edge", boundary, mask, streams)


def fused_edge_chunk(slab: Slab, plan: _lowering.StencilPlan, fuse: int,
                     global_shape: Tuple[int, int],
                     block_h: Optional[int] = None,
                     mask: Optional[Grid] = None,
                     streams: Optional[Streams] = None) -> None:
    """``fuse`` reps of the per-edge pipeline through K3: the
    ``fuse*halo``-deep per-edge exchange, then nine launches per tile with
    the global origins the monolithic launch would pass. Zero boundary."""
    _chunk(slab, PieceKernel(plan, "pallas", fuse, global_shape, block_h),
           "edge", "zero", mask, streams)


def edge_iterate(tiles: Grid, depths: Sequence[int], halo: int,
                 chunk_fn: Callable[[Slab, int], None],
                 streams: Optional[Streams] = None, peers=None) -> Grid:
    """The persistent-exchange rep loop: one :class:`Slab` as deep as the
    deepest chunk, allocated once; then ``chunk_fn(slab, n)`` per entry of
    ``depths`` (its rep count), each refilling the slab's ghost bands in
    place and writing the next tile into the other buffer. Returns the
    final tiles (views of the slab). Serves every overlap mode."""
    if not depths:
        return [list(row) for row in tiles]
    slab = Slab(tiles, max(depths) * halo, streams, peers)
    for n in depths:
        chunk_fn(slab, n)
    return slab.tiles()
