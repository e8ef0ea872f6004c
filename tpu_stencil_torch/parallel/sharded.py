"""Sharded iterated convolution over an R x C mesh of devices.

The port's counterpart of the JAX package's ``parallel/sharded.py``
(``shard_map`` over a 2-D device mesh) and of the reference MPI program's
hot loop (``mpi/mpi_convolution.c:156-240``): per iteration, a halo
exchange between the tiles (:mod:`tpu_stencil_torch.parallel.halo`), then
the local stencil on each ghost-extended tile. Each tile lives on its
mesh device (:mod:`tpu_stencil_torch.parallel.mesh`); when the mesh spans
several processes a process holds, places, runs and writes only its own
tiles (a grid holds ``None`` for another rank's) and the exchange reaches
the others through :mod:`tpu_stencil_torch.parallel.transport`. The rep
loop is a Python loop and every step builds fresh tiles, except where K3's
``off`` chunks run on cards that reach each other's memory: there the
chunks run in place on a persistent slab whose ghost rings each card pulls
from its neighbours (:mod:`tpu_stencil_torch.parallel.fill`).

Two local steps, as in the JAX package:

* ``xla`` (:func:`_local_step`): torch ops per tile, one rep per exchange,
  the exchange phased like the compute for separable plans. It also serves
  periodic boundaries.
* ``pallas`` (:func:`_pallas_local_chunk`): one exchange ``fuse * halo``
  wide, then ``fuse`` reps per tile in one launch of K3
  (:func:`tpu_stencil_torch.ops.cuda_stencil.valid_fused`).

Indivisible image shapes are padded up to the tile grid and the pad
re-zeroed after every rep by a mask multiply; the runner then forces
``fuse = 1``, because K3 re-zeroes only outside the padded global extent.

The interior/border overlap schedules (``--overlap split|fused-split|
edge|auto``, :mod:`tpu_stencil_torch.parallel.overlap`) replace the
monolithic chunk with pieces: the interior on a side stream while the
ghosts are copied, the border bands after them, every piece written in
place into the next tile of a persistent slab. ``auto`` resolves from
measured probes (:func:`tpu_stencil_torch.runtime.autotune.best_overlap`,
cached); the resolved mode is what runs and what is reported.

Under tracing the runner splits its time by probes outside the timed
window (:meth:`ShardedRunner.trace_phase_probes`): exchange and compute,
each edge's exchange, and under an overlap mode its interior and border
halves. Across processes every verdict that shapes the exchange
sequence is rank 0's (:func:`_agreed_config`, ``_agreed_overlap``): ranks
that disagreed on the backend, the chunk depth or the overlap mode would
issue different sends and receives and hang.

A caller that keeps its images as host tile grids (:meth:`ShardedRunner.
host_tiles`, page-locked on a card) runs them by :meth:`ShardedRunner.
run_host`: each pinned tile's copy is issued non-blocking on its card's
current stream, the chunks queue behind the copies, and the copies alone
are waited for before the call returns; :meth:`ShardedRunner.fetch_into`
brings the tiles back into a host tile grid, unstitched, as each rank of
the reference writes its own tile. On cards that reach each other's
memory, a K3 run of one process under the ``off`` schedule is captured
once per rep count as one CUDA graph over every card (:class:`_Replay`)
and replayed: the same exchange and launches, issued by the device
instead of ~30 host calls a chunk. While a ``torch.profiler`` collects,
the chunks run instead, and record profiler-only spans: ``sharded.place``
around a placement and the run behind it, one ``sharded.exchange`` per
exchange phase (:func:`tpu_stencil_torch.parallel.halo.phase_span`) and
one ``sharded.issue`` per chunk of K3 launches
(:func:`tpu_stencil_torch.parallel.overlap.issued`).

The process-shared runner cache (:func:`shared_runner`,
:func:`cached_runner`) holds the runners the sharded stream and the
temporal pipeline build, keyed by everything a runner depends on, so one
process never resolves (nor autotunes) the same runner twice.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_stencil_torch.obs import tracing as _tracing
from tpu_stencil_torch.obs.tracing import fence
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.parallel import fill as fill_mod
from tpu_stencil_torch.parallel import overlap as overlap_mod
from tpu_stencil_torch.parallel import partition
from tpu_stencil_torch.parallel.halo import Grid, halo_exchange
from tpu_stencil_torch.parallel.mesh import COLS_AXIS, ROWS_AXIS, make_mesh
from tpu_stencil_torch.parallel.transport import Peers


def _map(fn, *grids) -> Grid:
    """``fn`` over the tiles this process holds (position by position
    across ``grids``); ``None`` where the first grid holds another rank's
    tile."""
    return [[None if ts[0] is None else fn(*ts) for ts in zip(*rows)]
            for rows in zip(*grids)]


def _apply_mask(tiles: Grid, mask: Optional[Grid]) -> Grid:
    if mask is None:
        return tiles
    return _map(lambda t, m: t * m, tiles, mask)


def _local_step(tiles: Grid, plan: _lowering.StencilPlan,
                mask: Optional[Grid], boundary: str = "zero",
                peers=None) -> Grid:
    """One rep over the grid in torch ops: halo exchange, the plan's step
    on every ghost-extended tile, then the pad re-zero.

    Separable plans exchange in two phases, like their compute: the row
    ghosts (as int32), the rows pass, then the col ghosts of the rows-pass
    output and the cols pass — the corner ghosts are never needed."""
    halo = plan.halo
    if plan.kind == "sep_int":
        xi = _map(lambda t: t.to(torch.int32), tiles)
        ext0 = halo_exchange(xi, halo, (0,), boundary, peers)
        a = _map(lambda t: _lowering.sep_rows_pass(t, plan), ext0)
        ext1 = halo_exchange(a, halo, (1,), boundary, peers)
        out = _map(lambda t: _lowering.sep_cols_pass(t, plan), ext1)
    else:
        ext = halo_exchange(tiles, halo, (0, 1), boundary, peers)
        out = _map(lambda t: _lowering.valid_step(t, plan), ext)
    return _apply_mask(out, mask)


def _pallas_local_chunk(tiles: Grid, plan: _lowering.StencilPlan, fuse: int,
                        global_shape: Tuple[int, int],
                        mask: Optional[Grid],
                        block_h: Optional[int] = None, peers=None) -> Grid:
    """``fuse`` reps for one exchange: widen the exchange to ``fuse *
    halo`` uint8 ghosts and run K3 on every tile, whose trusted band
    contracts by ``halo`` per rep — the ghosts recompute the neighbours'
    values exactly, so no further exchange is needed until the next
    chunk."""
    ext = halo_exchange(tiles, fuse * plan.halo, (0, 1), peers=peers)
    return _apply_mask(_valid_chunk(tiles, ext, plan, fuse, global_shape,
                                    block_h), mask)


def _valid_chunk(tiles: Grid, ext: Grid, plan: _lowering.StencilPlan,
                 fuse: int, global_shape: Tuple[int, int],
                 block_h: Optional[int] = None) -> Grid:
    """K3 at ``fuse`` reps on every ghost-extended tile of ``ext`` (the
    exchange of ``tiles``), one ``sharded.issue`` span
    (:func:`overlap.issued`). Tile (i, j)'s interior starts at global row
    ``i * th`` and flat lane ``j * tw * C``."""
    return overlap_mod.issued(
        lambda: _launch_chunk(tiles, ext, plan, fuse, global_shape, block_h),
        fuse)


def _launch_chunk(tiles: Grid, ext: Grid, plan: _lowering.StencilPlan,
                  fuse: int, global_shape: Tuple[int, int],
                  block_h: Optional[int]) -> Grid:
    g = fuse * plan.halo
    out = []
    for i, (row, erow) in enumerate(zip(tiles, ext)):
        orow = []
        for j, (t, e) in enumerate(zip(row, erow)):
            if t is None:
                orow.append(None)
                continue
            th, tw = t.shape[0], t.shape[1]
            channels = t.shape[2] if t.dim() == 3 else 1
            out2 = cs.valid_fused(
                e.reshape(th + 2 * g, (tw + 2 * g) * channels), plan, fuse,
                channels, i * th, j * tw * channels, global_shape,
                block_h=block_h,
            )
            orow.append(out2.reshape(t.shape))
        out.append(orow)
    return out


def build_sharded_iterate(plan: _lowering.StencilPlan, needs_mask: bool,
                          backend: str = "xla", global_shape=None,
                          fuse: int = 1, boundary: str = "zero",
                          block_h: Optional[int] = None,
                          overlap: str = "off",
                          streams: Optional[overlap_mod.Streams] = None,
                          peers=None):
    """The sharded rep loop: returns ``fn(tiles, reps, mask) -> tiles``.

    ``backend='pallas'`` runs ``reps // fuse`` K3 chunks, then the
    ``reps % fuse`` remainder one rep at a time (``global_shape`` = padded
    (rows, cols * C) required); any other backend runs one torch-ops rep
    per chunk. ``mask`` (a grid like the tiles, or None) multiplies every
    step's result. Under ``off`` in one process with no mask, K3's chunks
    on tiles whose cards reach each other run on a persistent slab with
    pulled ghost rings (:class:`fill.Filler`, whose slabs this function's
    result keeps); anywhere else they exchange strips.

    ``overlap``: a *resolved* mode. ``off`` runs the monolithic chunk
    (:func:`_pallas_local_chunk`, :func:`_local_step`); ``split``/
    ``fused-split``/``edge`` run the chunks of
    :mod:`tpu_stencil_torch.parallel.overlap` on one slab per call, on
    ``streams`` (the runner's) on a card. ``edge`` under K3 needs a
    ghost-free interior at every chunk depth (the runner clamps
    ``fuse``). ``peers``: the tile owners of a mesh that spans several
    processes (:class:`~tpu_stencil_torch.parallel.transport.Peers`)."""
    if overlap not in overlap_mod.MODE_CODES:
        raise ValueError(
            f"build_sharded_iterate needs a resolved overlap mode, got "
            f"{overlap!r}")
    if backend == "pallas":
        if boundary != "zero":
            raise ValueError(
                "the valid-ghost kernel is zero-boundary; periodic sharded "
                "runs use the torch-ops path (the runner demotes)"
            )
        if needs_mask and fuse != 1:
            # K3 re-zeroes only outside the padded global extent; the pad
            # inside it must be re-zeroed every rep (the mask).
            raise ValueError(
                "sharded K3 execution with a pad mask requires fuse=1"
            )
    elif fuse != 1:
        raise ValueError("the torch-ops sharded step runs one rep per chunk")

    if overlap != "off":
        def iterate(tiles: Grid, reps: int,
                    mask: Optional[Grid] = None) -> Grid:
            def chunk(slab, n):
                if backend == "pallas":
                    run = (overlap_mod.fused_edge_chunk if overlap == "edge"
                           else overlap_mod.fused_split_chunk)
                    run(slab, plan, n, global_shape, block_h, mask, streams)
                elif overlap == "edge":
                    overlap_mod.edge_step(slab, plan, mask, boundary,
                                          streams)
                else:
                    overlap_mod.split_step(slab, plan, mask, boundary,
                                           streams)

            return overlap_mod.edge_iterate(
                tiles, cs.launch_schedule(int(reps), fuse), plan.halo, chunk,
                streams, peers)

        return iterate

    filler = None
    if backend == "pallas":
        if peers is None and not needs_mask:
            filler = fill_mod.Filler(plan, fuse, global_shape, block_h)

        def step_chunk(tiles, n_fused, mask):
            return _pallas_local_chunk(tiles, plan, n_fused, global_shape,
                                       mask, block_h=block_h, peers=peers)
    else:
        def step_chunk(tiles, n_fused, mask):
            return _local_step(tiles, plan, mask, boundary, peers)

    def iterate(tiles: Grid, reps: int, mask: Optional[Grid] = None) -> Grid:
        if filler is not None and filler.engages(tiles, mask):
            return filler.run(tiles, reps)
        tiles = [list(row) for row in tiles]
        for n in cs.launch_schedule(int(reps), fuse):
            tiles = step_chunk(tiles, n, mask)
        return tiles

    return iterate


def _agreed_config(model, tile: Tuple[int, int], channels: int):
    """The (backend, schedule, block_h, fuse) the runner runs at ``tile``:
    the model's resolution (the autotuner's verdict for ``auto``/
    ``autotune``, measured once on a card). Across processes rank 0
    resolves and every rank receives its verdict: a divergent backend or
    fuse (the exchange's chunk depth) would make the ranks issue
    different sends and receives."""
    from tpu_stencil_torch.parallel import distributed

    def resolve():
        backend, schedule = model.resolved_config(tile, channels)
        bh, fz = model.resolved_geometry(tile, channels)
        return backend, schedule, bh, fz

    if distributed.process_count() == 1:
        return resolve()
    vote = ["", "", "", ""]
    if distributed.process_index() == 0:
        vote = ["" if v is None else str(v) for v in resolve()]
    backend, schedule, bh, fz = distributed.broadcast_strs(vote)
    return (backend, schedule or None, int(bh) if bh else None,
            int(fz) if fz else None)


class ShardedRunner:
    """The mesh, padding geometry, mask and resolved local step for one
    image shape — the per-job state every reference rank kept in locals
    (tile dims, neighbour ranks, datatypes).

    ``devices`` may name one device several times (see
    :mod:`tpu_stencil_torch.parallel.mesh`); across processes they are
    this process's devices, and the mesh is built from every rank's.
    ``timeout_s``: the dispatch timeout every wait of a cross-process
    exchange takes (0: gloo's own)."""

    def __init__(
        self,
        model,
        image_shape: Tuple[int, int],
        channels: int,
        mesh_shape: Optional[Tuple[int, int]] = None,
        devices: Optional[Sequence] = None,
        overlap: str = "off",
        timeout_s: float = 0.0,
    ) -> None:
        overlap_mod.check_mode(overlap)
        self.model = model
        self.h, self.w = image_shape
        self.channels = channels
        self.mesh = make_mesh(mesh_shape, devices, image_shape=image_shape)
        self.mesh_shape = (self.mesh.shape[ROWS_AXIS],
                           self.mesh.shape[COLS_AXIS])
        # The transport of a mesh that spans several processes.
        self.peers = (None if self.mesh.owners is None
                      else Peers(self.mesh.owners, timeout_s))
        ph, pw = partition.pad_amounts(self.h, self.w, self.mesh_shape)
        self.padded_shape = (self.h + ph, self.w + pw)
        tile = partition.tile_shape(self.h, self.w, self.mesh_shape)
        self.tile = tile
        self.boundary = model.boundary
        if self.boundary == "periodic" and (ph or pw):
            # The pad region would be wrapped into the opposite edge —
            # silently wrong output. Periodic needs grid-divisible shapes.
            raise NotImplementedError(
                f"periodic boundaries need the image ({self.h}x{self.w}) "
                f"to divide the mesh grid {self.mesh_shape}; pick a mesh "
                "that divides the image or run single-device"
            )
        # auto/autotune resolve against the per-device TILE, the unit the
        # local kernel runs on (a proxy: the autotuner times K1's rep loop
        # on a tile-sized image, not K3, but they share the tile code):
        # the autotune cache is consulted, and on a card a cold cache
        # measures once per tile shape (on rank 0, whose verdict every
        # rank takes). A plan K3 cannot take, or a periodic run, resolves
        # to xla.
        self.backend, tuned_schedule, geo_bh, geo_fz = _agreed_config(
            model, tile, channels)
        halo = model.plan.halo
        if min(tile) < halo:
            # One exchange hop supplies at most one neighbour tile of
            # ghost data; smaller tiles would need multi-hop gathering.
            raise ValueError(
                f"per-device tile {tile[0]}x{tile[1]} is smaller than the "
                f"filter halo ({halo}); use fewer devices or a different "
                f"mesh shape for this image"
            )
        self.needs_mask = bool(ph or pw)
        self.fuse = 1
        self.schedule = None
        # The kernel geometry K3 launches: user-forced --block-h/--fuse
        # wins, else the tuned verdict for this tile (resolved_geometry
        # gives exactly that precedence), else the defaults; block_h_eff is
        # the tile height at this tile, reported when either applied. A
        # tuned geometry shallower than the default fuse is not taken: the
        # probe times K1 alone, and here every chunk also costs a halo
        # exchange the probe never saw, so fewer reps per chunk can only
        # be judged by timing this runner.
        forced = model.block_h is not None or model.fuse is not None
        if not forced and geo_fz is not None and geo_fz < cs.DEFAULT_FUSE:
            geo_bh = geo_fz = None
        self.block_h_eff = None
        self.geo_applied = False
        # The tile body K3 runs (None off the kernels).
        self.body = (cs.tile_body(model.plan) if self.backend == "pallas"
                     else None)
        if self.backend == "pallas":
            if tuned_schedule == cs.DEEP:
                # 'deep' deepens the exchange chunk to the deep depth; K3
                # has no resident form, so the schedule reported is the
                # one that launches.
                if geo_fz is None:
                    geo_fz = cs.deep_fuse_for(
                        model.plan,
                        cs.effective_block_h(model.plan, tile[0], channels,
                                             geo_bh),
                        channels,
                    )
            self.schedule = cs.FUSED
            # One exchange delivers at most one neighbour tile of ghosts,
            # so the chunk depth is capped by the tile; the mask path
            # re-zeroes the pad every rep, which forces single-rep chunks.
            want = geo_fz if geo_fz is not None else cs.DEFAULT_FUSE
            if not self.needs_mask and halo:
                self.fuse = max(1, min(want, min(tile) // halo))
            elif not self.needs_mask:
                self.fuse = want
            bh, self.fuse = cs.valid_geometry(model.plan, tile[0], channels,
                                              self.fuse, geo_bh)
            if geo_bh is not None:
                self.block_h_eff = bh
            self.geo_applied = geo_bh is not None or geo_fz is not None
        self._block_h = geo_bh if self.backend == "pallas" else None
        self._global_shape = (self.padded_shape[0],
                              self.padded_shape[1] * channels)
        self._mask = None
        if self.needs_mask:
            mask = np.zeros(self.padded_shape, np.uint8)
            mask[: self.h, : self.w] = 1
            if channels != 1:
                mask = np.repeat(mask[..., None], channels, axis=-1)
            self._mask = self.split(mask)
        self._streams = overlap_mod.Streams()
        # run_host's captured jobs, one a rep count, and whether every two
        # of the cards reach each other's memory (asked once).
        self._replays: Dict[int, "_Replay"] = {}
        self._peer_ok: Optional[bool] = None
        # The overlap schedule, resolved after the chunk depth (auto
        # measures this runner's own chunks): 'split' is one exchange per
        # rep, 'edge' keeps a ghost-free interior at every chunk depth.
        self.overlap_requested = overlap
        self.overlap = self._resolve_overlap(overlap)
        self.fuse = self._mode_fuse(self.overlap)
        from tpu_stencil_torch import obs

        obs.registry().gauge("overlap_mode").set(
            overlap_mod.MODE_CODES[self.overlap])
        self._fn = self._build(self.overlap)

    def _build(self, overlap: str):
        return build_sharded_iterate(
            self.model.plan, self.needs_mask, backend=self.backend,
            global_shape=self._global_shape,
            fuse=self._mode_fuse(overlap), boundary=self.boundary,
            block_h=self._block_h, overlap=overlap, streams=self._streams,
            peers=self.peers,
        )

    def _mode_fuse(self, mode: str) -> int:
        """The chunk depth ``mode`` runs at on this runner: the resolved
        fuse, 1 under 'split' (one exchange per rep), and under 'edge' on
        K3 at most what leaves a ghost-free interior
        (``min(tile) > 2 * fuse * halo``)."""
        halo = self.model.plan.halo
        if mode == "split" or self.backend != "pallas":
            return 1
        if mode == "edge" and halo:
            return max(1, min(self.fuse, (min(self.tile) - 1) // (2 * halo)))
        return self.fuse

    def _resolve_overlap(self, requested: str) -> str:
        """The mode this runner runs for ``requested``: 'off' on a tile
        with no ghost-free interior even at one rep (every split would run
        the monolithic chunk; the gauge and the JobResult name what runs);
        'fused-split' is 'split' off the kernels; 'auto' asks
        :func:`autotune.best_overlap` (this runner's probes, measured once
        and cached; a warm cache measures nothing)."""
        if requested == "off":
            return "off"
        h = self.model.plan.halo
        if h < 1 or min(self.tile) <= 2 * h:
            return "off"
        if requested == "auto":
            requested = self._agreed_overlap()
        if requested == "fused-split" and self.backend != "pallas":
            return "split"
        return requested

    def _agreed_overlap(self) -> str:
        """``auto``'s verdict: :func:`autotune.best_overlap` (the cache,
        else this runner's probes, measured once and cached). Across
        processes the probes exchange, so every rank runs them or none
        does: rank 0 checks the cache and broadcasts whether it hit; on a
        miss every rank measures, and rank 0's verdict is stored and
        broadcast (the mode sets every rank's send and receive
        sequence)."""
        from tpu_stencil_torch.parallel import distributed
        from tpu_stencil_torch.runtime import autotune

        key = (self.model.plan, self.tile, self.channels, self.mesh_shape,
               self.backend)
        if distributed.process_count() == 1:
            return autotune.best_overlap(
                *key, measure=self._measure_overlap_probes,
                device=self.devices[0])
        rank0 = distributed.process_index() == 0
        hit = (autotune.cached_overlap(*key, device=self.devices[0])
               if rank0 else None)
        hit = distributed.broadcast_strs([hit or ""])[0]
        if hit:
            return hit
        measured = self._measure_overlap_probes()
        mode = (autotune.best_overlap(*key, measure=lambda: measured,
                                      device=self.devices[0])
                if rank0 else "")
        return distributed.broadcast_strs([mode])[0]

    @property
    def devices(self) -> List[torch.device]:
        """The devices of this process's tiles, in row-major order (every
        tile's in one process)."""
        return self.mesh.flat()

    def prepare(self) -> None:
        """Build (or load) K3 when this runner launches it, and
        ``halo_fill`` when its chunks may pull their ghost rings
        (:mod:`tpu_stencil_torch.parallel.fill`), so no build lands in a
        timed window. Launches nothing."""
        if self.backend == "pallas" and any(
                d.type == "cuda" for d in self.devices):
            fills = (self.overlap == "off" and self.peers is None
                     and not self.needs_mask)
            _build.build(_build.JOB_KERNELS + (("halo_fill",) if fills
                                               else ()))

    def warm_reps(self, calls) -> List[int]:
        """Rep counts, one :meth:`run` each, that between them launch every
        instance the calls ``calls`` (the rep count of each call a timed
        window makes) launch (:func:`cuda_stencil.warm_depths` at the
        runner's fuse); each is one exchange and K3 on every tile."""
        return cs.warm_depths(
            calls, self.fuse if self.backend == "pallas" else None)

    def warmup(self, tiles: Grid, depths) -> Grid:
        """Run ``depths`` (:meth:`warm_reps`) on a scratch copy of the
        tiles, never on the tiles themselves; returns the scratch grid
        for the caller to fence."""
        scratch = _map(torch.clone, tiles)
        for n in depths:
            scratch = self.run(scratch, n)
        return scratch

    def describe_launches(self, depths) -> List[dict]:
        """The K3 instance each chunk of ``depths`` reps launches on every
        tile (:func:`cuda_stencil.describe_launch`, with ``launches`` the
        K3 launches per chunk: one per tile, or a piece's each under an
        overlap mode); empty off the kernels."""
        if self.backend != "pallas":
            return []
        th, tw = self.tile
        per_tile = [overlap_mod.launches_per_chunk(
            self.overlap, th, tw, d * self.model.plan.halo) for d in depths]
        return [dict(cs.describe_launch(
            "stencil_valid", self.model.plan, th, tw * self.channels,
            self.channels, self._block_h, d, self.devices[0]),
            launches=len(self.devices) * n) for d, n in zip(depths, per_tile)]

    def introspect_warmup(self, depths, site_info) -> Optional[dict]:
        """Record the K3 instances the warm-up launched for ``depths`` at
        the ``sharded.iterate`` site (:func:`tpu_stencil_torch.obs.
        introspect.capture`); ``site_info(kernels)`` completes the record
        with the job's build seconds and modelled bytes and operations.
        No-op unless introspection is armed."""
        from tpu_stencil_torch import obs

        if not obs.introspect.enabled():
            return None
        return obs.introspect.capture(
            "sharded.iterate",
            lambda: site_info(self.describe_launches(depths)),
            meta={"mesh": self.mesh_shape, "tile": self.tile,
                  "backend": self.backend, "fuse": self.fuse,
                  "warm_reps": list(depths)},
        )

    def _phase_probes(self):
        """(exchange-only, compute-only) step functions of one chunk: the
        chunk's halo exchange (``fuse * halo`` ghosts for K3, ``halo`` for
        the torch-ops step), and the local compute on the exchanged tiles
        (K3 at ``fuse`` reps on every tile, or one torch-ops rep)."""
        plan = self.model.plan
        if self.backend == "pallas":
            g = self.fuse * plan.halo

            def exchange(tiles):
                return tiles, halo_exchange(tiles, g, (0, 1),
                                            peers=self.peers)

            def compute(pair):
                return _valid_chunk(pair[0], pair[1], plan, self.fuse,
                                    self._global_shape, self._block_h)
        else:
            def exchange(tiles):
                return tiles, halo_exchange(tiles, plan.halo, (0, 1),
                                            self.boundary, self.peers)

            def compute(pair):
                return _map(lambda t: _lowering.valid_step(t, plan),
                            pair[1])
        return exchange, compute

    def edge_probes(self) -> Dict[str, Callable]:
        """Per-edge exchange-only probes: ``{edge: fn(slab)}`` for the
        edges of :data:`overlap.EDGE_NAMES` whose axis has more than one
        tile (an axis of one exchanges nothing). Each copies only that
        edge's ghost strips of every tile, ``max(1, halo)`` deep, into the
        slab (:func:`overlap.exchange_edge`, the copies the pipeline's
        border pieces wait on) and returns the slab's buffers to fence."""
        g = max(1, self.model.plan.halo)
        r, c = self.mesh_shape
        sizes = {"n": r, "s": r, "w": c, "e": c}

        def probe(name):
            def fn(slab):
                overlap_mod.exchange_edge(slab, name, g, self.boundary)
                return slab.buffers
            return fn

        return {name: probe(name) for name in overlap_mod.EDGE_NAMES
                if sizes[name] > 1}

    def _overlap_probes(self):
        """(interior_fn, border_fn) of the overlap mode's two halves at one
        rep (``halo`` deep: traced runs launch one rep per call), each
        ``fn(slab)`` on an exchanged slab, writing the pieces into the
        slab's other buffer and returning the buffers to fence: the
        interior pieces, and the border pieces (the split's four bands, or
        the pipeline's eight). None on a tile with no ghost-free interior
        at one rep."""
        plan = self.model.plan
        h = plan.halo
        th, tw = self.tile
        if overlap_mod.degenerate(th, tw, h):
            return None
        kernel = overlap_mod.PieceKernel(
            plan, "pallas" if self.backend == "pallas" else "xla", 1,
            self._global_shape, self._block_h)
        rects = overlap_mod.piece_rects(self.overlap, th, tw, h,
                                        self.channels)

        def run(names):
            def fn(slab):
                for i, j in slab.local_tiles():
                    for name in names:
                        kernel(slab, i, j, rects[name], 1 - slab.cur)
                return slab.buffers
            return fn

        return (run(["interior"]),
                run([n for n in rects if n != "interior"]))

    def _candidate_probes(self) -> Dict[str, Tuple[Callable, int]]:
        """``{mode: (fn(tiles, reps), depth)}`` for 'off', the split
        flavour ('fused-split' on K3, else 'split') and 'edge': each this
        runner's rep loop under that mode at the chunk depth it would run,
        which :meth:`_measure_overlap_probes` times over a few chunks."""
        split = "fused-split" if self.backend == "pallas" else "split"
        out = {}
        for key, mode in (("off", "off"), ("split", split), ("edge", "edge")):
            fn = self._build(mode)
            out[key] = (lambda t, n, _fn=fn: _fn(t, n, self._mask),
                        self._mode_fuse(mode))
        return out

    def _measure_overlap_probes(self) -> dict:
        """The probe bundle ``--overlap auto`` decides on, on a zero canvas
        of this runner's padded shape: ``{"exchange_s", "interior_s",
        "edges": {edge: s}, "candidates": {"off", "split", "edge": s per
        rep}}``. The exchange and compute probes are one chunk's halves
        (:meth:`_phase_probes`), the edges :meth:`edge_probes`, best of 3
        fenced runs each after an untimed one. A candidate's seconds per
        rep are its best of 5 fenced runs of 4 chunks, the candidates
        taking turns within each round so that a slow spell of a shared
        host falls on all of them; a split's slab set-up stays in its time
        (it pays it in every window)."""
        shape = self.padded_shape + ((self.channels,) if self.channels != 1
                                     else ())
        tiles = self.split(np.zeros(shape, np.uint8))

        def best_of(fn, n=3):
            fence(fn())
            best = float("inf")
            for _ in range(n):
                t0 = time.perf_counter()
                fence(fn())
                best = min(best, time.perf_counter() - t0)
            return best

        exchange, compute = self._phase_probes()
        pair = exchange(tiles)
        slab = self._slab(tiles, max(1, self.model.plan.halo))
        edges = {name: best_of(lambda fn=fn: fn(slab))
                 for name, fn in self.edge_probes().items()}
        runs = self._candidate_probes()
        cands = {key: float("inf") for key in runs}
        for key, (fn, depth) in runs.items():
            fence(fn(tiles, depth))
        for _ in range(5):
            for key, (fn, depth) in runs.items():
                t0 = time.perf_counter()
                fence(fn(tiles, 4 * depth))
                cands[key] = min(cands[key], (time.perf_counter() - t0)
                                 / (4 * depth))
        return {"exchange_s": best_of(lambda: exchange(tiles)),
                "interior_s": best_of(lambda: compute(pair)),
                "edges": edges, "candidates": cands}

    def trace_phase_probes(self, tiles: Grid) -> None:
        """Emit the probe spans, each one measured run after one untimed
        run of all (``sharded.probe_compile``), so the trace splits the
        runner's time: ``sharded.halo_exchange`` and
        ``sharded.interior_compute`` (an exchange-only and a compute-only
        step of one chunk, ``reps`` = its depth); one
        ``sharded.exchange_edge[x]`` per edge (:meth:`edge_probes`: four
        distinct fences on a 2-D mesh, no single join); and under an
        overlap mode ``sharded.interior_overlap`` and
        ``sharded.border_compute`` (:meth:`_overlap_probes`). Tracing
        only; the timed window never runs them."""
        from tpu_stencil_torch import obs

        if not obs.enabled() or self.model.plan.halo < 1:
            return
        exchange, compute = self._phase_probes()
        reps = self.fuse if self.backend == "pallas" else 1
        edge_fns = self.edge_probes()
        halves = (self._overlap_probes() if self.overlap != "off"
                  else None)
        with obs.span("sharded.probe_compile", "sharded") as s:
            s.fence(compute(s.fence(exchange(tiles))))
            slab = self._slab(tiles, self.model.plan.halo)
            for fn in edge_fns.values():
                s.fence(fn(slab))
            if halves is not None:
                overlap_mod.exchange_edge_slab(slab, self.model.plan.halo,
                                               self.boundary)
                s.fence(halves[0](slab))
                s.fence(halves[1](slab))
        with obs.span("sharded.halo_exchange", "sharded", reps=reps) as s:
            pair = s.fence(exchange(tiles))
        with obs.span("sharded.interior_compute", "sharded",
                      reps=reps) as s:
            s.fence(compute(pair))
        for name, fn in edge_fns.items():
            with obs.span(f"sharded.exchange_edge[{name}]", "sharded") as s:
                s.fence(fn(slab))
        if halves is not None:
            with obs.span("sharded.interior_overlap", "sharded") as s:
                s.fence(halves[0](slab))
            with obs.span("sharded.border_compute", "sharded") as s:
                s.fence(halves[1](slab))

    def _slab(self, tiles: Grid, depth: int) -> overlap_mod.Slab:
        """A probe's slab of ``tiles``, on this runner's transport."""
        return overlap_mod.Slab(tiles, depth, peers=self.peers)

    def diagnose_edges(self, timeout_s: float = 10.0) -> Dict[str, str]:
        """Per-edge exchange verdicts after a suspected hang, one process
        only: each edge's exchange probe (:meth:`edge_probes`) on a fresh
        zero canvas, twice under its own watchdog (the second run timed),
        reported as ``"ok (<ms>)"``, ``"timeout"`` or ``"error: <type>"``
        per edge. A wedged device costs at most two watchdog windows per
        edge. Across processes the probes would exchange with ranks that
        did not time out and will not join them, so the driver leaves
        the verdicts empty there."""
        from tpu_stencil_torch.resilience import deadline as _deadline
        from tpu_stencil_torch.resilience.errors import DispatchTimeout

        shape = self.padded_shape + ((self.channels,) if self.channels != 1
                                     else ())
        slab = self._slab(self.split(np.zeros(shape, np.uint8)),
                          max(1, self.model.plan.halo))
        verdicts = {}
        for name, fn in self.edge_probes().items():
            label = f"sharded.exchange_edge[{name}]"
            try:
                _deadline.fence(fn(slab), timeout_s, f"{label}/first")
                t0 = time.perf_counter()
                _deadline.fence(fn(slab), timeout_s, label)
                verdicts[name] = (
                    f"ok ({(time.perf_counter() - t0) * 1e3:.2f}ms)")
            except DispatchTimeout:
                verdicts[name] = "timeout"
            except Exception as e:
                verdicts[name] = f"error: {type(e).__name__}"
        return verdicts

    def _cut(self, padded: np.ndarray, i: int, j: int) -> torch.Tensor:
        """Tile (i, j) of a padded global array, a contiguous CPU tensor."""
        th, tw = self.tile
        return torch.from_numpy(np.ascontiguousarray(
            padded[i * th:(i + 1) * th, j * tw:(j + 1) * tw]))

    def split(self, padded: np.ndarray) -> Grid:
        """Cut a padded global (H, W[, C]) array into the tile grid, each
        tile this process holds on its mesh device (``None`` for another
        rank's)."""
        return [
            [self._cut(padded, i, j).to(dev) if self.mesh.is_local(i, j)
             else None for j, dev in enumerate(row)]
            for i, row in enumerate(self.mesh.devices)
        ]

    def _padded(self, img) -> np.ndarray:
        img = np.asarray(img, dtype=np.uint8)
        if img.shape[:2] != (self.h, self.w):
            raise ValueError(f"image shape {img.shape} != {(self.h, self.w)}")
        ph = self.padded_shape[0] - self.h
        pw = self.padded_shape[1] - self.w
        if ph or pw:
            img = np.pad(img, [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2))
        return img

    def put(self, img: np.ndarray) -> Grid:
        """Pad to the tile grid and place every tile on its device — the
        analog of every rank loading its rows
        (``mpi/mpi_convolution.c:126-141``)."""
        return self.split(self._padded(img))

    def host_tiles(self, img: Optional[np.ndarray] = None,
                   pin: bool = False) -> Grid:
        """A host tile grid: ``img`` padded and cut into contiguous CPU
        tiles (uninitialised tiles of the tile shape when ``img`` is
        None: the buffers of :meth:`fetch_into`), page-locked when
        ``pin``; ``None`` for another rank's tile."""
        padded = None if img is None else self._padded(img)
        dims = self.tile + ((self.channels,) if self.channels != 1 else ())

        def tile(i, j):
            if padded is None:
                return torch.empty(dims, dtype=torch.uint8, pin_memory=pin)
            t = self._cut(padded, i, j)
            return t.pin_memory() if pin else t

        r, c = self.mesh_shape
        return [[tile(i, j) if self.mesh.is_local(i, j) else None
                 for j in range(c)] for i in range(r)]

    def run_host(self, host: Grid, repetitions: int) -> Grid:
        """:meth:`run` on a host tile grid (:meth:`host_tiles`), each tile
        placed on its mesh device inside a profiler-only ``sharded.place``
        span (args ``bytes`` and ``cards``, the distinct devices placed
        on) that holds the run. A page-locked tile bound for a card is
        copied non-blocking with an event behind it, the run queues behind
        the copies, and every event is waited for before this returns or
        raises, so the caller may rewrite ``host`` at once (the output may
        still be computing: a read of it on the card's current stream
        orders after it). Where :meth:`_replayable` holds, the run is a
        replay of the job captured once for this rep count
        (:class:`_Replay`); else the copies are issued on each card's
        current stream and the chunks behind them, with their spans. Any
        other tile is placed and waited for first."""
        with _tracing.span("sharded.place", "sharded",
                           profiler_only=True) as s:
            reps = int(repetitions)
            if self._replayable(host):
                rep = self._replays.get(reps)
                if rep is None:
                    rep = self._replays[reps] = _Replay(self, host, reps)
                out = rep.run(host)
            else:
                out = self._place_and_run(host, reps)
            if s.recording:
                s.args.update(bytes=sum(t.nbytes for row in host
                                        for t in row if t is not None),
                              cards=len(set(self.devices)))
            return out

    def _replayable(self, host: Grid) -> bool:
        """Whether :meth:`run_host` replays a captured graph for ``host``:
        K3 under the ``off`` schedule in one process, every tile
        page-locked and bound for a card, every two of the cards able to
        reach each other's memory (a copy between cards that cannot goes
        through the host, which no graph holds), and no profiler
        collecting: a replay records none of the exchange's spans, and a
        window of replays is ~460 device operations a job, more than a
        profiler's capture of a whole window can process."""
        if not (self.backend == "pallas" and self.overlap == "off"
                and self.peers is None and not _tracing.profiling()
                and torch.cuda.is_available()
                and all(d.type == "cuda" for d in self.devices)
                and all(t.is_pinned() for row in host for t in row)):
            return False
        if self._peer_ok is None:
            cards = {torch.cuda.current_device() if d.index is None
                     else d.index for d in self.devices}
            self._peer_ok = all(torch.cuda.can_device_access_peer(a, b)
                                for a in cards for b in cards if a != b)
        return self._peer_ok

    def _place_and_run(self, host: Grid, reps: int) -> Grid:
        """:meth:`run_host`'s placement and run by the chunks."""
        events = []
        tiles: Grid = []
        for row, drow in zip(host, self.mesh.devices):
            out_row = []
            for t, dev in zip(row, drow):
                if t is None:
                    out_row.append(None)
                elif dev.type == "cuda" and t.is_pinned():
                    out_row.append(t.to(dev, non_blocking=True))
                    events.append(
                        torch.cuda.current_stream(dev).record_event())
                else:
                    out_row.append(t.to(dev))
            tiles.append(out_row)
        try:
            return self.run(tiles, reps)
        finally:
            for ev in events:
                ev.synchronize()

    def fetch_into(self, tiles: Grid, host: Grid) -> Grid:
        """The padded tile grid ``tiles`` (:meth:`run`'s) copied into the
        host tile grid ``host`` (:meth:`host_tiles`' shapes): every copy
        issued non-blocking, then every card waited for. Returns
        ``host``."""
        for row, hrow in zip(tiles, host):
            for t, h in zip(row, hrow):
                if t is not None:
                    h.copy_(t, non_blocking=True)
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        return host

    def run(self, tiles: Grid, repetitions: int) -> Grid:
        """``repetitions`` reps on the tiles (which are not written).
        Returns the padded tile grid (:meth:`fetch` crops it)."""
        return self._fn(tiles, int(repetitions), self._mask)

    def fetch(self, tiles: Grid) -> np.ndarray:
        """Stitch the tiles on the host and crop the pad off (one process
        holding every tile; across processes each writes its own,
        :func:`distributed.write_sharded`)."""
        if self.peers is not None:
            raise NotImplementedError(
                "a mesh over several processes is not stitched on one "
                "host; write it with distributed.write_sharded")
        rows = [np.concatenate([t.cpu().numpy() for t in row], axis=1)
                for row in tiles]
        return np.concatenate(rows, axis=0)[: self.h, : self.w]


class _Replay:
    """One job of ``reps`` reps on a runner's cards, captured once as a CUDA
    graph that spans the cards, and replayed from page-locked host tiles.

    Capture: the graph's input tiles placed from the first job's host
    tiles; the runner's rep loop built anew for the graph (where the
    chunks pull their ghost rings, :mod:`~tpu_stencil_torch.parallel.
    fill`, its slab is the graph's alone); one eager run on a side stream
    per card (K3 built, peer access on, the allocator and the slab made);
    then the run again under capture on those
    streams, the other cards' streams forked from the first card's and
    joined back into it, and each card's allocations in a pool of the
    graph's own (the first card's by the graph, the others' by a
    ``MemPool`` each), so nothing outside the graph reuses memory a replay
    writes. A replay copies each host tile into the graph's input on its
    card's side stream, behind the last job's clones, launches the graph
    behind the copies, and clones each output on the caller's current
    stream of its card behind the graph, so a result outlives the next
    replay; the copies are waited for before it returns or raises."""

    def __init__(self, runner: "ShardedRunner", host: Grid, reps: int):
        self.grid = runner.mesh.devices
        self.devices = list(dict.fromkeys(runner.devices))
        self.streams = {d: torch.cuda.Stream(d) for d in self.devices}
        self.inputs = _map(lambda t, d: t.to(d), host, self.grid)
        self.cloned: Dict[torch.device, torch.cuda.Event] = {}
        # The runner's rep loop built anew: a slab of its own where the
        # chunks pull their rings (fill.py), which no other job touches.
        run = runner._build(runner.overlap)
        self._sync()
        with self._on_streams():
            run(self.inputs, reps, runner._mask)
        self._sync()
        first = self.devices[0]
        self.pools = {}
        for d in self.devices[1:]:
            with torch.cuda.device(d):
                self.pools[d] = torch.cuda.MemPool()
        self.graph = torch.cuda.CUDAGraph()
        before = cs.launch_counts()
        with contextlib.ExitStack() as stack:
            for d, pool in self.pools.items():
                stack.enter_context(torch.cuda.use_mem_pool(pool, d))
            stack.enter_context(self._on_streams())
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                fork = self.streams[first].record_event()
                for d in self.devices[1:]:
                    self.streams[d].wait_event(fork)
                self.outputs = run(self.inputs, reps, runner._mask)
                for d in self.devices[1:]:
                    self.streams[first].wait_event(
                        self.streams[d].record_event())
            finally:
                self.graph.capture_end()
        # K3's launches the graph holds
        self.launches = sum(n - before[k]
                            for k, n in cs.launch_counts().items())

    def _sync(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)

    def _on_streams(self):
        """Every card's side stream current; the first card's last, so it
        is also the current device."""
        stack = contextlib.ExitStack()
        for d in self.devices[1:] + self.devices[:1]:
            stack.enter_context(torch.cuda.stream(self.streams[d]))
        return stack

    def run(self, host: Grid) -> Grid:
        first = self.streams[self.devices[0]]
        events = []
        for row, xrow, drow in zip(host, self.inputs, self.grid):
            for t, x, d in zip(row, xrow, drow):
                s = self.streams[d]
                if d in self.cloned:
                    s.wait_event(self.cloned[d])
                with torch.cuda.stream(s):
                    x.copy_(t, non_blocking=True)
                events.append(s.record_event())
                first.wait_event(events[-1])
        try:
            with torch.cuda.stream(first):
                self.graph.replay()
            done = first.record_event()
            out: Grid = []
            for yrow, drow in zip(self.outputs, self.grid):
                out.append([])
                for y, d in zip(yrow, drow):
                    cur = torch.cuda.current_stream(d)
                    cur.wait_event(done)
                    out[-1].append(y.clone())
                    self.cloned[d] = cur.record_event()
            return out
        finally:
            for ev in events:
                ev.synchronize()


# ---------------------------------------------------------------------------
# The process-shared runner cache
# ---------------------------------------------------------------------------

RUNNER_CACHE_CAP = 8

# A geometry the mesh cannot serve, cached so that a retry never re-pays
# the refused build.
_UNSERVABLE = object()
_runner_cache: "collections.OrderedDict" = collections.OrderedDict()
_runner_cache_lock = threading.Lock()


def _resolved_mesh_for_key(mesh_shape, devices, image_shape):
    """(mesh_shape, devices) as the runner will build over them: an
    explicit RxC takes the first R*C devices; None takes every device
    under the perimeter-minimizing grid. Keyed on the resolved shape, an
    explicit RxC and the default grid share an entry whenever they
    resolve alike."""
    if devices is None:
        from tpu_stencil_torch.devices import resolve_devices

        devices = resolve_devices()
    devices = [torch.device(d) for d in devices]
    if mesh_shape is not None:
        r, c = mesh_shape
        if r * c > len(devices):
            raise ValueError(
                f"mesh shape {r}x{c} needs {r * c} devices, "
                f"have {len(devices)}"
            )
        return (r, c), devices[: r * c]
    shape = partition.grid_shape(len(devices), *image_shape)
    return tuple(shape), devices


def runner_key(model, image_shape, channels, mesh_shape, devices,
               overlap: str, pipe_stages: int = 1):
    """The cache identity of one runner: everything it depends on (the
    plan, the image and channels, the model's backend request, schedule,
    forced geometry and boundary, the spatial mesh shape, the device set,
    the overlap mode, and the temporal stage count: a K-stage pipeline
    over the same devices is another runner than the K'-stage one)."""
    plan = model.plan
    taps = ";".join(",".join(str(v) for v in row) for row in plan.taps)
    return (
        plan.kind, str(plan.divisor), taps, bool(plan.xla_pair_add),
        tuple(image_shape), channels,
        getattr(model, "backend", "auto"),
        getattr(model, "schedule", None),
        getattr(model, "block_h", None),
        getattr(model, "fuse", None),
        getattr(model, "boundary", "zero"),
        tuple(mesh_shape),
        tuple(str(torch.device(d)) for d in devices),
        overlap,
        int(pipe_stages),
    )


def shared_runner(model, image_shape, channels, mesh_shape=None,
                  devices=None, overlap: str = "off", registry=None,
                  build_wrapper=None) -> Optional["ShardedRunner"]:
    """The cached :class:`ShardedRunner` for this identity, or None when
    the mesh cannot serve the geometry (the build raised ValueError or
    NotImplementedError: a tile smaller than the filter halo, a periodic
    image that does not divide the grid; the refusal is cached).
    ``registry`` counts ``sharded_runner_{hits,misses,evictions}_total``
    and ``sharded_fallbacks_total``. ``build_wrapper`` wraps a cold build
    (serve's ``serve.sharded_runner_build`` span and its ``compile``
    fault site): it receives the zero-argument builder and must call
    it."""
    rshape, rdevs = _resolved_mesh_for_key(mesh_shape, devices,
                                           image_shape)
    key = runner_key(model, image_shape, channels, rshape, rdevs, overlap)

    def build():
        return ShardedRunner(model, tuple(image_shape), channels,
                             mesh_shape=rshape, devices=rdevs,
                             overlap=overlap)

    return cached_runner(key, build, registry=registry,
                         build_wrapper=build_wrapper)


def cached_runner(key, build, registry=None, build_wrapper=None):
    """Get or build against the one process-shared LRU of runners
    (:class:`ShardedRunner`, and the temporal pipeline's
    :class:`~tpu_stencil_torch.parallel.pipeline.PipelineRunner` under its
    own key): one cap, one set of counters, a deterministic geometry
    refusal cached as unservable (None)."""
    with _runner_cache_lock:
        hit = _runner_cache.get(key)
        if hit is not None:
            _runner_cache.move_to_end(key)
    if hit is not None:
        if registry is not None:
            registry.counter("sharded_runner_hits_total").inc()
        return None if hit is _UNSERVABLE else hit
    if registry is not None:
        registry.counter("sharded_runner_misses_total").inc()
    try:
        runner = build_wrapper(build) if build_wrapper else build()
    except (ValueError, NotImplementedError):
        # A deterministic geometry refusal; transient and build failures
        # raise other types and are not cached.
        runner = _UNSERVABLE
        if registry is not None:
            registry.counter("sharded_fallbacks_total").inc()
    with _runner_cache_lock:
        _runner_cache[key] = runner
        _runner_cache.move_to_end(key)
        while len(_runner_cache) > RUNNER_CACHE_CAP:
            _runner_cache.popitem(last=False)
            if registry is not None:
                registry.counter("sharded_runner_evictions_total").inc()
    return None if runner is _UNSERVABLE else runner


def runner_cache_len() -> int:
    with _runner_cache_lock:
        return len(_runner_cache)


def clear_runner_cache() -> None:
    """Drop every cached runner (tests; the LRU cap bounds a long-lived
    process)."""
    with _runner_cache_lock:
        _runner_cache.clear()
