"""Sharded iterated convolution over an R x C mesh of devices.

The port's counterpart of the JAX package's ``parallel/sharded.py``
(``shard_map`` over a 2-D device mesh) and of the reference MPI program's
hot loop (``mpi/mpi_convolution.c:156-240``): per iteration, a halo
exchange between the tiles (:mod:`tpu_stencil_torch.parallel.halo`), then
the local stencil on each ghost-extended tile. All tiles live in one
process, each on its mesh device (:mod:`tpu_stencil_torch.parallel.mesh`);
the rep loop is a Python loop and every step builds fresh tiles.

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

Under tracing the runner splits its time into exchange and compute by
two probes outside the timed window (:meth:`ShardedRunner.
trace_phase_probes`). The interior/border overlap schedules
(``--overlap``) with their per-edge probes, several processes
(``torch.distributed``) and the shared runner cache are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.parallel import partition
from tpu_stencil_torch.parallel.halo import Grid, halo_exchange
from tpu_stencil_torch.parallel.mesh import COLS_AXIS, ROWS_AXIS, make_mesh


def _apply_mask(tiles: Grid, mask: Optional[Grid]) -> Grid:
    if mask is None:
        return tiles
    return [[t * m for t, m in zip(row, mrow)]
            for row, mrow in zip(tiles, mask)]


def _local_step(tiles: Grid, plan: _lowering.StencilPlan,
                mask: Optional[Grid], boundary: str = "zero") -> Grid:
    """One rep over the grid in torch ops: halo exchange, the plan's step
    on every ghost-extended tile, then the pad re-zero.

    Separable plans exchange in two phases, like their compute: the row
    ghosts (as int32), the rows pass, then the col ghosts of the rows-pass
    output and the cols pass — the corner ghosts are never needed."""
    halo = plan.halo
    if plan.kind == "sep_int":
        xi = [[t.to(torch.int32) for t in row] for row in tiles]
        ext0 = halo_exchange(xi, halo, (0,), boundary)
        a = [[_lowering.sep_rows_pass(t, plan) for t in row] for row in ext0]
        ext1 = halo_exchange(a, halo, (1,), boundary)
        out = [[_lowering.sep_cols_pass(t, plan) for t in row]
               for row in ext1]
    else:
        ext = halo_exchange(tiles, halo, (0, 1), boundary)
        out = [[_lowering.valid_step(t, plan) for t in row] for row in ext]
    return _apply_mask(out, mask)


def _pallas_local_chunk(tiles: Grid, plan: _lowering.StencilPlan, fuse: int,
                        global_shape: Tuple[int, int],
                        mask: Optional[Grid],
                        block_h: Optional[int] = None) -> Grid:
    """``fuse`` reps for one exchange: widen the exchange to ``fuse *
    halo`` uint8 ghosts and run K3 on every tile, whose trusted band
    contracts by ``halo`` per rep — the ghosts recompute the neighbours'
    values exactly, so no further exchange is needed until the next
    chunk."""
    ext = halo_exchange(tiles, fuse * plan.halo, (0, 1))
    return _apply_mask(_valid_chunk(tiles, ext, plan, fuse, global_shape,
                                    block_h), mask)


def _valid_chunk(tiles: Grid, ext: Grid, plan: _lowering.StencilPlan,
                 fuse: int, global_shape: Tuple[int, int],
                 block_h: Optional[int] = None) -> Grid:
    """K3 at ``fuse`` reps on every ghost-extended tile of ``ext`` (the
    exchange of ``tiles``). Tile (i, j)'s interior starts at global row
    ``i * th`` and flat lane ``j * tw * C``."""
    g = fuse * plan.halo
    out = []
    for i, (row, erow) in enumerate(zip(tiles, ext)):
        orow = []
        for j, (t, e) in enumerate(zip(row, erow)):
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
                          block_h: Optional[int] = None):
    """The sharded rep loop: returns ``fn(tiles, reps, mask) -> tiles``.

    ``backend='pallas'`` runs ``reps // fuse`` K3 chunks, then the
    ``reps % fuse`` remainder one rep at a time (``global_shape`` = padded
    (rows, cols * C) required); any other backend runs :func:`_local_step`
    per rep. ``mask`` (a grid like the tiles, or None) multiplies every
    step's result."""
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

        def step_chunk(tiles, n_fused, mask):
            return _pallas_local_chunk(tiles, plan, n_fused, global_shape,
                                       mask, block_h=block_h)
    else:
        def step_chunk(tiles, n_fused, mask):
            return _local_step(tiles, plan, mask, boundary)

    def iterate(tiles: Grid, reps: int, mask: Optional[Grid] = None) -> Grid:
        tiles = [list(row) for row in tiles]
        if fuse > 1:
            for _ in range(reps // fuse):
                tiles = step_chunk(tiles, fuse, mask)
            reps %= fuse
        for _ in range(reps):
            tiles = step_chunk(tiles, 1, mask)
        return tiles

    return iterate


class ShardedRunner:
    """The mesh, padding geometry, mask and resolved local step for one
    image shape — the per-job state every reference rank kept in locals
    (tile dims, neighbour ranks, datatypes).

    ``devices`` may name one device several times (see
    :mod:`tpu_stencil_torch.parallel.mesh`)."""

    def __init__(
        self,
        model,
        image_shape: Tuple[int, int],
        channels: int,
        mesh_shape: Optional[Tuple[int, int]] = None,
        devices: Optional[Sequence] = None,
    ) -> None:
        self.model = model
        self.h, self.w = image_shape
        self.channels = channels
        self.mesh = make_mesh(mesh_shape, devices, image_shape=image_shape)
        self.mesh_shape = (self.mesh.shape[ROWS_AXIS],
                           self.mesh.shape[COLS_AXIS])
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
        # measures once per tile shape. One process holds every tile, so
        # the model's verdict needs no agreement step. A plan K3 cannot
        # take, or a periodic run, resolves to xla.
        self.backend, tuned_schedule = model.resolved_config(tile, channels)
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
        geo_bh, geo_fz = model.resolved_geometry(tile, channels)
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
        self._fn = build_sharded_iterate(
            model.plan, self.needs_mask, backend=self.backend,
            global_shape=self._global_shape,
            fuse=self.fuse, boundary=self.boundary,
            block_h=self._block_h,
        )
        self._mask = None
        if self.needs_mask:
            mask = np.zeros(self.padded_shape, np.uint8)
            mask[: self.h, : self.w] = 1
            if channels != 1:
                mask = np.repeat(mask[..., None], channels, axis=-1)
            self._mask = self.split(mask)

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the mesh, in row-major order."""
        return self.mesh.flat()

    def prepare(self) -> None:
        """Build (or load) K3 when this runner launches it, so no build
        lands in a timed window. Launches nothing."""
        if self.backend == "pallas" and any(
                d.type == "cuda" for d in self.devices):
            cs.build_kernels()

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
        scratch = [[t.clone() for t in row] for row in tiles]
        for n in depths:
            scratch = self.run(scratch, n)
        return scratch

    def describe_launches(self, depths) -> List[dict]:
        """The K3 instance each chunk of ``depths`` reps launches on every
        tile (:func:`cuda_stencil.describe_launch`, with ``launches`` the
        tiles per chunk); empty off the kernels."""
        if self.backend != "pallas":
            return []
        th, tw = self.tile
        return [dict(cs.describe_launch(
            "stencil_valid", self.model.plan, th, tw * self.channels,
            self.channels, self._block_h, d, self.devices[0]),
            launches=len(self.devices)) for d in depths]

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
                return tiles, halo_exchange(tiles, g, (0, 1))

            def compute(pair):
                return _valid_chunk(pair[0], pair[1], plan, self.fuse,
                                    self._global_shape, self._block_h)
        else:
            def exchange(tiles):
                return tiles, halo_exchange(tiles, plan.halo, (0, 1),
                                            self.boundary)

            def compute(pair):
                return [[_lowering.valid_step(t, plan) for t in row]
                        for row in pair[1]]
        return exchange, compute

    def trace_phase_probes(self, tiles: Grid) -> None:
        """Emit ``sharded.halo_exchange`` and ``sharded.interior_compute``
        spans: one measured run each of an exchange-only and a
        compute-only step of one chunk (``reps`` = its depth), after one
        untimed run of both (``sharded.probe_compile``), so the trace
        splits the runner's time into exchange and compute. Tracing only;
        the timed window never runs them."""
        from tpu_stencil_torch import obs

        if not obs.enabled() or self.model.plan.halo < 1:
            return
        exchange, compute = self._phase_probes()
        reps = self.fuse if self.backend == "pallas" else 1
        with obs.span("sharded.probe_compile", "sharded") as s:
            s.fence(compute(s.fence(exchange(tiles))))
        with obs.span("sharded.halo_exchange", "sharded", reps=reps) as s:
            pair = s.fence(exchange(tiles))
        with obs.span("sharded.interior_compute", "sharded",
                      reps=reps) as s:
            s.fence(compute(pair))

    def split(self, padded: np.ndarray) -> Grid:
        """Cut a padded global (H, W[, C]) array into the tile grid, each
        tile on its mesh device."""
        th, tw = self.tile
        return [
            [torch.from_numpy(np.ascontiguousarray(
                padded[i * th:(i + 1) * th, j * tw:(j + 1) * tw]))
             .to(dev) for j, dev in enumerate(row)]
            for i, row in enumerate(self.mesh.devices)
        ]

    def put(self, img: np.ndarray) -> Grid:
        """Pad to the tile grid and place every tile on its device — the
        analog of every rank loading its rows
        (``mpi/mpi_convolution.c:126-141``)."""
        img = np.asarray(img, dtype=np.uint8)
        if img.shape[:2] != (self.h, self.w):
            raise ValueError(f"image shape {img.shape} != {(self.h, self.w)}")
        ph = self.padded_shape[0] - self.h
        pw = self.padded_shape[1] - self.w
        if ph or pw:
            img = np.pad(img, [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2))
        return self.split(img)

    def run(self, tiles: Grid, repetitions: int) -> Grid:
        """``repetitions`` reps on the tiles (which are not written).
        Returns the padded tile grid (:meth:`fetch` crops it)."""
        return self._fn(tiles, int(repetitions), self._mask)

    def fetch(self, tiles: Grid) -> np.ndarray:
        """Stitch the tiles on the host and crop the pad off."""
        rows = [np.concatenate([t.cpu().numpy() for t in row], axis=1)
                for row in tiles]
        return np.concatenate(rows, axis=0)[: self.h, : self.w]
