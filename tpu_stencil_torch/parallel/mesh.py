"""Device mesh: an (R, C) grid of ``torch.device``\\ s over the image.

The port's counterpart of the JAX package's ``parallel/mesh.py`` (a
``jax.sharding.Mesh``) and of the reference's ``MPI_Init`` + rank/size +
row-major neighbour discovery (``mpi/mpi_convolution.c:23-25,142-150``).
Tile (i, j) of the image lives on ``mesh.devices[i][j]``; its neighbours
are the tiles at (i +- 1, j) and (i, j +- 1)
(:mod:`tpu_stencil_torch.parallel.halo`).

The device list may name one device several times — ``[cuda:0] * 4`` is a
2x2 mesh on one card, ``[cpu] * 8`` a 2x4 mesh on the CPU — so a mesh of
several tiles runs, and is tested, where only one device exists.

With several processes (``torch.distributed``) the mesh is global: it is
built from every rank's local device list, gathered and ordered by rank
(as the JAX package sorts by ``process_index``), and each tile has an
owner rank (:attr:`Mesh.owners`). The automatic shape keeps each mesh row
within one process where the counts allow (the column count divides the
per-process device count), so only the strips between mesh rows cross
processes; an explicit ``RxC`` must span every device of every process.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_stencil_torch.parallel import partition

ROWS_AXIS = "rows"
COLS_AXIS = "cols"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (R, C) grid of devices; ``devices[i][j]`` holds tile (i, j).

    ``owners[i][j]`` is the rank that holds tile (i, j) when the mesh
    spans several processes (``None``: this process holds every tile);
    ``rank`` is this process's. A remote tile's device is the one it has
    in its owner's process."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    owners: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        """``{ROWS_AXIS: R, COLS_AXIS: C}``, as a ``jax.sharding.Mesh``."""
        return {ROWS_AXIS: len(self.devices), COLS_AXIS: len(self.devices[0])}

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    def is_local(self, i: int, j: int) -> bool:
        """Whether this process holds tile (i, j)."""
        return self.owners is None or self.owners[i][j] == self.rank

    def flat(self) -> List[torch.device]:
        """The devices of this process's tiles in row-major order."""
        return [d for i, row in enumerate(self.devices)
                for j, d in enumerate(row) if self.is_local(i, j)]


def make_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    image_shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """Build a (rows, cols) mesh over ``devices`` (default: every visible
    CUDA device). A device may appear more than once (see the module
    docstring). Across processes ``devices`` are this process's and the
    mesh spans every rank's (a collective: every rank calls it).

    ``mesh_shape`` of None picks the perimeter-minimizing factorization of
    the device count for ``image_shape`` (square-ish if no image given).
    """
    from tpu_stencil_torch.parallel import distributed

    if devices is None:
        from tpu_stencil_torch.devices import resolve_devices

        devices = resolve_devices()
    devices = [torch.device(d) for d in devices]
    n_procs = distributed.process_count()
    ranks = [0] * len(devices)
    if n_procs > 1:
        per_rank = [json.loads(b) for b in distributed.allgather_bytes(
            json.dumps([str(d) for d in devices]).encode())]
        ranks = [p for p, ds in enumerate(per_rank) for _ in ds]
        devices = [torch.device(d) for ds in per_rank for d in ds]
    n = len(devices)
    if mesh_shape is None:
        h, w = image_shape if image_shape is not None else (1, 1)
        per_proc = n // n_procs if n % n_procs == 0 else 0
        mesh_shape = partition.grid_shape(
            n, h, w, cols_must_divide=per_proc if n_procs > 1 else 0)
    r, c = mesh_shape
    if r * c != n:
        raise ValueError(
            f"mesh shape {r}x{c} != {n} devices"
            + (f" (a mesh across {n_procs} processes spans every device "
               "of every process)" if n_procs > 1 else ""))

    def grid(xs):
        return tuple(tuple(xs[i * c:(i + 1) * c]) for i in range(r))

    if n_procs == 1:
        return Mesh(grid(devices))
    return Mesh(grid(devices), grid(ranks), distributed.process_index())
