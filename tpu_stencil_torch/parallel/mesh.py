"""Device mesh: an (R, C) grid of ``torch.device``\\ s over the image.

The port's counterpart of the JAX package's ``parallel/mesh.py`` (a
``jax.sharding.Mesh``) and of the reference's ``MPI_Init`` + rank/size +
row-major neighbour discovery (``mpi/mpi_convolution.c:23-25,142-150``).
Tile (i, j) of the image lives on ``mesh.devices[i][j]``; its neighbours
are the tiles at (i +- 1, j) and (i, j +- 1)
(:mod:`tpu_stencil_torch.parallel.halo`).

All tiles live in one process. The device list may name one device several
times — ``[cuda:0] * 4`` is a 2x2 mesh on one card, ``[cpu] * 8`` a 2x4
mesh on the CPU — so a mesh of several tiles runs, and is tested, where
only one device exists.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_stencil_torch.parallel import partition

ROWS_AXIS = "rows"
COLS_AXIS = "cols"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (R, C) grid of devices; ``devices[i][j]`` holds tile (i, j)."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        """``{ROWS_AXIS: R, COLS_AXIS: C}``, as a ``jax.sharding.Mesh``."""
        return {ROWS_AXIS: len(self.devices), COLS_AXIS: len(self.devices[0])}

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    def flat(self) -> List[torch.device]:
        """The devices in row-major order."""
        return [d for row in self.devices for d in row]


def make_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    image_shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """Build a (rows, cols) mesh over ``devices`` (default: every visible
    CUDA device). A device may appear more than once (see the module
    docstring).

    ``mesh_shape`` of None picks the perimeter-minimizing factorization of
    the device count for ``image_shape`` (square-ish if no image given).
    """
    if devices is None:
        from tpu_stencil_torch.devices import resolve_devices

        devices = resolve_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if mesh_shape is None:
        h, w = image_shape if image_shape is not None else (1, 1)
        mesh_shape = partition.grid_shape(n, h, w)
    r, c = mesh_shape
    if r * c != n:
        raise ValueError(f"mesh shape {r}x{c} != {n} devices")
    return Mesh(tuple(tuple(devices[i * c:(i + 1) * c]) for i in range(r)))
