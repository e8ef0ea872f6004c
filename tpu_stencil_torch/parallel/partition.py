"""Spatial partitioner: factor N devices into a perimeter-minimizing grid.

A copy of the JAX package's ``parallel/partition.py`` (pure Python; the
port keeps its own copy so it imports nothing of that package). The math
of the reference's ``RowsDivision`` (``mpi/mpi_convolution.c:350-364``):
choose r x c = N minimizing per-tile perimeter ``h/r + w/c`` — i.e. halo
traffic per device. Generalized in two ways the reference refuses (it aborts
on indivisible shapes, ``mpi/mpi_convolution.c:54-58``):

* any factorization of N is considered, not just the first divisor sweep;
* indivisible H/W are handled by padding the image up to the next multiple
  and masking the pad region every iteration (zero semantics preserved).
"""

from __future__ import annotations

from typing import Optional, Tuple


def grid_shape(
    n_devices: int, height: int, width: int,
    cols_must_divide: int = 0,
) -> Tuple[int, int]:
    """Perimeter-minimizing (rows, cols) grid with rows*cols == n_devices.

    Minimizes ``height/rows + width/cols`` (proportional to halo bytes per
    device) over all factor pairs; ties broken toward more row splits
    (contiguous rows = friendlier raw-file I/O offsets).

    ``cols_must_divide`` > 0 restricts candidates to ``cols`` dividing that
    value (with devices grouped by host and ``cols`` dividing the per-host
    device count, every mesh row is made of whole-host runs). Falls back to
    the unconstrained optimum when no factorization satisfies it.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")

    def search(constrained: bool) -> Optional[Tuple[int, int]]:
        best = None
        best_r = 0
        for r in range(1, n_devices + 1):
            if n_devices % r:
                continue
            c = n_devices // r
            if constrained and cols_must_divide % c:
                continue
            cost = height / r + width / c
            key = (cost, -r)
            if best is None or key < best:
                best = key
                best_r = r
        return (best_r, n_devices // best_r) if best_r else None

    if cols_must_divide > 0:
        got = search(constrained=True)
        if got is not None:
            return got
    return search(constrained=False)


def pad_amounts(height: int, width: int, grid: Tuple[int, int]) -> Tuple[int, int]:
    """Bottom/right zero-pad needed to make (H, W) divisible by the grid."""
    r, c = grid
    return (-height) % r, (-width) % c


def tile_shape(height: int, width: int, grid: Tuple[int, int]) -> Tuple[int, int]:
    """Per-device tile shape after padding."""
    r, c = grid
    ph, pw = pad_amounts(height, width, grid)
    return (height + ph) // r, (width + pw) // c
