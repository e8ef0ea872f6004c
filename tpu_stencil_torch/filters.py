"""Filter bank: named (k x k) convolution kernels as taps + divisor.

The port's own copy of the JAX package's filter registry (same taps, same
divisors, same ``is_exact``/``is_dyadic`` gates, same parametric
``gaussian<k>`` family), kept separate so that the port imports nothing of
the JAX package. The reference program picks one of ``box_blur`` /
``gaussian_blur`` / ``edge_detection`` at compile time
(``mpi/mpi_convolution.c:90-102``); here the filter is a runtime value.

A :class:`Filter` keeps integer taps and the divisor separate (the
reference pre-divides them) so that accumulation is exact and
order-independent, and the one divide is the only rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Union

import numpy as np

# With integer-valued taps every partial sum is an exact integer while
# 255 * sum(|taps|) < 2**24, so one int->float32 convert before the divide
# is exact.
_EXACT_LIMIT = 2 ** 24


@dataclasses.dataclass(frozen=True)
class Filter:
    """A stencil filter as integer-valued taps plus a normalization divisor.

    For dyadic divisors (the gaussian family: /16, /256, ...) the divide is
    a shift and the whole pipeline is integer; otherwise the single
    correctly rounded float32 divide is the one rounding.
    """

    taps: np.ndarray  # (k, k) float32
    divisor: float = 1.0

    def __post_init__(self) -> None:
        taps = np.asarray(self.taps, dtype=np.float32)
        object.__setattr__(self, "taps", taps)
        k = taps.shape[0]
        if taps.ndim != 2 or taps.shape != (k, k) or k % 2 != 1:
            raise ValueError(f"filter taps must be square with odd size, got {taps.shape}")
        if not self.divisor > 0:
            raise ValueError(f"divisor must be positive, got {self.divisor}")

    @property
    def k(self) -> int:
        return self.taps.shape[0]

    @property
    def halo(self) -> int:
        return self.k // 2

    @property
    def is_dyadic(self) -> bool:
        """True if the divisor is a positive power of two (divide == shift)."""
        d = float(self.divisor)
        return d.is_integer() and d > 0 and (int(d) & (int(d) - 1)) == 0

    @property
    def is_exact(self) -> bool:
        """True if the defined semantics are reproducible exactly.

        Integer taps required. With a dyadic divisor the whole pipeline is
        integer (shift), exact to the int32 accumulation bound; with a
        general divisor the int accumulation must stay below 2^24 so the
        one int->float32 convert before the divide is exact.
        """
        taps = self.taps
        if not bool(np.all(taps == np.round(taps))):
            return False
        bound = 255.0 * float(np.abs(taps).sum())
        if self.is_dyadic:
            return bound < 2 ** 31
        return bound < _EXACT_LIMIT


FilterLike = Union[Filter, np.ndarray]


def as_filter(f: FilterLike) -> Filter:
    """Coerce a raw (k, k) float array (pre-normalized taps) to a Filter."""
    if isinstance(f, Filter):
        return f
    return Filter(np.asarray(f, dtype=np.float32), 1.0)


def from_numpy(taps, divisor: float = 1.0) -> Filter:
    """A Filter from plain values, e.g. another package's ``(taps,
    divisor)`` pair — the way tests hand both packages the same filter."""
    return Filter(np.asarray(taps, dtype=np.float32), float(divisor))


# Registry maps name -> () -> Filter (lazy thunks).
_REGISTRY: Dict[str, Callable[[], FilterLike]] = {}


def register_filter(name: str, fn: Callable[[], FilterLike]) -> None:
    """Register a named filter. ``fn`` returns a Filter (or a raw (k, k)
    float array of pre-normalized taps, divisor 1)."""
    _REGISTRY[name] = fn


def get_filter(name: str) -> Filter:
    """Look up a filter by name.

    Accepts parametric names ``gaussian5``, ``gaussian7``, ... (odd k) for
    binomial blur kernels of arbitrary width.
    """
    if name in _REGISTRY:
        return as_filter(_REGISTRY[name]())
    if name.startswith("gaussian") and name[len("gaussian"):].isdigit():
        return binomial_blur(int(name[len("gaussian"):]))
    raise KeyError(
        f"unknown filter {name!r}; available: {sorted(_REGISTRY)} "
        "or gaussian<odd k>"
    )


def binomial_blur(k: int) -> Filter:
    """Separable binomial approximation to a Gaussian, k odd; divisor
    2^(2k-2) is dyadic, so the whole pipeline is exact."""
    if k % 2 != 1 or k < 1:
        raise ValueError(f"binomial blur size must be odd and >= 1, got {k}")
    row = np.array([math.comb(k - 1, i) for i in range(k)], dtype=np.float32)
    return Filter(np.outer(row, row), float(2 ** (2 * (k - 1))))


# --- the reference's three filters (same taps, same divisors) ---------------

register_filter("box", lambda: Filter(np.ones((3, 3), np.float32), 9.0))
register_filter(
    "gaussian",
    lambda: Filter(np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32), 16.0),
)
register_filter(
    # The reference calls this "edge_detection" (taps [[1,4,1],[4,8,4],[1,4,1]]/28);
    # it is another low-pass kernel — name kept for CLI parity, with an
    # honest alias.
    "edge",
    lambda: Filter(np.array([[1, 4, 1], [4, 8, 4], [1, 4, 1]], np.float32), 28.0),
)
register_filter("soft_blur", _REGISTRY["edge"])
register_filter(
    "identity",
    lambda: Filter(np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32), 1.0),
)


class _FiltersView:
    """Read-only mapping view over the registry (materializes Filters)."""

    def __iter__(self):
        return iter(_REGISTRY)

    def __contains__(self, name: str) -> bool:
        return name in _REGISTRY

    def __getitem__(self, name: str) -> Filter:
        return get_filter(name)

    def keys(self):
        return _REGISTRY.keys()


FILTERS = _FiltersView()
