"""Shape-bucket policy: pad heterogeneous requests onto a small ladder.

The port's copy of the JAX package's ``serve/bucketing.py``, same ladder
and same arithmetic. A stream of arbitrary (H, W, C) requests would build one bucket program per
distinct shape — the compile amortization the whole serving layer exists
for would never land. Instead each spatial dim rounds UP to a ladder edge
(bottom/right zero-pad, the :func:`tpu_stencil_torch.parallel.partition.pad_amounts`
semantics: the pad region is re-zeroed every repetition by the engine's
masked step, preserving exact zero-boundary results at the true edge).
Requests above the top edge pad to the next top-edge multiple, so no size
is ever refused for being big — only for the queue being full.

The batch axis is bucketed too (next power of two up to ``max_batch``,
short batches padded with zero frames): N distinct queue depths must not
mean N programs.

Everything here is pure and imports no torch, so the policy is
unit-testable without a device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from tpu_stencil_torch.parallel import partition

# Default spatial ladder. Starts at 8 rows/columns, roughly
# x1.5 steps: adjacent real-world sizes share buckets while worst-case
# padded-pixel waste stays ~2.25x area (measured per request by the
# ``padded_pixels_total`` counter against ``image_pixels_total``).
DEFAULT_EDGES: Tuple[int, ...] = (
    8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
    1536, 2048, 3072,
)


def bucket_dim(n: int, edges: Sequence[int] = DEFAULT_EDGES) -> int:
    """Smallest ladder edge >= n; above the top edge, the next top-edge
    multiple (via ``partition.pad_amounts`` — same bottom/right pad math
    as the sharded mesh's indivisible-shape handling)."""
    if n < 1:
        raise ValueError(f"dim must be >= 1, got {n}")
    for e in edges:
        if n <= e:
            return e
    top = edges[-1]
    return n + partition.pad_amounts(n, 1, (top, 1))[0]


def bucket_shape(
    h: int, w: int, edges: Sequence[int] = DEFAULT_EDGES
) -> Tuple[int, int]:
    """The (bucket_h, bucket_w) canvas a (h, w) request is served in."""
    return bucket_dim(h, edges), bucket_dim(w, edges)


def batch_bucket(n: int, max_batch: int) -> int:
    """Padded batch size for n pending requests: next power of two,
    capped at ``max_batch`` (the scheduler never takes more than
    ``max_batch`` requests in one dispatch)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def waste_pixels(
    true_shapes: Sequence[Tuple[int, int]], bucket_hw: Tuple[int, int],
    n_padded: int,
) -> int:
    """Padded-pixel overhead of one dispatched batch: bucket area beyond
    each request's true area, plus whole zero frames padding the batch
    axis. Device memory moves these bytes for nothing — the waste counter
    is the cost side of the fewer-programs trade."""
    bh, bw = bucket_hw
    area = bh * bw
    real = sum(h * w for h, w in true_shapes)
    return area * n_padded - real
