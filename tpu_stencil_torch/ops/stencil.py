"""The stencil op: zero-padded (k x k) convolution with uint8 truncation.

Semantics match the reference's MPI variant exactly, as the JAX package
defines them:

* **Boundary**: the global image border is zero-padded every iteration —
  the MPI variant's calloc'd ghost ring (``mpi/mpi_convolution.c:104-124``).
  Every pixel, edges included, is computed every iteration.
* **Arithmetic**: ``uint8`` pixels times integer-valued ``float32`` taps,
  accumulated in ``float32`` (exact integer math below 2^24), then ONE
  divide by the filter divisor and a truncating ``uint8`` store (the
  implicit C cast at ``mpi/mpi_convolution.c:307``), defined as a clip
  outside [0, 255].

These torch functions are the port's ``reference`` backend (f32 MACs as
k*k shifted adds — no ``F.conv2d``, whose cuDNN path runs float32 in TF32
by default). :func:`reference_stencil_numpy` is the pure-NumPy golden
model, sharing no code with any fast path.
"""

from __future__ import annotations

import numpy as np
import torch


def truncate_u8(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 with C-cast semantics for in-range values (truncate
    toward zero), clip outside [0, 255] (clip first: torch's cast of an
    out-of-range float is not a clip)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def _check_filter(filt: torch.Tensor) -> int:
    k = filt.shape[0]
    if tuple(filt.shape) != (k, k) or k % 2 != 1:
        raise ValueError(f"filter must be square with odd size, got {tuple(filt.shape)}")
    return k


def conv2d_valid(padded: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """'Valid' 2-D correlation of a halo-extended float32 tensor
    (H+2h, W+2h[, C]) with ``filt`` (k, k) float32, as k*k shifted adds in
    row-major tap order, producing (H, W[, C])."""
    k = _check_filter(filt)
    h = padded.shape[0] - (k - 1)
    w = padded.shape[1] - (k - 1)
    taps = [[float(v) for v in row] for row in filt.tolist()]
    acc = None
    for i in range(k):
        for j in range(k):
            window = padded[i : i + h, j : j + w]
            term = window * taps[i][j]
            acc = term if acc is None else acc + term
    return acc


def conv2d_zero_pad(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' 2-D correlation of ``x`` (H, W) or (H, W, C)
    float32 with ``filt`` (k, k) float32."""
    halo = _check_filter(filt) // 2
    shape = list(x.shape)
    shape[0] += 2 * halo
    shape[1] += 2 * halo
    padded = torch.zeros(shape, dtype=x.dtype, device=x.device)
    padded[halo : halo + x.shape[0], halo : halo + x.shape[1]] = x
    return conv2d_valid(padded, filt)


def stencil_step(img_u8: torch.Tensor, taps: torch.Tensor,
                 divisor: float) -> torch.Tensor:
    """One filter application on a uint8 image: exact integer-valued f32
    accumulation of ``taps``, one divide by ``divisor``, truncating uint8
    store."""
    from tpu_stencil_torch.ops.lowering import divide_f32

    acc = conv2d_zero_pad(img_u8.to(torch.float32), taps)
    return truncate_u8(divide_f32(acc, float(divisor)))


def reference_stencil_numpy(
    img_u8: np.ndarray, filt, reps: int, boundary: str = "zero"
) -> np.ndarray:
    """Pure-NumPy golden model of ``reps`` iterations: explicit per-pixel
    loops over a padded buffer, mirroring ``ConvolutionforGrey/RGB``
    (``mpi/mpi_convolution.c:301-322``). Tests and small on-card checks
    only — O(H*W*k*k*reps) slow.

    ``boundary``: 'zero' (the MPI code's calloc'd ghost ring) or
    'periodic' (wraparound). ``filt`` is a
    :class:`tpu_stencil_torch.filters.Filter` (or raw normalized array,
    divisor 1). Exact filters accumulate in int64 — the defined semantics
    every fast path must reproduce bit for bit; others in float32 in
    row-major tap order."""
    from tpu_stencil_torch.filters import as_filter

    if boundary not in ("zero", "periodic"):
        raise ValueError(f"unknown boundary {boundary!r}")
    f = as_filter(filt)
    taps, divisor = f.taps, np.float32(f.divisor)
    k = f.k
    halo = f.halo
    exact = f.is_exact
    dyadic = f.is_dyadic
    squeeze = img_u8.ndim == 2
    img = img_u8[..., None] if squeeze else img_u8
    h, w, c = img.shape
    cur = img.astype(np.uint8)
    for _ in range(reps):
        if boundary == "periodic":
            padded = np.pad(
                cur, ((halo, halo), (halo, halo), (0, 0)), mode="wrap"
            )
        else:
            padded = np.zeros((h + 2 * halo, w + 2 * halo, c), np.uint8)
            padded[halo : halo + h, halo : halo + w] = cur
        out = np.empty_like(cur)
        for y in range(h):
            for x in range(w):
                if exact:
                    acc = np.zeros(c, np.int64)
                    for i in range(k):
                        for j in range(k):
                            acc += padded[y + i, x + j].astype(np.int64) * int(
                                round(float(taps[i, j]))
                            )
                    if dyadic:
                        val = acc // int(divisor)
                    else:
                        # one exact convert (is_exact bounds acc < 2^24)
                        # and one correctly rounded divide
                        val = acc.astype(np.float32) / divisor
                else:
                    acc = np.zeros(c, np.float32)
                    for i in range(k):
                        for j in range(k):
                            acc += (
                                padded[y + i, x + j].astype(np.float32)
                                * np.float32(taps[i, j])
                            )
                    val = acc / divisor
                out[y, x] = np.clip(val, 0.0, 255.0).astype(np.uint8)
        cur = out
    return cur[..., 0] if squeeze else cur
