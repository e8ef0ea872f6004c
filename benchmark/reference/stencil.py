"""The plain reference: ``reps`` applications of a k x k stencil to a uint8
image, in plain PyTorch (on any device).

Copied, as semantics, from ``tpu_stencil_torch/ops/stencil.py``
(``reference_stencil_numpy``, the port's golden model) at commit fcf1ca9,
so that a later change to the port cannot move the yardstick. Those
semantics are the upstream MPI program's (``mpi/mpi_convolution.c``):

* the image border is zero-padded every rep;
* integer taps accumulate exactly (int32 here; the taps and pixels of a
  configuration keep every sum far below 2**31), then one divide by the
  divisor: a floor division when it is a power of two, else one correctly
  rounded float32 divide (the sum is exact in float32 below 2**24);
* the store truncates toward zero and clips to [0, 255].

``accumulate=torch.float16`` (or ``torch.bfloat16``) makes the control
of the check: the same taps, summed in that precision in row-major tap
order, then the same divide and store. It breaks the configuration's
exact arithmetic, as a lower-precision rewrite of the kernels would.

Nothing here imports the program: the filter comes from the
configuration's file, and the input from the benchmark.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _is_pow2(d: float) -> bool:
    return d >= 1 and float(d).is_integer() and (int(d) & (int(d) - 1)) == 0


def step(x: torch.Tensor, taps: Sequence[Sequence[float]], divisor: float,
         accumulate: torch.dtype = torch.int32) -> torch.Tensor:
    """One rep on an (H, W) or (H, W, C) uint8 tensor."""
    k = len(taps)
    halo = k // 2
    h, w = x.shape[0], x.shape[1]
    padded = torch.nn.functional.pad(x.to(accumulate),
                                     _pad_spec(x.dim(), halo))
    acc = None
    for i in range(k):
        for j in range(k):
            t = taps[i][j]
            if t == 0:
                continue
            tap = int(t) if accumulate == torch.int32 else float(t)
            term = padded[i:i + h, j:j + w] * tap
            acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(x, dtype=accumulate)
    if accumulate == torch.int32 and _is_pow2(divisor):
        val = torch.div(acc, int(divisor), rounding_mode="floor")
        return val.clamp(0, 255).to(torch.uint8)
    val = acc.to(torch.float32) if accumulate == torch.int32 else acc
    val = val / float(divisor)
    if accumulate != torch.int32:
        val = torch.floor(val) if _is_pow2(divisor) else torch.trunc(val)
    return val.to(torch.float32).clamp(0.0, 255.0).to(torch.uint8)


def _pad_spec(ndim: int, halo: int):
    # F.pad lists the last dimension first: (H, W) pads W then H; an
    # (H, W, C) image pads nothing on C.
    if ndim == 2:
        return (halo, halo, halo, halo)
    return (0, 0, halo, halo, halo, halo)


def iterate(img: np.ndarray, taps, divisor: float, reps: int,
            device="cpu", accumulate: torch.dtype = torch.int32
            ) -> np.ndarray:
    """``reps`` reps of the stencil on a uint8 (H, W[, C]) array, run on
    ``device``; the result back on the host."""
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    for _ in range(reps):
        x = step(x, taps, divisor, accumulate)
    return x.cpu().numpy()
