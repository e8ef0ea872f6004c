"""Filter lowering: pick the fastest provably exact plan, and run it in torch ops.

The port's counterpart of the JAX package's ``ops/lowering.py``: the same
:class:`StencilPlan` and the same plan choice, in priority order:

1. ``sep_int`` + shift — the filter is an outer product of integer vectors
   (all binomial gaussians, box) and the effective divisor is a power of
   two: two 1-D int32 passes and a right shift.
2. ``sep_int`` + f32 divide — separable but non-dyadic divisor (box /9):
   the same two passes, one exact int->f32 convert (bound < 2^24) and one
   correctly rounded divide.
3. ``direct_int`` — integer taps but not separable (the reference's "edge"
   /28 kernel is rank 2): k*k int32 MACs, then shift or convert+divide.
4. ``direct_f32`` — arbitrary float taps: k*k f32 MACs.

The step functions here (:func:`valid_step`, :func:`padded_step`) are the
port's ``xla`` backend: int32 shifted-slice adds in plain torch ops, never
``F.conv2d`` (cuDNN would run float32 convolutions in TF32 by default).
They are also the referee every hand kernel is held against.

``StencilPlan.xla_pair_add`` is carried as an inert field so that a plan
from the JAX package converts field for field (:func:`plan_from_fields`);
nothing here reads it.

Exactness (vs the int64 golden model in
:func:`tpu_stencil_torch.ops.stencil.reference_stencil_numpy`): int32
accumulation never overflows (plans check 255 * sum|taps| bounds);
``acc >> shift`` equals truncating division for acc >= 0 and both clip
negatives to 0; the divide path needs acc < 2^24 so the convert is exact,
and one IEEE divide is correctly rounded.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_stencil_torch.filters import Filter

_EXACT_F32 = 2 ** 24
_I32_MAX = 2 ** 31


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """A static, hashable execution plan for one filter."""

    kind: str  # 'sep_int' | 'direct_int' | 'direct_f32'
    k: int
    taps: Tuple[Tuple[float, ...], ...]  # original taps (row-major)
    divisor: float                       # effective divisor for divide path
    row_taps: Optional[Tuple[int, ...]] = None  # sep_int: pass along rows axis
    col_taps: Optional[Tuple[int, ...]] = None  # sep_int: pass along cols axis
    shift: Optional[int] = None          # dyadic fast path: >> shift
    xla_pair_add: bool = False           # inert (see module docstring)

    @property
    def halo(self) -> int:
        return self.k // 2


def plan_from_fields(d: dict) -> StencilPlan:
    """The port's plan from plain field values — ``dataclasses.asdict()``
    of the JAX package's ``StencilPlan`` — with sequences made tuples so
    the plan stays hashable."""
    def tup(v):
        return None if v is None else tuple(v)

    return StencilPlan(
        kind=str(d["kind"]), k=int(d["k"]),
        taps=tuple(tuple(float(x) for x in row) for row in d["taps"]),
        divisor=float(d["divisor"]),
        row_taps=tup(d.get("row_taps")), col_taps=tup(d.get("col_taps")),
        shift=d.get("shift"), xla_pair_add=bool(d.get("xla_pair_add", False)),
    )


def _as_int_matrix(taps: np.ndarray) -> Optional[np.ndarray]:
    r = np.round(taps.astype(np.float64))
    if np.all(np.abs(taps - r) == 0):
        return r.astype(np.int64)
    return None


def _separate(ti: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray, Fraction]]:
    """Integer rank-1 decomposition: taps = outer(col, row) * factor, with
    integer ``col``/``row`` vectors and an exact Fraction ``factor``."""
    nz_rows = [i for i in range(ti.shape[0]) if np.any(ti[i])]
    if not nz_rows:
        return None
    r0 = ti[nz_rows[0]]
    j0 = int(np.argmax(np.abs(r0)))
    col = ti[:, j0]
    if not np.array_equal(ti * int(r0[j0]), np.outer(col, r0)):
        return None
    g = int(np.gcd.reduce(np.abs(col[col != 0]))) if np.any(col) else 1
    col_red = col // g
    factor = Fraction(int(r0[j0]), g)
    return col_red, r0, factor


def plan_filter(f: Filter) -> StencilPlan:
    """Compile a Filter to its fastest exact plan (see module docstring)."""
    taps = np.asarray(f.taps, dtype=np.float32)
    k = f.k
    taps_t = tuple(tuple(float(v) for v in row) for row in taps)
    ti = _as_int_matrix(taps)

    # Integer plans only where they provably reproduce the golden model:
    # f.is_exact gates on its exactness regime, the per-plan bounds guard
    # the int32 accumulation / f32 convert.
    if ti is not None and f.is_exact:
        sep = _separate(ti)
        if sep is not None:
            col_red, r0, factor = sep
            # taps/divisor == outer(col_red, r0) / (divisor * factor)
            eff = Fraction(f.divisor) * factor if factor != 0 else None
            if eff is not None and eff > 0:
                bound = 255 * int(np.abs(col_red).sum()) * int(np.abs(r0).sum())
                eff_int = eff.denominator == 1
                eff_pow2 = eff_int and (eff.numerator & (eff.numerator - 1)) == 0
                if f.is_dyadic and eff_pow2 and bound < _I32_MAX:
                    return StencilPlan(
                        kind="sep_int", k=k, taps=taps_t,
                        divisor=float(eff),
                        row_taps=tuple(int(v) for v in col_red),
                        col_taps=tuple(int(v) for v in r0),
                        shift=int(eff.numerator).bit_length() - 1,
                    )
                if eff_int and bound < _EXACT_F32:
                    return StencilPlan(
                        kind="sep_int", k=k, taps=taps_t,
                        divisor=float(eff),
                        row_taps=tuple(int(v) for v in col_red),
                        col_taps=tuple(int(v) for v in r0),
                        shift=None,
                    )
        bound = 255 * int(np.abs(ti).sum())
        if f.is_dyadic and bound < _I32_MAX:
            return StencilPlan(
                kind="direct_int", k=k, taps=taps_t, divisor=float(f.divisor),
                shift=int(f.divisor).bit_length() - 1,
            )
        if bound < _EXACT_F32:
            return StencilPlan(
                kind="direct_int", k=k, taps=taps_t, divisor=float(f.divisor)
            )

    return StencilPlan(kind="direct_f32", k=k, taps=taps_t, divisor=float(f.divisor))


# --------------------------------------------------------------------------
# Steps from plans. All operate on spatial dims (0, 1); a trailing channel
# dim rides along elementwise.
# --------------------------------------------------------------------------


def _sep_pass(x: torch.Tensor, taps: Tuple[int, ...], dim: int) -> torch.Tensor:
    """Valid 1-D integer correlation along ``dim`` (static taps, zeros
    skipped, 1-multiplies elided)."""
    n = x.shape[dim] - (len(taps) - 1)
    acc = None
    for i, t in enumerate(taps):
        if t == 0:
            continue
        term = x.narrow(dim, i, n)
        if t != 1:
            term = term * t
        acc = term if acc is None else acc + term
    if acc is None:
        shape = list(x.shape)
        shape[dim] = n
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return acc


def divide_f32(acc_f32: torch.Tensor, divisor: float) -> torch.Tensor:
    """``acc / divisor`` as one correctly rounded float32 divide per
    element. The divisor is a tensor on ``acc``'s own device: PyTorch's
    CUDA division by a host scalar multiplies by the reciprocal instead,
    which can round differently."""
    d = torch.tensor(divisor, dtype=torch.float32, device=acc_f32.device)
    return acc_f32 / d


def _finish_int(acc: torch.Tensor, plan: StencilPlan) -> torch.Tensor:
    if plan.shift is not None:
        return torch.clamp(acc >> plan.shift, 0, 255).to(torch.uint8)
    val = divide_f32(acc.to(torch.float32), plan.divisor)
    return torch.clamp(val, 0.0, 255.0).to(torch.uint8)


def valid_step(ext_u8: torch.Tensor, plan: StencilPlan) -> torch.Tensor:
    """One stencil application on a halo-extended uint8 tensor
    (H + 2*halo, W + 2*halo[, C]) -> (H, W[, C]): per-pixel shifted-add
    chains in static tap order over the input window."""
    if plan.kind == "sep_int":
        xi = ext_u8.to(torch.int32)
        a = _sep_pass(xi, plan.row_taps, 0)
        b = _sep_pass(a, plan.col_taps, 1)
        return _finish_int(b, plan)
    if plan.kind == "direct_int":
        xi = ext_u8.to(torch.int32)
        acc = None
        k = plan.k
        h = ext_u8.shape[0] - (k - 1)
        w = ext_u8.shape[1] - (k - 1)
        for i in range(k):
            for j in range(k):
                t = int(plan.taps[i][j])
                if t == 0:
                    continue
                window = xi[i : i + h, j : j + w]
                term = window if t == 1 else window * t
                acc = term if acc is None else acc + term
        if acc is None:
            acc = torch.zeros((h, w) + tuple(ext_u8.shape[2:]),
                              dtype=torch.int32, device=ext_u8.device)
        return _finish_int(acc, plan)
    if plan.kind == "direct_f32":
        from tpu_stencil_torch.ops.stencil import conv2d_valid, truncate_u8

        taps = torch.tensor(plan.taps, dtype=torch.float32)
        acc = conv2d_valid(ext_u8.to(torch.float32), taps)
        return truncate_u8(divide_f32(acc, plan.divisor))
    raise ValueError(f"unknown plan kind {plan.kind!r}")


def valid_window(ext: torch.Tensor, plan: StencilPlan,
                 r0: int, nr: int, c0: int, nc: int) -> torch.Tensor:
    """Strip-valid pass: the ``[r0, r0+nr) x [c0, c0+nc)`` window of
    ``valid_step(ext)``, computed by slicing the *input* window first
    (``nr + 2*halo`` rows, ``nc + 2*halo`` columns of ``ext``), so only
    the strip's own work is done.

    Equal byte for byte to slicing the whole ``valid_step(ext)``: every
    output pixel accumulates its taps in the same static order over the
    same input values however the surrounding array was windowed. The
    torch-ops overlap schedules (:mod:`tpu_stencil_torch.parallel.overlap`)
    build their border strips from it."""
    k = plan.k
    return valid_step(ext[r0:r0 + nr + (k - 1), c0:c0 + nc + (k - 1)], plan)


def force_f32_plan(plan: StencilPlan) -> StencilPlan:
    """Demote any plan to the generic f32 schedule (the 'reference' backend —
    the closest analog of the C program's pre-normalized float MACs)."""
    return StencilPlan(
        kind="direct_f32", k=plan.k, taps=plan.taps, divisor=plan.divisor
        if plan.kind != "sep_int" else _original_divisor(plan),
    )


def _original_divisor(plan: StencilPlan) -> float:
    # sep_int plans carry the effective divisor (original / factor); the f32
    # plan uses the original taps, so recover the original divisor from
    # outer/eff == taps/orig at any nonzero tap.
    taps = np.asarray(plan.taps, np.float64)
    outer = np.outer(plan.row_taps, plan.col_taps).astype(np.float64)
    nz = np.nonzero(outer)
    i, j = nz[0][0], nz[1][0]
    return float(plan.divisor * taps[i, j] / outer[i, j])


def sep_rows_pass(xi32: torch.Tensor, plan: StencilPlan) -> torch.Tensor:
    """sep_int phase 1: valid 1-D pass along rows (dim 0) of a
    dim-0-extended int32 tensor."""
    return _sep_pass(xi32, plan.row_taps, 0)


def sep_cols_pass(acc_i32: torch.Tensor, plan: StencilPlan) -> torch.Tensor:
    """sep_int phase 2: valid 1-D pass along cols (dim 1) of a
    dim-1-extended int32 intermediate, then the finishing shift/divide."""
    return _finish_int(_sep_pass(acc_i32, plan.col_taps, 1), plan)


def pad_dim(x: torch.Tensor, dim: int, h: int, boundary: str) -> torch.Tensor:
    """Extend ``x`` by ``h`` elements on both sides of ``dim``: zeros
    ('zero') or wraparound ('periodic', as ``np.pad(mode='wrap')``)."""
    if h == 0:
        return x
    if boundary == "zero":
        shape = list(x.shape)
        shape[dim] = h
        z = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return torch.cat([z, x, z], dim)
    if boundary == "periodic":
        n = x.shape[dim]
        idx = torch.arange(-h, n + h, device=x.device) % n
        return x.index_select(dim, idx)
    raise ValueError(f"unknown boundary {boundary!r}")


def iterate(img_u8: torch.Tensor, repetitions: int, plan: StencilPlan,
            boundary: str = "zero") -> torch.Tensor:
    """``repetitions`` torch-ops steps of an (H, W[, ...]) image (trailing
    dims ride along). Always a new tensor, the input is never written."""
    if not repetitions:
        return img_u8.clone()
    for _ in range(repetitions):
        img_u8 = padded_step(img_u8, plan, boundary)
    return img_u8


def iterate_frames(imgs_u8: torch.Tensor, repetitions: int,
                   plan: StencilPlan, boundary: str = "zero") -> torch.Tensor:
    """:func:`iterate` on N independent frames (N, H, W[, C]): the frame
    axis moves behind the spatial dims, so frames never mix."""
    rest = tuple(range(3, imgs_u8.dim()))
    x = imgs_u8.permute((1, 2, 0) + rest).contiguous()
    out = iterate(x, repetitions, plan, boundary)
    return out.permute((2, 0, 1) + rest).contiguous()


def padded_step(img_u8: torch.Tensor, plan: StencilPlan,
                boundary: str = "zero") -> torch.Tensor:
    """One stencil application with boundary padding (same shape out).

    ``boundary``: 'zero' (reference MPI semantics) or 'periodic'
    (wraparound). Separable plans pad per pass, in the pass's own dim,
    after the int32 convert — exact for periodic too, since the rows-pass
    output of a row-wrapped array is itself periodic along cols.
    """
    h = plan.halo
    if plan.kind == "sep_int":
        xi = img_u8.to(torch.int32)
        a = sep_rows_pass(pad_dim(xi, 0, h, boundary), plan)
        return sep_cols_pass(pad_dim(a, 1, h, boundary), plan)
    ext = pad_dim(pad_dim(img_u8, 0, h, boundary), 1, h, boundary)
    return valid_step(ext, plan)
