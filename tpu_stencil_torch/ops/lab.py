"""The lab kernels: wrappers, plain versions, variants and cases.

Two hand-written CUDA kernels serve the tuning and lab tools
(:mod:`tpu_stencil_torch.tools`), each the Hopper counterpart of a TPU
kernel of the JAX package's ``tools/``:

* **L2** :func:`stencil_lab` (``csrc/stencil_lab.cu``, replaces
  ``tools/kernel_lab.py``'s ``_lab_kernel``): K1's job with the body of one
  rep chosen when the library is built. A :class:`LabVariant` names a body
  (``current``: K1 before its tile was redesigned, the baseline; ``pair``,
  ``acc16``, ``swar`` on that tile; ``tile``: the shipped K1 tile in its
  ``swar`` body), ablation flags (wrong
  output, timing only) and a requested geometry; each (body, ablation) is
  one library, built with its ``-D`` defines through
  :mod:`tpu_stencil_torch.ops._build`. :func:`stencil_lab_band` is L2's
  ``band`` build (``LAB_BODY=5``): K2's job with the image held in the
  blocks' shared memory across the rep loop, the form of K2 that measured
  slower than the one that ships, kept to be timed against it.
* **L1** :func:`op_chain` (``csrc/op_chain.cu``, replaces
  ``tools/op_cost.py``'s ``make_case`` kernel): per tile, a chain of
  ``n_ops`` identical operations (:data:`CASES`) on an ``(in_block, wc)``
  uint8 tile, storing the first ``block`` rows.

Each wrapper takes its plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches its kernel or raises. ``stencil_lab.launches``
and ``op_chain.launches`` count the launches and nothing else. The plain
versions repeat each variant's own arithmetic (pair-add chains, an int16
intermediate, two rows per packed word) in torch ops.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
from math import comb
from typing import Dict, Optional, Tuple

import torch

from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.ops.cuda_stencil import acc16_ok, swar_ok
from tpu_stencil_torch.ops.lowering import StencilPlan

# ---------------------------------------------------------------------------
# L2: variants
# ---------------------------------------------------------------------------

# LAB_BODY = index. `tile` is the shipped K1 tile (its swar body), there
# to split the shipped kernel's time by ablation.
BODIES = ("current", "pair", "acc16", "swar", "tile")
ABLATIONS = ("no_rows", "no_cols", "no_mask", "load_store_only")
LAB_FILTER_SIZES = (3, 5, 7)


@dataclasses.dataclass(frozen=True)
class LabVariant:
    """One lab variant: a rep body, ablation flags and a requested
    geometry (None = K1's defaults)."""

    name: str
    body: str = "current"
    no_rows: bool = False
    no_cols: bool = False
    no_mask: bool = False
    load_store_only: bool = False
    block_h: Optional[int] = None
    fuse: Optional[int] = None

    @property
    def exact(self) -> bool:
        """Whether the variant computes K1's function (no ablation)."""
        return not (self.no_rows or self.no_cols or self.no_mask
                    or self.load_store_only)

    @property
    def defines(self) -> Tuple[str, ...]:
        """The ``-D`` defines of this variant's library (geometry is a
        launch argument, so variants that differ only in it share one)."""
        out = [f"LAB_BODY={BODIES.index(self.body)}"]
        for flag in ABLATIONS:
            if getattr(self, flag):
                out.append(f"LAB_{flag.upper()}=1")
        return tuple(out)


_GEOMETRY_SUFFIX = re.compile(r"_(b|f)(\d+)$")


def split_geometry(name: str) -> Tuple[str, Dict[str, int]]:
    """``name`` without its ``_bN``/``_fN`` suffixes (either order), and
    {'b': N, 'f': N} of those given. Raises ValueError on a repeat."""
    rest, geo = name, {}
    while True:
        m = _GEOMETRY_SUFFIX.search(rest)
        if not m:
            return rest, geo
        if m.group(1) in geo:
            raise ValueError(f"unknown lab variant {name!r}")
        geo[m.group(1)] = int(m.group(2))
        rest = rest[:m.start()]


def parse_variant(name: str) -> LabVariant:
    """The variant a lab name means: ``[abl_]BODY[_ABLATION][_bN][_fN]``,
    e.g. ``swar``, ``pair_b64``, ``current_f16_b64``, ``abl_no_rows``
    (on ``current``), ``abl_swar_no_mask``. Raises ValueError for any
    other name."""
    rest, geo = split_geometry(name)
    flags = {}
    body = rest
    if rest.startswith("abl_"):
        body, abl = "current", rest[4:]
        for b in BODIES:
            if abl.startswith(b + "_"):
                body, abl = b, abl[len(b) + 1:]
        if abl not in ABLATIONS:
            raise ValueError(f"unknown lab variant {name!r}")
        flags[abl] = True
    if body not in BODIES:
        raise ValueError(f"unknown lab variant {name!r}")
    return LabVariant(name=name, body=body, block_h=geo.get("b"),
                      fuse=geo.get("f"), **flags)


def binomial_chain(taps) -> Optional[int]:
    """k - 1 when ``taps`` are the binomial row of size k, else None."""
    k = len(taps)
    if tuple(taps) == tuple(comb(k - 1, i) for i in range(k)):
        return k - 1
    return None


def variant_supported(variant: LabVariant, plan: StencilPlan) -> bool:
    """Whether ``variant``'s body runs ``plan``."""
    if plan.kind != "sep_int" or plan.k not in LAB_FILTER_SIZES:
        return False
    if variant.body == "pair":
        return (plan.shift is not None
                and binomial_chain(plan.row_taps) is not None
                and binomial_chain(plan.col_taps) is not None)
    if variant.body == "acc16":
        return acc16_ok(plan)
    if variant.body in ("swar", "tile"):
        return swar_ok(plan)
    return True


def _check_variant(variant: LabVariant, plan: StencilPlan) -> None:
    if not variant_supported(variant, plan):
        raise ValueError(
            f"lab variant {variant.name!r} (body {variant.body}) does not "
            f"run this plan (kind={plan.kind} k={plan.k} shift={plan.shift} "
            f"row_taps={plan.row_taps} col_taps={plan.col_taps})"
        )


def lab_smem_bytes(variant: LabVariant, plan: StencilPlan, block_h: int,
                   fuse: int, channels: int, tile_w: int = cs.TILE_W) -> int:
    """Shared memory of one tile of ``variant`` (``lab_tile_smem`` in
    csrc/stencil_lab.cu): 5 bytes per element for ``current`` and
    ``pair``, 3 for ``acc16``, and for ``swar`` and ``tile`` two 32-bit
    words per row pair plus one pad pair at each end of the carry."""
    g = fuse * plan.halo
    rr = block_h + 2 * g
    ll = tile_w + 2 * g * channels
    if variant.body in ("swar", "tile"):
        return ((rr // 2 + 2) + rr // 2) * ll * 4
    return rr * ll * (3 if variant.body == "acc16" else 5)


def lab_geometry(variant: LabVariant, plan: StencilPlan, n_rows: int,
                 channels: int) -> Tuple[int, int]:
    """The (block_h, fuse) ``variant`` launches with: K1's effective
    geometry at the variant's requested one, clamped as the ``int32`` body
    (the largest tile), so that variants at one request run the same tiles
    and every body's tile fits."""
    return cs.effective_geometry(plan, n_rows, channels, variant.block_h,
                                 variant.fuse, body="int32")


# ---------------------------------------------------------------------------
# L2: plain versions
# ---------------------------------------------------------------------------


def _scalar_rep(cur: torch.Tensor, plan: StencilPlan, channels: int,
                variant: LabVariant) -> torch.Tensor:
    """One rep of a scalar body on a (rows + 2h, wc + 2hC) zero-extended
    uint8 tile -> the (rows, wc) int32 value after the finish."""
    h, k = plan.halo, plan.k
    hc = h * channels
    rows = cur.shape[0] - 2 * h
    wc = cur.shape[1] - 2 * hc
    acc_t = torch.int16 if variant.body == "acc16" else torch.int32
    x = cur.to(acc_t)
    if variant.no_rows:
        a = x[h:h + rows]
    elif variant.body == "pair":
        a = x
        for _ in range(k - 1):
            a = a[:-1] + a[1:]
    else:
        a = _lowering._sep_pass(x, plan.row_taps, 0)
    a = a.to(torch.int32)
    if variant.no_cols:
        b = a[:, hc:hc + wc]
    elif variant.body == "pair":
        b = a
        for _ in range(k - 1):
            b = b[:, :-channels] + b[:, channels:]
    else:
        b = None
        for j, t in enumerate(plan.col_taps):
            term = a[:, j * channels:j * channels + wc] * t
            b = term if b is None else b + term
    return _lowering._finish_int(b, plan).to(torch.int32)


def _swar_rep(p64: torch.Tensor, plan: StencilPlan, channels: int,
              mask, no_rows: bool = False,
              no_cols: bool = False, fill: int = 0) -> torch.Tensor:
    """One rep of the ``swar`` body on packed words: ``p64`` (..., Q, wc)
    int64 holding 32-bit words of two 16-bit fields, rows 2q (low) and 2q+1
    (high). Pairs of ``fill`` stand above and below, lanes of ``fill`` left
    and right (zero: the image's boundary). ``mask`` ((..., Q, wc) or a
    scalar) holds 0x00FF per kept field: K1's rows of the image and of its
    frames, K3's rows and lanes inside the global extent
    (:func:`swar_mask`)."""
    h = plan.halo
    hc = h * channels
    q, wc = p64.shape[-2:]
    lead = p64.shape[:-2]
    hp = (h + 1) // 2
    word = 0xFFFFFFFF
    zrow = torch.full(lead + (hp, wc), fill, dtype=torch.int64,
                      device=p64.device)
    pp = torch.cat([zrow, p64, zrow], -2)  # pair j of p64 at pp[j + hp]
    # Straddle j: (row 2j+1, row 2j+2) = high field of pair j under the low
    # field of pair j+1.
    ss = (pp[..., :-1, :] >> 16) | ((pp[..., 1:, :] & 0xFFFF) << 16)
    if no_rows:
        t = p64
    else:
        t = torch.zeros_like(p64)
        for i, tap in enumerate(plan.row_taps):
            r = i - h  # W[2q + r], floor-divided into the windows
            j = hp + (r // 2)
            src = pp if r % 2 == 0 else ss
            t = (t + tap * src[..., j:j + q, :]) & word
    if no_cols:
        acc = t
    else:
        zl = torch.full(lead + (q, hc), fill, dtype=torch.int64,
                        device=p64.device)
        tt = torch.cat([zl, t, zl], -1)
        acc = torch.zeros_like(t)
        for j, tap in enumerate(plan.col_taps):
            acc = (acc + tap * tt[..., j * channels:j * channels + wc]) & word
    return (acc >> plan.shift) & mask


def _regs_direct_rep(p64: torch.Tensor, plan: StencilPlan, channels: int,
                     mask, fill: int = 0) -> torch.Tensor:
    """One rep of the ``regs_direct`` body on packed words ``p64`` (..., Q,
    wc), as :func:`_swar_rep` for ``swar``: a pair of ``fill`` above and
    below and ``channels`` lanes of ``fill`` left and right; for pair row q
    the vertical words W(2q-1), W(2q), W(2q+1) (straddle, pair, straddle),
    ``y_j = sum_i taps[i][j] * W(2q-1+i)`` on whole words, ``y_0[v-C] +
    y_1[v] + y_2[v+C]``, then the plan's finish per 16-bit field
    (``(field * M) >> S`` with :func:`cuda_stencil.direct_divide`'s (M,
    S), else the float32 divide) and ``mask``."""
    c = channels
    q, wc = p64.shape[-2:]
    lead = p64.shape[:-2]
    word = 0xFFFFFFFF
    kw = dict(dtype=torch.int64, device=p64.device)
    x = torch.cat([torch.full(lead + (q, c), fill, **kw), p64,
                   torch.full(lead + (q, c), fill, **kw)], -1)
    pad = torch.full(lead + (1, wc + 2 * c), fill, **kw)
    pp = torch.cat([pad, x, pad], -2)  # pair j of p64 at pp[j + 1]
    # ss[j] = W(2j - 1): the high field of pp[j] under the low of pp[j + 1]
    ss = (pp[..., :-1, :] >> 16) | ((pp[..., 1:, :] & 0xFFFF) << 16)
    w = (ss[..., :q, :], pp[..., 1:q + 1, :], ss[..., 1:q + 1, :])
    taps = [[int(t) for t in row] for row in plan.taps]
    y = [(taps[0][j] * w[0] + taps[1][j] * w[1] + taps[2][j] * w[2]) & word
         for j in range(3)]
    acc = (y[0][..., :wc] + y[1][..., c:c + wc] + y[2][..., 2 * c:]) & word
    lo, hi = acc & 0xFFFF, acc >> 16
    divide = cs.direct_divide(plan)
    if divide is not None:
        mul, shift = divide
        lo, hi = (lo * mul) >> shift, (hi * mul) >> shift
    else:
        lo, hi = (torch.clamp(torch.trunc(_lowering.divide_f32(
            f.to(torch.float32), plan.divisor)), 0, 255).to(torch.int64)
            for f in (lo, hi))
    return (lo | (hi << 16)) & mask


def pack_pairs(x2: torch.Tensor) -> torch.Tensor:
    """(rows, wc) bytes -> (ceil(rows / 2), wc) int64 words of the row
    pairs (2q low, 2q+1 high); an odd row count gains one zero row."""
    x = x2.to(torch.int64)
    if x.shape[0] % 2:
        x = torch.cat([x, torch.zeros_like(x[:1])], 0)
    return x[0::2] | (x[1::2] << 16)


def unpack_pairs(p64: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` byte rows of packed words (the low byte of each
    field)."""
    out = torch.stack([p64 & 0xFF, (p64 >> 16) & 0xFF], 1)
    return out.reshape(-1, p64.shape[1])[:rows].to(torch.uint8)


def swar_mask(row_keep: torch.Tensor, lane_keep: torch.Tensor
              ) -> torch.Tensor:
    """The (ceil(rows / 2), wc) re-zero mask of the packed words: 0x00FF
    in each field whose row and lane are kept."""
    kk = row_keep.to(torch.int64) * 0xFF
    if kk.shape[0] % 2:
        kk = torch.cat([kk, torch.zeros_like(kk[:1])], 0)
    rows = kk[0::2] | (kk[1::2] << 16)
    return rows.reshape(-1, 1) * lane_keep.to(torch.int64).reshape(1, -1)


def swar_fused_plain(x2: torch.Tensor, plan: StencilPlan, channels: int,
                     reps: int, rows_real: Optional[int] = None,
                     frame=None) -> torch.Tensor:
    """K1's function computed as the ``swar`` body computes it: rows packed
    in pairs, ``reps`` reps of :func:`_swar_rep` with the re-zero of rows
    outside the image and of the frames layout's gap rows, unpacked. Equals
    :func:`cuda_stencil.stencil_fused_plain` wherever
    :func:`cuda_stencil.swar_ok` holds."""
    if not swar_ok(plan):
        raise ValueError("the swar body does not run this plan")
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    keep = cs._row_keep(rows, rows_real, frame, x2.device)
    mask = swar_mask(keep, torch.ones(wc, dtype=torch.bool, device=x2.device))
    p64 = pack_pairs(torch.where(keep.reshape(-1, 1), x2, 0))
    for _ in range(reps):
        p64 = _swar_rep(p64, plan, channels, mask)
    return unpack_pairs(p64, rows)


def regs_fused_plain(x2: torch.Tensor, plan: StencilPlan, channels: int,
                     fuse: int, rows_real: Optional[int] = None,
                     frame=None) -> torch.Tensor:
    """One K1 launch of ``fuse`` reps computed as the register body
    :func:`cuda_stencil.fused_body` names (``regs``, ``regs_direct``)
    computes it: the image cut into :func:`cuda_stencil.regs_geometry`'s
    tiles, each block's register extent (``warps * 2 * regs_q(plan)`` rows
    by ``32 * REGS_V`` lanes from ``fuse * halo`` rows above and the
    rounded left ghost band left of its tile) loaded with the image's rows
    and lanes (zero outside it, and on rows outside ``rows_real`` or in a
    frame's gap) and packed in pairs, ``fuse`` reps of :func:`_swar_rep`
    (``regs``) or :func:`_regs_direct_rep` (``regs_direct``) that read 255
    in every field past the extent (the kernel reads wrong values there,
    which only the ghost bands may absorb; zeros would pass for the
    image's boundary) with the re-zero mask, then only each tile unpacked
    and stored. Equals :func:`cuda_stencil.stencil_fused_plain` wherever
    the body runs."""
    geo = cs.regs_geometry(plan, channels, fuse)
    body = cs.fused_body(plan)
    if (body not in cs.REGS_BODIES or channels not in cs.REGS_CHANNELS
            or geo is None):
        raise ValueError("the regs bodies do not run this launch")
    step = _swar_rep if body == cs.REGS else _regs_direct_rep
    tile_h, tile_w, warps = geo
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    dev = x2.device
    gr = fuse * plan.halo
    left = cs.regs_left(plan, channels, fuse)
    ext_h, ext_w = warps * 2 * cs.regs_q(plan), 32 * cs.REGS_V
    gy, gx = -(-rows // tile_h), -(-wc // tile_w)
    pad_h, pad_w = (gy - 1) * tile_h + ext_h, (gx - 1) * tile_w + ext_w
    keep = cs._row_keep(rows, rows_real, frame, dev)
    img = torch.zeros((pad_h, pad_w), dtype=torch.int64, device=dev)
    img[gr:gr + rows, left:left + wc] = torch.where(
        keep.reshape(-1, 1), x2, 0).to(torch.int64)
    row_keep = torch.zeros(pad_h, dtype=torch.bool, device=dev)
    row_keep[gr:gr + rows] = keep
    lane_keep = torch.zeros(pad_w, dtype=torch.bool, device=dev)
    lane_keep[left:left + wc] = True
    # (gy, gx, ext_h, ext_w): block (i, j)'s extent.
    ext = img.unfold(0, ext_h, tile_h).unfold(1, ext_w, tile_w)
    p64 = ext[..., 0::2, :] | (ext[..., 1::2, :] << 16)
    rk = row_keep.unfold(0, ext_h, tile_h).to(torch.int64) * 0xFF
    rk = (rk[:, 0::2] | (rk[:, 1::2] << 16)).reshape(gy, 1, -1, 1)
    lk = lane_keep.unfold(0, ext_w, tile_w).to(torch.int64)
    mask = rk * lk.reshape(1, gx, 1, ext_w)
    for _ in range(fuse):
        p64 = step(p64, plan, channels, mask, fill=0x00FF00FF)
    out = torch.stack([p64 & 0xFF, (p64 >> 16) & 0xFF], -2)
    out = out.reshape(gy, gx, ext_h, ext_w)
    out = out[:, :, gr:gr + tile_h, left:left + tile_w]
    out = out.permute(0, 2, 1, 3).reshape(gy * tile_h, gx * tile_w)
    return out[:rows, :wc].to(torch.uint8).contiguous()


def swar_valid_plain(ext2: torch.Tensor, plan: StencilPlan, channels: int,
                     fuse: int, row0: int, col0: int,
                     global_shape: Tuple[int, int]) -> torch.Tensor:
    """K3's function computed as the ``swar`` body computes it: the
    ghost-extended tile packed in row pairs, ``fuse`` reps of
    :func:`_swar_rep` re-zeroing the rows and lanes outside the global
    padded extent, the interior unpacked. Equals
    :func:`cuda_stencil.stencil_valid_plain` wherever
    :func:`cuda_stencil.swar_ok` holds."""
    if not swar_ok(plan):
        raise ValueError("the swar body does not run this plan")
    g = fuse * plan.halo
    gc = g * channels
    rows_ext, wc_ext = ext2.shape
    rows_glob, cols_glob_c = global_shape
    rid = torch.arange(rows_ext, device=ext2.device) + (row0 - g)
    cid = torch.arange(wc_ext, device=ext2.device) + (col0 - gc)
    mask = swar_mask((rid >= 0) & (rid < rows_glob),
                     (cid >= 0) & (cid < cols_glob_c))
    p64 = pack_pairs(ext2)
    for _ in range(fuse):
        p64 = _swar_rep(p64, plan, channels, mask)
    out = unpack_pairs(p64, rows_ext)
    return out[g:rows_ext - g, gc:wc_ext - gc].contiguous()


def stencil_lab_plain(x2: torch.Tensor, plan: StencilPlan, channels: int,
                      reps: int, variant: LabVariant,
                      rows_real: Optional[int] = None,
                      frame=None) -> torch.Tensor:
    """``variant``'s function in torch ops with the variant's own
    arithmetic: ``reps`` reps of the flat (rows, W*C) uint8 image. Exact
    variants equal :func:`cuda_stencil.stencil_fused_plain`; an ablation
    drops what its flags say (``no_mask``: the image stands in a zero band
    ``reps * halo`` wide that is never re-zeroed, as in the kernel's
    tile)."""
    _check_variant(variant, plan)
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    if variant.load_store_only:
        return x2.clone()
    if variant.body == "current" and variant.exact:
        return cs.stencil_fused_plain(x2, plan, channels, reps, rows_real,
                                      frame)
    if variant.body in ("swar", "tile") and variant.exact:
        return swar_fused_plain(x2, plan, channels, reps, rows_real, frame)
    h = plan.halo
    hc = h * channels
    dev = x2.device
    keep = cs._row_keep(rows, rows_real, frame, dev).reshape(rows, 1)
    # no_mask: carry the whole g-wide ghost band and never re-zero it.
    g = reps * h if variant.no_mask else 0
    gc = g * channels

    def extend(t, nr, nl):
        t = _lowering.pad_dim(t, 0, nr, "zero")
        return _lowering.pad_dim(t, 1, nl, "zero")

    if variant.body not in ("swar", "tile"):
        cur = extend(torch.where(keep, x2, 0) if not variant.no_mask else x2,
                     g, gc)
        for _ in range(reps):
            val = _scalar_rep(extend(cur, h, hc), plan, channels, variant)
            if variant.no_mask:
                cur = val.to(torch.uint8)
            else:
                cur = torch.where(keep, val, 0).to(torch.uint8)
        return cur[g:g + rows, gc:gc + wc].contiguous()

    # swar ablations: pack row pairs (an odd row count gains one zero row).
    x = extend(x2 if variant.no_mask else torch.where(keep, x2, 0), g, gc)
    total = x.shape[0]
    p64 = pack_pairs(x)
    mask = 0x00FF00FF if variant.no_mask else swar_mask(
        keep.reshape(-1), torch.ones(wc, dtype=torch.bool, device=dev))
    for _ in range(reps):
        p64 = _swar_rep(p64, plan, channels, mask, variant.no_rows,
                        variant.no_cols)
    return unpack_pairs(p64, total)[g:g + rows, gc:gc + wc].contiguous()


# ---------------------------------------------------------------------------
# L2: wrapper
# ---------------------------------------------------------------------------


def _lab_lib(variant: LabVariant) -> ctypes.CDLL:
    lib = _build.load("stencil_lab", variant.defines)
    p = ctypes.c_void_p
    lib.stencil_lab_launch.argtypes = [p, p, p, p, ctypes.c_int, p]
    lib.stencil_lab_launch.restype = ctypes.c_int
    lib.stencil_lab_smem.argtypes = [p, p, ctypes.c_int]
    lib.stencil_lab_smem.restype = ctypes.c_longlong
    lib.stencil_lab_error_string.argtypes = [ctypes.c_int]
    lib.stencil_lab_error_string.restype = ctypes.c_char_p
    return lib


def lab_targets(variants) -> Tuple[tuple, ...]:
    """The distinct build targets of ``variants`` (for ``_build.build``)."""
    seen = []
    for v in variants:
        t = ("stencil_lab", v.defines)
        if t not in seen:
            seen.append(t)
    return tuple(seen)


def kernel_smem_bytes(variant: LabVariant, plan: StencilPlan, block_h: int,
                      fuse: int, channels: int) -> int:
    """What the built library itself says a tile takes (needs the card's
    toolchain; :func:`lab_smem_bytes` is the host model of it)."""
    lib = _lab_lib(variant)
    params = cs._params(plan)
    geom = cs._Geometry(block_h, cs.TILE_W, block_h, channels, 0, 0, block_h,
                        cs.TILE_W)
    return int(lib.stencil_lab_smem(ctypes.addressof(params),
                                    ctypes.addressof(geom), fuse))


def stencil_lab(x2: torch.Tensor, plan: StencilPlan, channels: int,
                fuse: int, variant: LabVariant,
                rows_real: Optional[int] = None, frame=None,
                block_h: int = cs.DEFAULT_BLOCK_H,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2: ``fuse`` reps of the flat (rows, W*C) uint8 image ``x2`` by
    ``variant``'s body into ``out`` (allocated when None; must not alias
    ``x2``), K1's arguments otherwise. CPU tensors run
    :func:`stencil_lab_plain`."""
    cs._check_input(x2)
    _check_variant(variant, plan)
    rows_real = x2.shape[0] if rows_real is None else rows_real
    if x2.device.type == "cpu":
        res = stencil_lab_plain(x2, plan, channels, fuse, variant, rows_real,
                                frame)
        return res if out is None else out.copy_(res)
    lib = _lab_lib(variant)
    out = torch.empty_like(x2) if out is None else out
    cs._check_cuda(x2, out)
    cs._check_input(out)
    if out.data_ptr() == x2.data_ptr() or out.shape != x2.shape:
        raise ValueError("out must be a distinct buffer of x2's shape")
    if lab_smem_bytes(variant, plan, block_h, fuse, channels) > cs.SMEM_LIMIT:
        raise ValueError(
            f"lab variant {variant.name!r}: a {block_h}-row tile at fuse "
            f"{fuse} does not fit shared memory"
        )
    params = cs._params(plan)
    geom = cs._geometry(x2, channels, rows_real, frame, block_h)
    with torch.cuda.device(x2.device):
        rc = lib.stencil_lab_launch(
            x2.data_ptr(), out.data_ptr(), ctypes.addressof(params),
            ctypes.addressof(geom), fuse,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    cs._raise_on(rc, lib, "stencil_lab_error_string",
                 f"stencil_lab[{variant.name}]")
    stencil_lab.launches += 1
    return out


stencil_lab.launches = 0


def lab_iterate(img_u8: torch.Tensor, repetitions: int, plan: StencilPlan,
                variant: LabVariant) -> torch.Tensor:
    """``repetitions`` reps of an (H, W[, C]) uint8 image through L2, driven
    as K1's ``iterate`` drives K1: ``reps // fuse`` fused launches, then
    single-rep launches, over two ping-pong buffers."""
    shape = img_u8.shape
    hh = shape[0]
    channels = shape[2] if img_u8.dim() == 3 else 1
    x2 = img_u8.contiguous().reshape(hh, -1)
    if repetitions == 0:
        return img_u8.clone()
    bh, fz = lab_geometry(variant, plan, hh, channels)
    depths = cs.launch_schedule(repetitions, fz)
    bufs = [torch.empty_like(x2) for _ in range(min(2, len(depths)))]
    cur = x2
    for i, depth in enumerate(depths):
        cur = stencil_lab(cur, plan, channels, depth, variant, hh,
                          block_h=bh, out=bufs[i % 2])
    return cur.reshape(shape)


# ---------------------------------------------------------------------------
# L2: the band variant (K2 with the image in shared memory)
# ---------------------------------------------------------------------------

LAB_BAND = 5  # its LAB_BODY in csrc/stencil_lab.cu
BAND_TARGET = ("stencil_lab", (f"LAB_BODY={LAB_BAND}",))
# Reps per grid sync: the fastest of 1, 2, 4 and 8 on the card at
# 1920x2520 RGB gaussian x40 (PERF.md; `band_fN` in the kernel lab).
BAND_FUSE = 8
# The narrowest working tile a band is split into (lanes).
BAND_MIN_TILE_W = 64


@dataclasses.dataclass(frozen=True)
class BandGeometry:
    """One band launch: ``band_h`` rows per band (one band per block, one
    block per SM), working tiles of ``tile_w`` lanes, ``fuse`` reps per
    grid sync, shared memory per block, and the bytes of the edge buffer
    (every band's first and last ``fuse*halo`` rows at both sync
    parities)."""

    band_h: int
    tile_w: int
    fuse: int
    smem: int
    edge_bytes: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def band_smem_bytes(plan: StencilPlan, band_h: int, tile_w: int, fuse: int,
                    channels: int, wc: int) -> int:
    """Shared memory of one band block (``lab_band_smem``): the working
    tile in the plan's body (:func:`cuda_stencil.tile_smem_bytes`,
    rounded to 16 bytes), the band (``band_h`` rows of ``wc`` lanes
    rounded to 16) and the held-back lanes (``band_h`` x
    ``fuse*halo*C``, rounded to 16)."""
    tile = cs.tile_smem_bytes(plan, band_h, fuse, channels, tile_w)
    held = band_h * fuse * plan.halo * channels
    return _round16(tile) + band_h * _round16(wc) + _round16(held)


def band_geometry(plan: StencilPlan, n_rows: int, wc: int, channels: int,
                  sms: int = cs.H100_SMS,
                  fuse: int = BAND_FUSE) -> Optional[BandGeometry]:
    """The band launch for an n_rows x wc image over at most ``sms``
    blocks: bands of an even number of rows, at least the ``fuse*halo``
    edge rows a neighbour reads; the widest working tile (lanes split
    evenly, 16-lane aligned) whose block fits :data:`cuda_stencil.
    SMEM_LIMIT`. None where a split tile would be narrower than
    :data:`BAND_MIN_TILE_W` or than the ``fuse*halo*C`` lanes it holds
    back."""
    e = fuse * plan.halo
    bh = max(2, 2 * -(-n_rows // (2 * sms)), e + e % 2)
    n = 1
    while True:
        tw = _round16(-(-wc // n))
        if n > 1 and tw < max(BAND_MIN_TILE_W, e * channels):
            return None
        smem = band_smem_bytes(plan, bh, tw, fuse, channels, wc)
        if smem <= cs.SMEM_LIMIT:
            return BandGeometry(bh, tw, fuse, smem,
                                4 * e * wc * -(-n_rows // bh))
        n += 1


def _band_lib() -> ctypes.CDLL:
    lib = _build.load(*BAND_TARGET)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stencil_lab_band_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.stencil_lab_band_launch.restype = i
    lib.stencil_lab_band_smem.argtypes = [p, p, i, i]
    lib.stencil_lab_band_smem.restype = ctypes.c_longlong
    lib.stencil_lab_band_shape.argtypes = [p, p, i, i, p]
    lib.stencil_lab_band_shape.restype = i
    lib.stencil_lab_error_string.argtypes = [i]
    lib.stencil_lab_error_string.restype = ctypes.c_char_p
    return lib


def _band_args(plan: StencilPlan, rows: int, wc: int, channels: int,
               rows_real: int, frame, sms: int, fuse: int = BAND_FUSE):
    geo = band_geometry(plan, rows, wc, channels, sms, fuse)
    if geo is None:
        raise ValueError(f"the band variant does not fit a {rows}x{wc} "
                         "image")
    stride, frame_h = frame if frame is not None else (0, 0)
    return geo, cs._params(plan), cs._Geometry(
        rows, wc, rows_real, channels, stride, frame_h, geo.band_h,
        geo.tile_w)


def band_kernel_smem_bytes(plan: StencilPlan, rows: int, wc: int,
                           channels: int) -> int:
    """What the built band library says its launch asks for
    (:func:`band_smem_bytes` is the host model of it)."""
    geo, params, geom = _band_args(plan, rows, wc, channels, rows, None,
                                   cs.H100_SMS)
    return int(_band_lib().stencil_lab_band_smem(
        ctypes.addressof(params), ctypes.addressof(geom), geo.fuse,
        cs.BODIES.index(cs.tile_body(plan))))


def band_launch_shape(plan: StencilPlan, rows: int, wc: int, channels: int,
                      device: torch.device) -> Dict[str, int]:
    """The band launch on ``device``: band rows, tile lanes, reps per sync,
    resident blocks per SM, grid and threads per block (the library's)."""
    geo, params, geom = _band_args(plan, rows, wc, channels, rows, None,
                                   cs.device_caps(device)[1])
    out = (ctypes.c_int * 3)()
    lib = _band_lib()
    with torch.cuda.device(device):
        rc = lib.stencil_lab_band_shape(
            ctypes.addressof(params), ctypes.addressof(geom), geo.fuse,
            cs.BODIES.index(cs.tile_body(plan)), ctypes.addressof(out))
    cs._raise_on(rc, lib, "stencil_lab_error_string", "stencil_lab[band]")
    return {"band_h": geo.band_h, "tile_w": geo.tile_w, "fuse": geo.fuse,
            "smem_bytes": geo.smem, "blocks_per_sm": out[0],
            "grid": out[1], "threads": out[2]}


def stencil_lab_band(x2: torch.Tensor, plan: StencilPlan, channels: int,
                     reps: int, rows_real: Optional[int] = None,
                     frame=None, fuse: int = BAND_FUSE) -> torch.Tensor:
    """L2's ``band`` variant: all ``reps`` (>= 1) of the flat (rows, W*C)
    uint8 image in one cooperative launch with the image held in shared
    memory, ``fuse`` reps per grid sync (:func:`band_geometry`), K2's
    arguments otherwise. CPU tensors run
    :func:`cuda_stencil.stencil_fused_plain` (K2's function)."""
    cs._check_input(x2)
    if reps < 1:
        raise ValueError(f"the band variant runs >= 1 rep, got {reps}")
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    if x2.device.type == "cpu":
        return cs.stencil_fused_plain(x2, plan, channels, reps, rows_real,
                                      frame)
    lib = _band_lib()
    cs._check_cuda(x2)
    geo, params, geom = _band_args(plan, rows, wc, channels, rows_real, frame,
                                   cs.device_caps(x2.device)[1], fuse)
    out = torch.empty_like(x2)
    edges = torch.empty(max(1, geo.edge_bytes), dtype=torch.uint8,
                        device=x2.device)
    with torch.cuda.device(x2.device):
        rc = lib.stencil_lab_band_launch(
            x2.data_ptr(), out.data_ptr(), edges.data_ptr(),
            ctypes.addressof(params), ctypes.addressof(geom), reps, geo.fuse,
            cs.BODIES.index(cs.tile_body(plan)),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    cs._raise_on(rc, lib, "stencil_lab_error_string", "stencil_lab[band]")
    stencil_lab.launches += 1
    return out


def band_iterate(img_u8: torch.Tensor, repetitions: int, plan: StencilPlan,
                 fuse: int = BAND_FUSE) -> torch.Tensor:
    """``repetitions`` reps of an (H, W[, C]) uint8 image through the band
    variant, ``fuse`` reps per grid sync (one launch; none for 0 reps)."""
    if repetitions == 0:
        return img_u8.clone()
    channels = img_u8.shape[2] if img_u8.dim() == 3 else 1
    x2 = img_u8.contiguous().reshape(img_u8.shape[0], -1)
    return stencil_lab_band(x2, plan, channels, repetitions,
                            fuse=fuse).reshape(img_u8.shape)


# ---------------------------------------------------------------------------
# L1: cases
# ---------------------------------------------------------------------------

BAND = 144  # rows and columns of the mxu_rows_* band matrix
N_OPS = (8, 16)  # the chains the tool times: (t(16) - t(8)) / 8
# The chain the tool only checks. Eight doublings or shifts of a byte leave
# nothing in the uint8 that is stored, so at N_OPS the doubling, shifting
# and multiply-add cases store a constant whatever the kernel did; after
# three operations every case's output still depends on its input.
CHECK_N_OPS = 3
BUILT_N_OPS = (CHECK_N_OPS,) + N_OPS  # chain lengths the library holds

# name -> (case id in csrc/op_chain.cu, working dtype). The first 24 compute
# the JAX tool's cases of the same names; the last four are this card's own.
CASES: Dict[str, Tuple[int, torch.dtype]] = {
    name: (i, dt) for i, (name, dt) in enumerate((
        ("mxu_rows_bf16", torch.int32), ("mxu_rows_i8", torch.int32),
        ("strip_add_i32", torch.int32), ("subroll1_add_i32", torch.int32),
        ("subroll1_add_u8", torch.uint8), ("cvt_u8_i32_rt", torch.uint8),
        ("add_u8", torch.uint8), ("add_i32", torch.int32),
        ("add_i16", torch.int16), ("mis_slice_add_i32", torch.int32),
        ("mis_slice_add_i16", torch.int16),
        ("al_slice_add_i16", torch.int16), ("roll3_i32", torch.int32),
        ("roll3_add_i32", torch.int32), ("roll1_add_i32", torch.int32),
        ("roll128_add_i32", torch.int32), ("add_f32", torch.float32),
        ("mul_add_f32", torch.float32), ("mul_add_i32", torch.int32),
        ("shift_i32", torch.int32), ("where_i32", torch.int32),
        ("cvt_i16_i32_rt", torch.int16), ("mul_i32", torch.int32),
        ("clip_i32", torch.int32), ("vadd4_u8", torch.uint8),
        ("vadd2_i16", torch.int16), ("shfl1_add_i32", torch.int32),
        ("shfl3_add_i32", torch.int32),
    ))
}

# Rows a case's chain consumes per operation (the shrinking adds).
ROW_SHRINK = {"mis_slice_add_i32": 1, "mis_slice_add_i16": 1,
              "al_slice_add_i16": 8}


def band_matrix() -> torch.Tensor:
    """The constant banded rows-pass matrix of the mxu_rows_* cases:
    (BAND, BAND) float32 with 1, 2, 1 on the three central diagonals."""
    a = torch.zeros((BAND, BAND), dtype=torch.float32)
    for d, t in ((-1, 1.0), (0, 2.0), (1, 1.0)):
        a += torch.diag(torch.full((BAND - abs(d),), t), d)
    return a


# The launch forms of csrc/op_chain.cu (OpForm), and its constants.
OP_FORMS = ("flat", "cols", "strips", "lanes", "shrink_smem", "roll_smem",
            "band")
OP_FLAT_THREADS = 128     # threads of a flat-form block
OP_COL_THREADS = 64       # threads (lanes) of a column- or strip-form block
OP_SMEM_THREADS = 512     # most threads of a shared-memory form block
OP_LANES_MAX = 1024       # widest row a lane-roll block holds
OP_REG_BLOCK = 32         # stored rows of the register shrink form
OP_REG_ROWS = 48          # rows of the register row-roll form
OP_STRIP = 8              # rows a thread holds in the lane forms
OP_SMEM_TARGET = 112 * 1024  # a shared form's tile: 2 blocks per SM
OP_MMA_COLS = 64          # lanes of a band block: 8 n-tiles of 8
OP_MMA_THREADS = 288      # 9 warps, one per 16-row m-tile of the 144 rows
OP_BF16_PITCH = 152       # bf16 a row of A and of the tile (144 + 8)
OP_I8_K = 160             # int8 depth: 144 padded to 5 x 32
OP_I8_PITCH = 176         # bytes a row of A and of the tile (160 + 16)
# The lane rolls and their shift.
LANE_ROLL = {"roll3_i32": 3, "roll3_add_i32": 3, "roll1_add_i32": 1,
             "roll128_add_i32": 128}
ROW_ROLL = ("subroll1_add_i32", "subroll1_add_u8")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def op_chain_form(case: str, in_block: int, block: int) -> str:
    """The form csrc/op_chain.cu runs ``case`` in on a tile (``op_form``):
    the row-neighbour cases hold their rows in registers on the tool's
    tiles (48 rows for the row roll, 32 stored for the offset-1 shrink) and
    a column strip in shared memory otherwise; al_slice_add_i16 always in
    shared memory."""
    if case.startswith("mxu_rows"):
        return "band"
    if case in ROW_ROLL:
        return "cols" if in_block == OP_REG_ROWS else "roll_smem"
    if case in ("mis_slice_add_i32", "mis_slice_add_i16"):
        return "cols" if block == OP_REG_BLOCK else "shrink_smem"
    if case == "al_slice_add_i16":
        return "shrink_smem"
    if case.startswith("shfl"):
        return "strips"
    if case in LANE_ROLL:
        return "lanes"
    return "flat"


def op_chain_rows_read(case: str, n_ops: int, in_block: int,
                       block: int) -> int:
    """Rows of each tile that ``case``'s stored rows depend on after
    ``n_ops`` operations, which are the rows the kernel reads: the
    ``block`` stored rows for the elementwise cases and the lane rolls;
    ``block + shrink * n_ops`` for a shrinking add; every row for the
    end-around row roll; the band products' 144 (the first operation
    zeroes the rows below)."""
    if case in ROW_SHRINK:
        return block + ROW_SHRINK[case] * n_ops
    if case in ROW_ROLL:
        return in_block
    if case.startswith("mxu_rows"):
        return BAND
    return block


def _smem_elem(case: str) -> int:
    return CASES[case][1].itemsize


def _smem_cols(case: str, n_ops: int, in_block: int, block: int,
               wc: int) -> int:
    """Lanes of a shared-memory form's column strip (``op_smem_cols``)."""
    rows = op_chain_rows_read(case, n_ops, in_block, block)
    cw = OP_SMEM_TARGET // (rows * _smem_elem(case)) // 16 * 16
    return min(max(cw, 16), wc)


def op_chain_shape(case: str, n_ops: int, in_block: int, block: int,
                   wc: int, grid: int) -> dict:
    """The launch of ``case`` with a chain of ``n_ops`` on ``grid`` tiles
    (``op_shape`` in csrc/op_chain.cu): {"form", "blocks", "threads",
    "smem_bytes"}, with the blocks' grid ("grid_xy": the flat form (tile,
    16-byte runs), the column forms (tile [and strip], lanes), the others
    x alone) and the lanes of a block's column strip ("cols") for the
    shared-memory and band forms."""
    form = op_chain_form(case, in_block, block)
    strips = _ceil(block, OP_STRIP)
    threads, smem, cols, by = OP_COL_THREADS, 0, None, 1
    if form == "flat":
        threads = OP_FLAT_THREADS
        blocks, by = grid, _ceil(_ceil(block * wc, 16), OP_FLAT_THREADS)
    elif form == "cols":
        blocks, by = grid, _ceil(wc, OP_COL_THREADS)
    elif form == "strips":
        blocks, by = grid * strips, _ceil(wc, OP_COL_THREADS)
    elif form == "lanes":
        threads = _ceil(wc, 32) * 32
        blocks = grid * strips
        smem = 2 * OP_STRIP * threads * 4
    elif form in ("shrink_smem", "roll_smem"):
        cols = _smem_cols(case, n_ops, in_block, block, wc)
        threads = min(_ceil(cols, 32) * 32, OP_SMEM_THREADS)
        blocks = grid * _ceil(wc, cols)
        smem = (op_chain_rows_read(case, n_ops, in_block, block) * cols
                * _smem_elem(case))
    else:
        cols = OP_MMA_COLS
        threads = OP_MMA_THREADS
        blocks = grid * _ceil(wc, OP_MMA_COLS)
        smem = (BAND + OP_MMA_COLS) * (
            OP_BF16_PITCH * 2 if case == "mxu_rows_bf16" else OP_I8_PITCH)
    return {"form": form, "blocks": blocks * by, "threads": threads,
            "smem_bytes": smem, "grid_xy": (blocks, by), "cols": cols}


def op_chain_smem_bytes(case: str, n_ops: int, in_block: int, block: int,
                        wc: int) -> int:
    """Shared memory of one block of ``case`` (``op_chain_smem`` in
    csrc/op_chain.cu)."""
    return op_chain_shape(case, n_ops, in_block, block, wc, 1)["smem_bytes"]


def check_op_tile(case: str, n_ops: int, in_block: int, block: int,
                  wc: int) -> None:
    """Raise ValueError unless ``case`` with a chain of ``n_ops`` is
    defined on an (in_block, wc) tile storing ``block`` rows."""
    if case not in CASES:
        raise ValueError(f"unknown op_chain case {case!r}; the cases are "
                         f"{', '.join(CASES)}")
    if not 1 <= block <= in_block or wc < 1 or n_ops < 1:
        raise ValueError(f"bad tile: in_block={in_block} block={block} "
                         f"wc={wc} n_ops={n_ops}")
    need = block + ROW_SHRINK.get(case, 0) * n_ops
    if case.startswith("mxu_rows"):
        need = max(block, BAND)
    if in_block < need:
        raise ValueError(f"{case} with n_ops={n_ops} needs in_block >= "
                         f"{need}, got {in_block}")
    if case == "vadd4_u8" and wc % 4 or case == "vadd2_i16" and wc % 2:
        raise ValueError(f"{case} packs whole words: wc={wc}")
    if case.startswith("shfl") and wc % 32:
        raise ValueError(f"{case} rolls within 32-lane groups: wc={wc}")


def _wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Two's-complement wrap of an int64 value into ``dtype``."""
    bits = 8 * dtype.itemsize
    x = x & ((1 << bits) - 1)
    if dtype != torch.uint8:
        x = torch.where(x >= (1 << (bits - 1)), x - (1 << bits), x)
    return x.to(dtype)


def _op_body(case: str, x: torch.Tensor, band: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """One operation of ``case`` on a tile batch ``x`` (grid, rows, wc) in
    the case's dtype. Integer arithmetic runs in int64 and wraps."""
    dt = x.dtype
    if dt == torch.float32:
        if case == "add_f32":
            return x + x
        return x * torch.tensor(0.998, dtype=dt, device=x.device) + x
    w = x.to(torch.int64)
    if case in ("add_u8", "add_i32", "add_i16", "strip_add_i32", "vadd4_u8",
                "vadd2_i16"):
        return _wrap(w + w, dt)
    if case in ("subroll1_add_i32", "subroll1_add_u8"):
        return _wrap(w + torch.roll(w, 1, 1), dt)
    if case in ("cvt_u8_i32_rt", "cvt_i16_i32_rt"):
        return _wrap(_wrap(w, torch.int32).to(torch.int64), dt)
    if case in ROW_SHRINK:
        off = ROW_SHRINK[case]
        n = w.shape[1] - off
        return _wrap(w[:, :n] + w[:, off:off + n], dt)
    if case == "roll3_i32":
        return torch.roll(x, 3, 2)
    if case in ("roll3_add_i32", "roll1_add_i32", "roll128_add_i32"):
        s = int(case[4:].split("_")[0])
        return _wrap(w + torch.roll(w, s, 2), dt)
    if case in ("shfl1_add_i32", "shfl3_add_i32"):
        s = int(case[4])
        g = w.reshape(w.shape[0], w.shape[1], -1, 32)
        return _wrap(w + torch.roll(g, s, 3).reshape(w.shape), dt)
    if case == "mul_add_i32":
        return _wrap(w * 3 + w, dt)
    if case == "mul_i32":
        return _wrap(w * 3, dt)
    if case == "shift_i32":
        return x >> 1
    if case == "where_i32":
        return torch.where(x > 0, x, 0)
    if case == "clip_i32":
        return torch.clamp(x, 0, 255)
    if case == "mxu_rows_bf16":
        # int32 -> float32 -> bf16 inputs, float32 products and sums.
        xb = x[:, :BAND].to(torch.float32).to(torch.bfloat16)
        y = torch.matmul(band.to(x.device), xb.to(torch.float32))
        y = y.to(torch.int32)
        return torch.cat([y, torch.zeros_like(x[:, BAND:])], 1)
    if case == "mxu_rows_i8":
        # int8 inputs, exact integer sums (float64 holds them exactly; a
        # card has no int64 matrix product).
        xi = _wrap(w[:, :BAND], torch.int8).to(torch.float64)
        y = torch.matmul(band.to(x.device).to(torch.float64), xi)
        y = _wrap(y.to(torch.int64), dt)
        return torch.cat([y, torch.zeros_like(x[:, BAND:])], 1)
    raise ValueError(f"unknown op_chain case {case!r}")


def op_chain_plain(x: torch.Tensor, case: str, n_ops: int, in_block: int,
                   block: int) -> torch.Tensor:
    """L1's function in torch ops: ``x`` (grid * in_block, wc) uint8 ->
    (grid * block, wc) uint8. Per tile: convert to the case's dtype, apply
    the case's operation ``n_ops`` times, keep the first ``block`` rows,
    convert to uint8 (integers wrap, float32 saturates)."""
    wc = x.shape[1]
    check_op_tile(case, n_ops, in_block, block, wc)
    dt = CASES[case][1]
    t = x.reshape(-1, in_block, wc).to(dt)
    band = band_matrix() if case.startswith("mxu_rows") else None
    for _ in range(n_ops):
        t = _op_body(case, t, band)
    t = t[:, :block]
    if dt == torch.float32:
        out = torch.clamp(t, 0.0, 255.0).to(torch.uint8)
    else:
        out = _wrap(t.to(torch.int64), torch.uint8)
    return out.reshape(-1, wc).contiguous()


def _op_lib() -> ctypes.CDLL:
    lib = _build.load("op_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.op_chain_launch.argtypes = [i, i, p, p, p, i, i, i, i, p]
    lib.op_chain_launch.restype = ctypes.c_int
    lib.op_chain_smem.argtypes = [i, i, i, i, i]
    lib.op_chain_smem.restype = ctypes.c_longlong
    lib.op_chain_shape.argtypes = [i, i, i, i, i, i, p]
    lib.op_chain_shape.restype = ctypes.c_int
    lib.op_chain_n_cases.argtypes = []
    lib.op_chain_n_cases.restype = ctypes.c_int
    lib.op_chain_error_string.argtypes = [i]
    lib.op_chain_error_string.restype = ctypes.c_char_p
    if lib.op_chain_n_cases() != len(CASES):
        raise _build.KernelBuildError(
            f"op_chain.cu has {lib.op_chain_n_cases()} cases, CASES has "
            f"{len(CASES)}: the two tables must list the same cases"
        )
    return lib


def op_chain_kernel_smem_bytes(case: str, n_ops: int, in_block: int,
                               block: int, wc: int) -> int:
    """What the built library itself says a block of ``case`` takes
    (:func:`op_chain_smem_bytes` is the host model of it)."""
    return int(_op_lib().op_chain_smem(CASES[case][0], n_ops, in_block,
                                       block, wc))


def op_chain_kernel_shape(case: str, n_ops: int, in_block: int, block: int,
                          wc: int, grid: int) -> dict:
    """The launch as the built library makes it, with its resident blocks
    per SM on the current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
    {"form", "blocks", "threads", "smem_bytes", "blocks_per_sm"}
    (:func:`op_chain_shape` is the host model of the first four)."""
    lib = _op_lib()
    out = (ctypes.c_longlong * 5)()
    rc = lib.op_chain_shape(CASES[case][0], n_ops, in_block, block, wc, grid,
                            out)
    cs._raise_on(rc, lib, "op_chain_error_string", f"op_chain[{case}] shape")
    return {"form": OP_FORMS[out[0]], "blocks": int(out[1]),
            "threads": int(out[2]), "smem_bytes": int(out[3]),
            "blocks_per_sm": int(out[4])}


_BAND_ON: Dict[tuple, torch.Tensor] = {}


def _band_on(case: str, device: torch.device) -> torch.Tensor:
    key = (case, str(device))
    if key not in _BAND_ON:
        dt = torch.bfloat16 if case == "mxu_rows_bf16" else torch.int8
        _BAND_ON[key] = band_matrix().to(dt).contiguous().to(device)
    return _BAND_ON[key]


def op_chain(x: torch.Tensor, case: str, n_ops: int, in_block: int,
             block: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1: one launch of ``case`` with a chain of ``n_ops`` (one of
    :data:`BUILT_N_OPS`) over the tiles of ``x`` (grid * in_block, wc) uint8 into
    ``out`` (grid * block, wc) uint8 (allocated when None), in the form
    :func:`op_chain_form` names. CPU tensors run :func:`op_chain_plain`;
    on the card the lane rolls take rows of at most :data:`OP_LANES_MAX`
    lanes."""
    cs._check_input(x)
    wc = x.shape[1]
    check_op_tile(case, n_ops, in_block, block, wc)
    if x.shape[0] % in_block:
        raise ValueError(f"{x.shape[0]} rows are not whole {in_block}-row "
                         "tiles")
    grid = x.shape[0] // in_block
    if x.device.type == "cpu":
        res = op_chain_plain(x, case, n_ops, in_block, block)
        return res if out is None else out.copy_(res)
    if n_ops not in BUILT_N_OPS:
        raise ValueError(f"the op_chain library is built for n_ops in "
                         f"{BUILT_N_OPS}, got {n_ops}")
    if case in LANE_ROLL and wc > OP_LANES_MAX:
        raise ValueError(f"{case}: the kernel holds a row in one block, "
                         f"wc <= {OP_LANES_MAX}, got {wc}")
    if op_chain_smem_bytes(case, n_ops, in_block, block,
                           wc) > cs.SMEM_LIMIT:
        raise ValueError(f"{case}: an ({in_block}, {wc}) tile does not fit "
                         "shared memory")
    lib = _op_lib()
    if out is None:
        out = torch.empty((grid * block, wc), dtype=torch.uint8,
                          device=x.device)
    cs._check_cuda(x, out)
    cs._check_input(out)
    if tuple(out.shape) != (grid * block, wc):
        raise ValueError(f"out must be ({grid * block}, {wc}), got "
                         f"{tuple(out.shape)}")
    aux = (_band_on(case, x.device).data_ptr()
           if case.startswith("mxu_rows") else None)
    with torch.cuda.device(x.device):
        rc = lib.op_chain_launch(
            CASES[case][0], n_ops, x.data_ptr(), out.data_ptr(), aux,
            in_block, block, wc, grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cs._raise_on(rc, lib, "op_chain_error_string", f"op_chain[{case}]")
    op_chain.launches += 1
    return out


op_chain.launches = 0


def launch_counts() -> Dict[str, int]:
    """The lab kernels' launch counters, by kernel name."""
    return {"stencil_lab": stencil_lab.launches,
            "op_chain": op_chain.launches}


def reset_launch_counts() -> None:
    stencil_lab.launches = 0
    op_chain.launches = 0
