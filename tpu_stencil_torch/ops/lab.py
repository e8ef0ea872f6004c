"""The lab kernels: wrappers, plain versions, variants and cases.

Two hand-written CUDA kernels serve the tuning and lab tools
(:mod:`tpu_stencil_torch.tools`), each the Hopper counterpart of a TPU
kernel of the JAX package's ``tools/``:

* **L2** :func:`stencil_lab` (``csrc/stencil_lab.cu``, replaces
  ``tools/kernel_lab.py``'s ``_lab_kernel``): K1's job with the body of one
  rep chosen when the library is built. A :class:`LabVariant` names a body
  (``current``, ``pair``, ``acc16``, ``swar``), ablation flags (wrong
  output, timing only) and a requested geometry; each (body, ablation) is
  one library, built with its ``-D`` defines through
  :mod:`tpu_stencil_torch.ops._build`.
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
from tpu_stencil_torch.ops.lowering import StencilPlan

# ---------------------------------------------------------------------------
# L2: variants
# ---------------------------------------------------------------------------

BODIES = ("current", "pair", "acc16", "swar")  # LAB_BODY = index
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


def parse_variant(name: str) -> LabVariant:
    """The variant a lab name means: ``[abl_]BODY[_ABLATION][_bN][_fN]``,
    e.g. ``swar``, ``pair_b64``, ``current_f16_b64``, ``abl_no_rows``
    (on ``current``), ``abl_swar_no_mask``. Raises ValueError for any
    other name."""
    rest, geo = name, {}
    while True:
        m = _GEOMETRY_SUFFIX.search(rest)
        if not m:
            break
        if m.group(1) in geo:
            raise ValueError(f"unknown lab variant {name!r}")
        geo[m.group(1)] = int(m.group(2))
        rest = rest[:m.start()]
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


def acc16_ok(plan: StencilPlan) -> bool:
    """The rows-pass intermediate fits int16: non-negative taps and
    ``255 * sum(row_taps) < 2^15``."""
    if plan.kind != "sep_int":
        return False
    nonneg = all(t >= 0 for t in plan.row_taps + plan.col_taps)
    return nonneg and 255 * sum(plan.row_taps) < 2 ** 15


def swar_ok(plan: StencilPlan) -> bool:
    """Two 16-bit fields per word never carry into each other: a separable
    plan that shifts by at most 8 and needs no clip (non-negative taps of
    total weight 2^shift, so every intermediate is < 2^16)."""
    return (plan.kind == "sep_int" and plan.shift is not None
            and plan.shift <= 8 and not cs.clip_needed(plan))


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
    if variant.body == "swar":
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
    ``pair``, 3 for ``acc16``, and for ``swar`` two 32-bit words per row
    pair plus one pad pair at each end of the carry."""
    g = fuse * plan.halo
    rr = block_h + 2 * g
    ll = tile_w + 2 * g * channels
    if variant.body == "swar":
        return ((rr // 2 + 2) + rr // 2) * ll * 4
    return rr * ll * (3 if variant.body == "acc16" else 5)


def lab_geometry(variant: LabVariant, plan: StencilPlan, n_rows: int,
                 channels: int) -> Tuple[int, int]:
    """The (block_h, fuse) ``variant`` launches with: K1's effective
    geometry at the variant's requested one, so that variants at one
    request run the same tiles (every body's tile is at most K1's)."""
    return cs.effective_geometry(plan, n_rows, channels, variant.block_h,
                                 variant.fuse)


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
              variant: LabVariant, mask: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """One rep on packed words: ``p64`` (Q, wc) int64 holding 32-bit words
    of two 16-bit fields, rows 2q (low) and 2q+1 (high). Zero pairs stand
    above and below, zero lanes left and right. ``mask`` (Q, wc) holds
    0x00FF per kept field."""
    h, k = plan.halo, plan.k
    hc = h * channels
    q, wc = p64.shape
    hp = (h + 1) // 2
    word = 0xFFFFFFFF
    zrow = torch.zeros((hp, wc), dtype=torch.int64, device=p64.device)
    pp = torch.cat([zrow, p64, zrow], 0)  # pair j of p64 at pp[j + hp]
    # Straddle j: (row 2j+1, row 2j+2) = high field of pair j under the low
    # field of pair j+1.
    ss = (pp[:-1] >> 16) | ((pp[1:] & 0xFFFF) << 16)
    if variant.no_rows:
        t = p64
    else:
        t = torch.zeros_like(p64)
        for i, tap in enumerate(plan.row_taps):
            r = i - h  # W[2q + r], floor-divided into the windows
            j = hp + (r // 2)
            src = pp if r % 2 == 0 else ss
            t = (t + tap * src[j:j + q]) & word
    if variant.no_cols:
        acc = t
    else:
        zl = torch.zeros((q, hc), dtype=torch.int64, device=p64.device)
        tt = torch.cat([zl, t, zl], 1)
        acc = torch.zeros_like(t)
        for j, tap in enumerate(plan.col_taps):
            acc = (acc + tap * tt[:, j * channels:j * channels + wc]) & word
    m = 0x00FF00FF if mask is None else mask
    return (acc >> plan.shift) & m


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

    if variant.body != "swar":
        cur = extend(torch.where(keep, x2, 0) if not variant.no_mask else x2,
                     g, gc)
        for _ in range(reps):
            val = _scalar_rep(extend(cur, h, hc), plan, channels, variant)
            if variant.no_mask:
                cur = val.to(torch.uint8)
            else:
                cur = torch.where(keep, val, 0).to(torch.uint8)
        return cur[g:g + rows, gc:gc + wc].contiguous()

    # swar: pack row pairs (an odd row count gains one zero row).
    x = x2 if variant.no_mask else torch.where(keep, x2, 0)
    x = extend(x, g, gc).to(torch.int64)
    total = x.shape[0]
    if total % 2:
        x = torch.cat([x, torch.zeros_like(x[:1])], 0)
    p64 = x[0::2] | (x[1::2] << 16)
    mask = None
    if not variant.no_mask:
        kk = keep.to(torch.int64) * 0xFF
        if rows % 2:
            kk = torch.cat([kk, torch.zeros_like(kk[:1])], 0)
        mask = (kk[0::2] | (kk[1::2] << 16)).expand(-1, wc)
    for _ in range(reps):
        p64 = _swar_rep(p64, plan, channels, variant, mask)
    out = torch.stack([p64 & 0xFF, (p64 >> 16) & 0xFF], 1)
    out = out.reshape(-1, p64.shape[1])[:total].to(torch.uint8)
    return out[g:g + rows, gc:gc + wc].contiguous()


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


def op_chain_smem_bytes(case: str, in_block: int, wc: int) -> int:
    """Shared memory of one tile of ``case`` (``op_smem`` in
    csrc/op_chain.cu)."""
    n = in_block * wc
    if case == "mxu_rows_bf16":
        return (n + BAND * wc) * 4
    if case == "mxu_rows_i8":
        return (n + (BAND // 4) * wc) * 4
    if case in ("cvt_u8_i32_rt", "cvt_i16_i32_rt"):
        return n * (4 + CASES[case][1].itemsize)
    if case.startswith("roll"):
        return n * 8
    return n * CASES[case][1].itemsize


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
    lib.op_chain_smem.argtypes = [i, i, i]
    lib.op_chain_smem.restype = ctypes.c_longlong
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


def op_chain_kernel_smem_bytes(case: str, in_block: int, wc: int) -> int:
    """What the built library itself says a tile of ``case`` takes
    (:func:`op_chain_smem_bytes` is the host model of it)."""
    return int(_op_lib().op_chain_smem(CASES[case][0], in_block, wc))


_BAND_ON: Dict[tuple, torch.Tensor] = {}


def _band_on(case: str, device: torch.device) -> torch.Tensor:
    key = (case, str(device))
    if key not in _BAND_ON:
        a = band_matrix()
        if case == "mxu_rows_i8":
            a = a.to(torch.int8)
        _BAND_ON[key] = a.contiguous().to(device)
    return _BAND_ON[key]


def op_chain(x: torch.Tensor, case: str, n_ops: int, in_block: int,
             block: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1: one launch of ``case`` with a chain of ``n_ops`` (one of
    :data:`BUILT_N_OPS`) over the tiles of ``x`` (grid * in_block, wc) uint8 into
    ``out`` (grid * block, wc) uint8 (allocated when None). CPU tensors run
    :func:`op_chain_plain`."""
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
    if op_chain_smem_bytes(case, in_block, wc) > cs.SMEM_LIMIT:
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
