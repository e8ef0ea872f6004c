"""The hand-written CUDA stencil kernels: wrappers, plain versions, geometry.

Two kernels carry the main path, each the Hopper counterpart of a TPU
kernel of the JAX package's ``ops/pallas_stencil.py``:

* **K1** :func:`stencil_fused` (``csrc/stencil_fused.cu``, replaces
  ``_sep_kernel``): ``fuse`` reps per trip through device memory, one tile
  of ``block_h`` rows by :data:`TILE_W` flat lanes per block, ghost bands in
  shared memory. :func:`iterate` runs ``reps // fuse`` fused launches, then
  ``reps % fuse`` single-rep launches, ping-ponging two uint8 buffers.
* **K2** :func:`stencil_resident` (``csrc/stencil_resident.cu``, replaces
  ``_resident_kernel``): the whole rep loop in one cooperative launch with
  a grid-wide sync per rep, for ``schedule='deep'`` when both buffers fit
  the L2 budget (:func:`resident_feasible`).

One kernel carries the sharded path (:mod:`tpu_stencil_torch.parallel.
sharded`):

* **K3** :func:`stencil_valid` (``csrc/stencil_valid.cu``, replaces
  ``_valid_kernel``; :func:`valid_fused` is the JAX package's entry):
  ``fuse`` reps of one shard's ghost-extended tile, re-zeroing only the
  pixels outside the global padded extent, returning the interior.

Each wrapper takes its plain PyTorch version (int32 shifted slices, the
same function) only for a tensor on the CPU. For a CUDA tensor it launches
its kernel or raises; nothing falls back. ``stencil_fused.launches``,
``stencil_resident.launches`` and ``stencil_valid.launches`` count the
launches and nothing else.

The image is viewed flat as ``(rows, W*C)``: a column-pass tap moves by
``C`` flat lanes, so channels never mix, and the column boundary is the
flat range ``[0, W*C)``. Every rep re-zeroes pixels outside the image —
rows outside ``[0, rows_real)`` and, in the frames layout, the gap rows
``row % stride >= frame_h`` — as the TPU kernels' ``_row_keep`` does.

Geometry is re-derived for Hopper: the TPU's 16 MiB VMEM budget becomes
the 227 KB of shared memory a block may use (the ghost band must fit the
tile's shared memory) and, for the resident kernel, a share of the L2.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from tpu_stencil_torch.config import PALLAS_SCHEDULES
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.ops.lowering import StencilPlan

DEFAULT_BLOCK_H = 32      # output rows per tile (8-row aligned)
DEFAULT_FUSE = 8          # reps per trip through device memory
TILE_W = 256              # output flat lanes per tile
MAX_K = 15                # filter sizes the kernels take (STENCIL_MAX_K)
# Shared memory one block may use on an H100 (227 KB, opt-in above 48 KB).
SMEM_LIMIT = 232448
# L2 of an H100 (50 MB), used where no card is queried (the CPU path).
H100_L2_BYTES = 50 * 2 ** 20
# Share of the L2 the resident kernel's two buffers may take.
RESIDENT_L2_SHARE = 0.75
# Deep trapezoid depths, deepest first (as the JAX package's).
DEEP_FUSE_CANDIDATES = (64, 48, 40, 32, 24, 16, 12, 8)

FUSED = "fused"   # the reported schedule of every K1 run
DEEP = "deep"

class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (the C entry returned a cudaError_t)."""


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def check_schedule(schedule: Optional[str]) -> Optional[str]:
    """``schedule`` if it is a name the kernels take: the JAX package's
    schedule names, or 'fused', the name every K1 run reports (what the
    autotuner's verdicts carry)."""
    if schedule is not None and schedule not in PALLAS_SCHEDULES + (FUSED,):
        raise ValueError(
            f"schedule must be one of {'|'.join(PALLAS_SCHEDULES)}, "
            f"got {schedule!r}"
        )
    return schedule


def effective_schedule(schedule: Optional[str]) -> str:
    """The schedule name a run reports: 'deep', or 'fused' for every other
    name (on Hopper they all run K1)."""
    return DEEP if check_schedule(schedule) == DEEP else FUSED


def tile_smem_bytes(plan: StencilPlan, block_h: int, fuse: int,
                    channels: int, tile_w: int = TILE_W) -> int:
    """Shared memory of one tile: the uint8 carry plus the int32 rows-pass
    intermediate over the tile and its ghost bands (stencil_tile_smem)."""
    g = fuse * plan.halo
    return (block_h + 2 * g) * (tile_w + 2 * g * channels) * 5


def plan_supported(plan: StencilPlan, channels: int) -> bool:
    """Whether the kernels run this plan: an integer plan of at most
    :data:`MAX_K` taps whose single-rep ghost band fits shared memory at
    the smallest tile. Other plans run torch ops (reported as xla)."""
    return (
        plan.kind in ("sep_int", "direct_int")
        and plan.k <= MAX_K
        and tile_smem_bytes(plan, 8, 1, channels) <= SMEM_LIMIT
    )


def clip_needed(plan: StencilPlan) -> bool:
    """clip(acc >> shift, 0, 255) is the identity when taps are
    non-negative and their total weight is 2^shift: acc <= 255 * 2^shift."""
    if plan.shift is None:
        return True
    if plan.kind == "sep_int":
        flat = plan.row_taps + plan.col_taps
        total = sum(abs(t) for t in plan.row_taps) * sum(
            abs(t) for t in plan.col_taps
        )
    else:
        flat = tuple(t for row in plan.taps for t in row)
        total = sum(abs(t) for t in flat)
    nonneg = all(t >= 0 for t in flat)
    return not (nonneg and total == 2 ** plan.shift)


def effective_block_h(plan: StencilPlan, n_rows: int, channels: int,
                      block_h: Optional[int] = None) -> int:
    """The tile height a launch uses: 8-row aligned, clamped to the padded
    image height and to what fits shared memory at fuse 1."""
    bh = DEFAULT_BLOCK_H if block_h is None else block_h
    bh = min(-(-bh // 8) * 8, -(-n_rows // 8) * 8)
    while bh > 8 and tile_smem_bytes(plan, bh, 1, channels) > SMEM_LIMIT:
        bh -= 8
    return bh


def deep_fuse_for(plan: StencilPlan, block_h: int, channels: int) -> int:
    """The depth 'deep' runs K1 at when the resident kernel does not run:
    the deepest :data:`DEEP_FUSE_CANDIDATES` entry whose ghost recompute
    stays <= 50% of the tile (``2*depth*halo <= block_h/2``) and whose tile
    fits shared memory; shallower depths when none does."""
    if not plan.halo:
        return DEEP_FUSE_CANDIDATES[0]
    cap = max(1, block_h // (4 * plan.halo))
    for cand in DEEP_FUSE_CANDIDATES + (min(DEFAULT_FUSE, cap), 4, 2, 1):
        if cand <= cap and tile_smem_bytes(plan, block_h, cand,
                                           channels) <= SMEM_LIMIT:
            return cand
    return 1


def effective_geometry(plan: StencilPlan, n_rows: int, channels: int,
                       block_h: Optional[int] = None,
                       fuse: Optional[int] = None,
                       schedule: Optional[str] = None) -> Tuple[int, int]:
    """The (block_h, fuse) K1 launches with for an ``n_rows``-tall image:
    the aligned/clamped tile height, and fuse clamped to
    ``block_h / (2*halo)`` and to shared memory. ``None`` = defaults,
    except that an unforced fuse under ``schedule='deep'`` is
    :func:`deep_fuse_for`'s depth."""
    bh = effective_block_h(plan, n_rows, channels, block_h)
    if fuse is None and schedule == DEEP:
        fz = deep_fuse_for(plan, bh, channels)
    else:
        fz = DEFAULT_FUSE if fuse is None else fuse
    if plan.halo:
        fz = max(1, min(fz, bh // (2 * plan.halo)))
    while fz > 1 and tile_smem_bytes(plan, bh, fz, channels) > SMEM_LIMIT:
        fz -= 1
    return bh, fz


def valid_geometry(plan: StencilPlan, th: int, channels: int, fuse: int,
                   block_h: Optional[int] = None) -> Tuple[int, int]:
    """The (block_h, fuse) K3 launches with on a ``th``-row interior:
    K1's aligned and clamped tile height, cut until the tile and its
    ``fuse * halo`` ghost band fit shared memory; then ``fuse`` cut where
    even 8 rows do not fit. The sharded runner takes the fuse from here
    (it sets the exchange width), :func:`valid_fused` the tile height."""
    bh = effective_block_h(plan, th, channels, block_h)
    while bh > 8 and tile_smem_bytes(plan, bh, fuse, channels) > SMEM_LIMIT:
        bh -= 8
    while fuse > 1 and tile_smem_bytes(plan, bh, fuse, channels) > SMEM_LIMIT:
        fuse -= 1
    return bh, fuse


def launch_schedule(repetitions: int, fuse: int) -> List[int]:
    """The rep depth of each K1 launch: ``reps // fuse`` fused launches,
    then ``reps % fuse`` single-rep launches."""
    if fuse <= 1:
        return [1] * repetitions
    return [fuse] * (repetitions // fuse) + [1] * (repetitions % fuse)


def device_caps(device: Optional[torch.device]) -> Tuple[int, bool]:
    """(L2 bytes, cooperative launch supported) of ``device``; an H100's
    L2 where the device is not a CUDA card (the CPU path)."""
    if device is None or torch.device(device).type != "cuda":
        return H100_L2_BYTES, True
    props = torch.cuda.get_device_properties(device)
    with torch.cuda.device(device):
        coop = _resident_lib().stencil_resident_cooperative()
    if coop < 0:
        raise KernelLaunchError(
            f"cooperative-launch query failed: cudaError_t {-coop}"
        )
    return int(props.L2_cache_size), bool(coop)


def resident_feasible(plan: StencilPlan, n_rows: int, wc: int,
                      channels: int, device: Optional[torch.device] = None,
                      l2_bytes: Optional[int] = None) -> bool:
    """Whether K2 runs: a supported plan, a card that supports cooperative
    launch, and both uint8 buffers (``2 * rows * W*C`` bytes) within
    :data:`RESIDENT_L2_SHARE` of the L2 (``l2_bytes`` overrides the
    device's)."""
    if not plan_supported(plan, channels):
        return False
    l2, coop = device_caps(device)
    if l2_bytes is not None:
        l2 = l2_bytes
    return coop and 2 * n_rows * wc <= RESIDENT_L2_SHARE * l2


def deep_geometry(plan: StencilPlan, n_rows: int, w: int, channels: int,
                  block_h: Optional[int] = None, fuse: Optional[int] = None,
                  device: Optional[torch.device] = None
                  ) -> Tuple[Optional[int], Optional[int]]:
    """The (block_h, fuse) a 'deep' launch reports: (None, None) when the
    resident kernel runs (no static geometry), else K1's effective
    geometry at the deep depth. Forced geometry forces K1."""
    if (block_h is None and fuse is None
            and resident_feasible(plan, n_rows, w * channels, channels,
                                  device)):
        return None, None
    return effective_geometry(plan, n_rows, channels, block_h, fuse,
                              schedule=DEEP)


def frames_stride(plan: StencilPlan, frame_h: int) -> int:
    """Row stride of the frames tall layout: each frame plus a
    ``halo``-row zero gap (re-zeroed every rep)."""
    return frame_h + plan.halo


def frames_rows(plan: StencilPlan, frame_h: int, n_frames: int) -> int:
    """Row count of the tall launch for ``n_frames`` stacked frames."""
    return n_frames * frames_stride(plan, frame_h)


# ---------------------------------------------------------------------------
# Plain version — both kernels' function in torch ops
# ---------------------------------------------------------------------------


def _row_keep(rows: int, rows_real: int, frame, device) -> torch.Tensor:
    """(rows,) bool: rows inside the image (and, under ``frame`` =
    (stride, frame_h), outside the inter-frame gaps)."""
    rid = torch.arange(rows, device=device)
    keep = rid < rows_real
    if frame is not None:
        stride, frame_h = frame
        keep &= (rid % stride) < frame_h
    return keep


def stencil_fused_plain(x2: torch.Tensor, plan: StencilPlan, channels: int,
                        reps: int, rows_real: Optional[int] = None,
                        frame=None) -> torch.Tensor:
    """The function of both kernels in torch ops: ``reps`` zero-boundary
    reps of the flat (rows, W*C) uint8 image, each one
    :func:`lowering.padded_step` (int32 shifted slices) on the
    (rows, W[, C]) view, then the re-zero of rows outside ``rows_real``
    and of the frame gap rows."""
    rows, wc = x2.shape
    rows_real = rows if rows_real is None else rows_real
    shape = (rows, wc // channels, channels) if channels > 1 else (rows, wc)
    keep = _row_keep(rows, rows_real, frame, x2.device)
    keep = keep.reshape((rows,) + (1,) * (len(shape) - 1))
    cur = torch.where(keep, x2.reshape(shape), 0)
    for _ in range(reps):
        cur = torch.where(keep, _lowering.padded_step(cur, plan), 0)
    return cur.reshape(rows, wc)


stencil_resident_plain = stencil_fused_plain


def stencil_valid_plain(ext2: torch.Tensor, plan: StencilPlan, channels: int,
                        fuse: int, row0: int, col0: int,
                        global_shape: Tuple[int, int]) -> torch.Tensor:
    """K3's function in torch ops: ``fuse`` reps of the flat ghost-extended
    tile ``ext2`` (th + 2g, (tw + 2g) * C), g = fuse * halo, each one
    :func:`lowering.valid_step` (which shrinks the tile by halo per side)
    and then the re-zero of every pixel outside the global padded extent
    ``global_shape`` = (rows, cols * C), placed by the interior's global
    origin (``row0``, flat ``col0``). Returns the (th, tw * C) interior —
    what ``_valid_kernel`` keeps after its re-pad by halo each rep, whose
    padded band never reaches the interior."""
    h = plan.halo
    g = fuse * h
    rows_ext, wc_ext = ext2.shape
    shape = (rows_ext, wc_ext // channels, channels) if channels > 1 else (
        rows_ext, wc_ext)
    cur = ext2.reshape(shape)
    rows_glob, cols_glob_c = global_shape
    for t in range(1, fuse + 1):
        cur = _lowering.valid_step(cur, plan)
        first = t * h  # ext index of cur's first row and first pixel
        rid = torch.arange(cur.shape[0], device=cur.device)
        rid = rid + (row0 + first - g)
        keep = (rid >= 0) & (rid < rows_glob)
        cid = torch.arange(cur.shape[1] * channels, device=cur.device)
        cid = cid + (col0 + (first - g) * channels)
        kc = ((cid >= 0) & (cid < cols_glob_c)).reshape(cur.shape[1:])
        keep = keep.reshape((-1,) + (1,) * (cur.dim() - 1)) & kc
        cur = torch.where(keep, cur, 0)
    return cur.reshape(rows_ext - 2 * g, wc_ext - 2 * g * channels)


# ---------------------------------------------------------------------------
# ctypes binding
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirrors ``StencilParams`` in csrc/stencil_tile.cuh."""

    _fields_ = [
        ("kind", ctypes.c_int), ("k", ctypes.c_int), ("shift", ctypes.c_int),
        ("clip", ctypes.c_int), ("divisor", ctypes.c_float),
        ("row_taps", ctypes.c_int * MAX_K), ("col_taps", ctypes.c_int * MAX_K),
        ("taps", ctypes.c_int * (MAX_K * MAX_K)),
    ]


class _Geometry(ctypes.Structure):
    """Mirrors ``StencilGeometry`` in csrc/stencil_tile.cuh."""

    _fields_ = [
        ("rows", ctypes.c_int), ("wc", ctypes.c_int),
        ("rows_real", ctypes.c_int), ("channels", ctypes.c_int),
        ("frame_stride", ctypes.c_int), ("frame_h", ctypes.c_int),
        ("tile_h", ctypes.c_int), ("tile_w", ctypes.c_int),
    ]


class _ValidGeometry(ctypes.Structure):
    """Mirrors ``StencilValidGeometry`` in csrc/stencil_valid.cu."""

    _fields_ = [
        ("rows_ext", ctypes.c_int), ("wc_ext", ctypes.c_int),
        ("rows_out", ctypes.c_int), ("wc_out", ctypes.c_int),
        ("channels", ctypes.c_int), ("row0", ctypes.c_int),
        ("col0", ctypes.c_int), ("rows_glob", ctypes.c_int),
        ("cols_glob_c", ctypes.c_int), ("tile_h", ctypes.c_int),
        ("tile_w", ctypes.c_int),
    ]


def _params(plan: StencilPlan) -> _Params:
    p = _Params()
    p.kind = 0 if plan.kind == "sep_int" else 1
    p.k = plan.k
    p.shift = -1 if plan.shift is None else plan.shift
    p.clip = int(clip_needed(plan))
    p.divisor = plan.divisor
    if plan.kind == "sep_int":
        for i, t in enumerate(plan.row_taps):
            p.row_taps[i] = t
        for i, t in enumerate(plan.col_taps):
            p.col_taps[i] = t
    else:
        for i, row in enumerate(plan.taps):
            for j, t in enumerate(row):
                p.taps[i * plan.k + j] = int(t)  # packed with stride k
    return p


def _geometry(x2: torch.Tensor, channels: int, rows_real: int, frame,
              block_h: int) -> _Geometry:
    stride, frame_h = frame if frame is not None else (0, 0)
    return _Geometry(x2.shape[0], x2.shape[1], rows_real, channels, stride,
                     frame_h, block_h, TILE_W)


_P = ctypes.c_void_p


def _fused_lib() -> ctypes.CDLL:
    lib = _build.load("stencil_fused")
    lib.stencil_fused_launch.argtypes = [_P, _P, _P, _P, ctypes.c_int, _P]
    lib.stencil_fused_launch.restype = ctypes.c_int
    lib.stencil_fused_error_string.argtypes = [ctypes.c_int]
    lib.stencil_fused_error_string.restype = ctypes.c_char_p
    return lib


def _resident_lib() -> ctypes.CDLL:
    lib = _build.load("stencil_resident")
    lib.stencil_resident_launch.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int,
                                            _P]
    lib.stencil_resident_launch.restype = ctypes.c_int
    lib.stencil_resident_cooperative.argtypes = []
    lib.stencil_resident_cooperative.restype = ctypes.c_int
    lib.stencil_resident_error_string.argtypes = [ctypes.c_int]
    lib.stencil_resident_error_string.restype = ctypes.c_char_p
    return lib


def _valid_lib() -> ctypes.CDLL:
    lib = _build.load("stencil_valid")
    lib.stencil_valid_launch.argtypes = [_P, _P, _P, _P, ctypes.c_int, _P]
    lib.stencil_valid_launch.restype = ctypes.c_int
    lib.stencil_valid_error_string.argtypes = [ctypes.c_int]
    lib.stencil_valid_error_string.restype = ctypes.c_char_p
    return lib


def build_kernels() -> Dict[str, str]:
    """Build every kernel library (in parallel) and return name -> path."""
    return {n: str(p) for n, p in _build.build().items()}


def _check_input(x2: torch.Tensor) -> None:
    if x2.dtype != torch.uint8 or x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(
            f"expected a contiguous 2-D uint8 tensor, got {x2.dtype} "
            f"{tuple(x2.shape)} contiguous={x2.is_contiguous()}"
        )


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"the CUDA kernels take CUDA tensors on one device, got "
                f"{[str(u.device) for u in ts]}"
            )


def _raise_on(rc: int, lib, fn_name: str, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, fn_name)(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what} launch failed: cudaError_t {rc} ({msg})")


def stencil_fused(x2: torch.Tensor, plan: StencilPlan, channels: int,
                  fuse: int, rows_real: Optional[int] = None, frame=None,
                  block_h: int = DEFAULT_BLOCK_H,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``fuse`` reps of the flat (rows, W*C) uint8 image ``x2`` into
    ``out`` (allocated when None; must not alias ``x2``). ``rows_real``:
    rows past it lie outside the image; ``frame`` = (stride, frame_h)
    marks the frames layout. CPU tensors run :func:`stencil_fused_plain`."""
    _check_input(x2)
    rows_real = x2.shape[0] if rows_real is None else rows_real
    if x2.device.type == "cpu":
        res = stencil_fused_plain(x2, plan, channels, fuse, rows_real, frame)
        return res if out is None else out.copy_(res)
    lib = _fused_lib()
    out = torch.empty_like(x2) if out is None else out
    _check_cuda(x2, out)
    _check_input(out)
    if out.data_ptr() == x2.data_ptr() or out.shape != x2.shape:
        raise ValueError("out must be a distinct buffer of x2's shape")
    params = _params(plan)
    geom = _geometry(x2, channels, rows_real, frame, block_h)
    with torch.cuda.device(x2.device):
        rc = lib.stencil_fused_launch(
            x2.data_ptr(), out.data_ptr(), ctypes.addressof(params),
            ctypes.addressof(geom), fuse,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(rc, lib, "stencil_fused_error_string", "stencil_fused")
    stencil_fused.launches += 1
    return out


stencil_fused.launches = 0


def stencil_resident(x2: torch.Tensor, plan: StencilPlan, channels: int,
                     reps: int, rows_real: Optional[int] = None,
                     frame=None) -> torch.Tensor:
    """K2: all ``reps`` (>= 1) of the flat (rows, W*C) uint8 image in one
    cooperative launch over two ping-pong buffers. CPU tensors run
    :func:`stencil_resident_plain`."""
    _check_input(x2)
    if reps < 1:
        raise ValueError(f"the resident kernel runs >= 1 rep, got {reps}")
    rows_real = x2.shape[0] if rows_real is None else rows_real
    if x2.device.type == "cpu":
        return stencil_resident_plain(x2, plan, channels, reps, rows_real,
                                      frame)
    lib = _resident_lib()
    _check_cuda(x2)
    bufs = (torch.empty_like(x2), torch.empty_like(x2))
    params = _params(plan)
    geom = _geometry(x2, channels, rows_real, frame, DEFAULT_BLOCK_H)
    with torch.cuda.device(x2.device):
        rc = lib.stencil_resident_launch(
            x2.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            ctypes.addressof(params), ctypes.addressof(geom), reps,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(rc, lib, "stencil_resident_error_string", "stencil_resident")
    stencil_resident.launches += 1
    return bufs[(reps - 1) % 2]


stencil_resident.launches = 0


def stencil_valid(ext2: torch.Tensor, plan: StencilPlan, channels: int,
                  fuse: int, row0: int, col0: int,
                  global_shape: Tuple[int, int],
                  block_h: int = DEFAULT_BLOCK_H,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: ``fuse`` reps of the flat ghost-extended shard tile ``ext2``
    ((th + 2g, (tw + 2g) * C) uint8, g = fuse * halo) into the (th, tw * C)
    interior ``out`` (allocated when None). ``row0``/``col0``: the global
    row and flat lane of the interior's origin; ``global_shape``: the
    padded global (rows, cols * C). CPU tensors run
    :func:`stencil_valid_plain`."""
    _check_input(ext2)
    g = fuse * plan.halo
    th = ext2.shape[0] - 2 * g
    twc = ext2.shape[1] - 2 * g * channels
    if th < 1 or twc < 1:
        raise ValueError(
            f"ext tile {tuple(ext2.shape)} leaves no interior inside its "
            f"{g}-wide ghost band"
        )
    if ext2.device.type == "cpu":
        res = stencil_valid_plain(ext2, plan, channels, fuse, row0, col0,
                                  global_shape)
        return res if out is None else out.copy_(res)
    lib = _valid_lib()
    if out is None:
        out = torch.empty((th, twc), dtype=torch.uint8, device=ext2.device)
    _check_cuda(ext2, out)
    _check_input(out)
    if tuple(out.shape) != (th, twc):
        raise ValueError(f"out must be ({th}, {twc}), got {tuple(out.shape)}")
    params = _params(plan)
    geom = _ValidGeometry(ext2.shape[0], ext2.shape[1], th, twc, channels,
                          row0, col0, global_shape[0], global_shape[1],
                          block_h, TILE_W)
    with torch.cuda.device(ext2.device):
        rc = lib.stencil_valid_launch(
            ext2.data_ptr(), out.data_ptr(), ctypes.addressof(params),
            ctypes.addressof(geom), fuse,
            torch.cuda.current_stream(ext2.device).cuda_stream,
        )
    _raise_on(rc, lib, "stencil_valid_error_string", "stencil_valid")
    stencil_valid.launches += 1
    return out


stencil_valid.launches = 0


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters, by kernel name."""
    return {"stencil_fused": stencil_fused.launches,
            "stencil_resident": stencil_resident.launches,
            "stencil_valid": stencil_valid.launches}


def reset_launch_counts() -> None:
    stencil_fused.launches = 0
    stencil_resident.launches = 0
    stencil_valid.launches = 0


# ---------------------------------------------------------------------------
# Drivers: the JAX package's iterate / iterate_frames / padded_step
# ---------------------------------------------------------------------------


def _run_rep_loop(x2: torch.Tensor, repetitions: int, plan: StencilPlan,
                  rows_real: int, channels: int, block_h: Optional[int],
                  fuse: Optional[int], schedule: Optional[str],
                  frame=None) -> torch.Tensor:
    """Run ``repetitions`` on the flat (rows, W*C) image: K2 for an
    unforced 'deep' run that :func:`resident_feasible` admits, else K1 as
    fused launches plus single-rep remainders over two ping-pong
    buffers."""
    rows, wc = x2.shape
    sched = check_schedule(schedule)
    if repetitions == 0:
        return x2.clone()
    if (sched == DEEP and block_h is None and fuse is None
            and resident_feasible(plan, rows, wc, channels, x2.device)):
        return stencil_resident(x2, plan, channels, repetitions, rows_real,
                                frame)
    bh, fz = effective_geometry(plan, rows, channels, block_h, fuse,
                                schedule=sched)
    depths = launch_schedule(repetitions, fz)
    bufs = [torch.empty_like(x2) for _ in range(min(2, len(depths)))]
    cur = x2
    for i, depth in enumerate(depths):
        cur = stencil_fused(cur, plan, channels, depth, rows_real, frame,
                            block_h=bh, out=bufs[i % 2])
    return cur


def iterate(img_u8: torch.Tensor, repetitions: int, plan: StencilPlan,
            block_h: Optional[int] = None, fuse: Optional[int] = None,
            schedule: Optional[str] = None) -> torch.Tensor:
    """Apply the stencil ``repetitions`` times to an (H, W[, C]) uint8
    image through the kernels. Plans the kernels do not take run the
    torch-ops step instead (callers report that as xla)."""
    shape = img_u8.shape
    hh, w = shape[0], shape[1]
    channels = shape[2] if img_u8.dim() == 3 else 1
    if not plan_supported(plan, channels):
        return _lowering.iterate(img_u8, repetitions, plan)
    x2 = img_u8.contiguous().reshape(hh, w * channels)
    out = _run_rep_loop(x2, repetitions, plan, hh, channels, block_h, fuse,
                        schedule)
    return out.reshape(shape)


def iterate_frames(imgs_u8: torch.Tensor, repetitions: int,
                   plan: StencilPlan, block_h: Optional[int] = None,
                   fuse: Optional[int] = None,
                   schedule: Optional[str] = None) -> torch.Tensor:
    """Apply the stencil to N independent frames ``(N, H, W[, C])`` as ONE
    tall image: frames stacked with ``halo`` zero gap rows, the gaps
    re-zeroed every rep, so blur never crosses frames."""
    shape = imgs_u8.shape
    n, hh, w = shape[0], shape[1], shape[2]
    channels = shape[3] if imgs_u8.dim() == 4 else 1
    wc = w * channels
    if not plan_supported(plan, channels):
        return _lowering.iterate_frames(imgs_u8, repetitions, plan)
    gap = plan.halo
    stride = frames_stride(plan, hh)
    frame = (stride, hh) if gap else None
    x = imgs_u8.contiguous().reshape(n, hh, wc)
    if gap:
        x = torch.cat([x, torch.zeros((n, gap, wc), dtype=x.dtype,
                                      device=x.device)], 1)
    x2 = x.reshape(n * stride, wc)
    rows_real = n * stride - gap  # the tail gap doubles as bottom pad
    out = _run_rep_loop(x2, repetitions, plan, rows_real, channels, block_h,
                        fuse, schedule, frame=frame)
    return out.reshape(n, stride, wc)[:, :hh, :].reshape(shape)


def padded_step(img_u8: torch.Tensor, plan: StencilPlan) -> torch.Tensor:
    """Single-step API matching :func:`lowering.padded_step` (zero
    boundary)."""
    return iterate(img_u8, 1, plan)


def valid_fused(ext2: torch.Tensor, plan: StencilPlan, fuse: int,
                channels: int, row0: int, col0: int,
                global_shape: Tuple[int, int],
                block_h: Optional[int] = None) -> torch.Tensor:
    """The JAX package's ``valid_fused``: ``fuse`` reps of a ghost-extended
    flat shard tile through K3, at the tile height :func:`valid_geometry`
    picks for its interior (``block_h`` forces one)."""
    th = ext2.shape[0] - 2 * fuse * plan.halo
    bh, _ = valid_geometry(plan, th, channels, fuse, block_h)
    return stencil_valid(ext2, plan, channels, fuse, row0, col0,
                         global_shape, block_h=bh)
