"""The hand-written CUDA stencil kernels: wrappers, plain versions, geometry.

Two kernels carry the main path, each the Hopper counterpart of a TPU
kernel of the JAX package's ``ops/pallas_stencil.py``:

* **K1** :func:`stencil_fused` (``csrc/stencil_fused.cu``, replaces
  ``_sep_kernel``): ``fuse`` reps per trip through device memory, one tile
  per block with its ghost bands: in registers under K1's own ``regs``
  and ``regs_direct`` bodies (:func:`regs_geometry`'s tile), else
  ``block_h`` rows by :data:`TILE_W` flat lanes in shared memory.
  :func:`iterate` runs ``reps // fuse`` fused launches, then ``reps %
  fuse`` single-rep launches, ping-ponging two uint8 buffers.
* **K2** :func:`stencil_resident` (``csrc/stencil_resident.cu``, replaces
  ``_resident_kernel``): the whole rep loop in one cooperative launch, a
  persistent grid striding over K1's tiles and running ``fuse`` reps of
  each per grid-wide sync (:func:`resident_geometry`) over two ping-pong
  buffers, for ``schedule='deep'`` when both buffers fit the L2 budget
  (:func:`resident_feasible`).

One kernel carries the sharded path (:mod:`tpu_stencil_torch.parallel.
sharded`):

* **K3** :func:`stencil_valid` (``csrc/stencil_valid.cu``, replaces
  ``_valid_kernel``; :func:`valid_fused` is the JAX package's entry):
  ``fuse`` reps of one shard's ghost-extended tile, re-zeroing only the
  pixels outside the global padded extent, returning the interior. Its
  input and output may be windows of larger arrays, a row pitch each: the
  overlap schedules (:mod:`tpu_stencil_torch.parallel.overlap`) run it on
  thin border bands in place.

Each wrapper takes its plain PyTorch version (int32 shifted slices, the
same function) only for a tensor on the CPU. For a CUDA tensor it launches
its kernel or raises; nothing falls back. ``stencil_fused.launches``,
``stencil_resident.launches`` and ``stencil_valid.launches`` count the
launches and nothing else, under one lock (the stream engine launches from
one thread per lane); ``stencil_fused.body_launches`` counts K1's by the
body they ran (:func:`body_launch_counts`), and ``stencil_fused.body_reps``
the reps those launches ran (:func:`body_rep_counts`).

The image is viewed flat as ``(rows, W*C)``: a column-pass tap moves by
``C`` flat lanes, so channels never mix, and the column boundary is the
flat range ``[0, W*C)``. Every rep re-zeroes pixels outside the image —
rows outside ``[0, rows_real)`` and, in the frames layout, the gap rows
``row % stride >= frame_h`` — as the TPU kernels' ``_row_keep`` does.

K1, K2 and K3 share one tile (``csrc/stencil_tile.cuh``) whose rep body
is chosen per plan by :func:`tile_body`: ``swar`` (rows 2q and 2q+1 as two
16-bit fields of one 32-bit word, 4 bytes of shared memory per element),
``acc16`` (an int16 rows-pass intermediate, 3 bytes) or ``int32`` (5
bytes, every plan). K1 has two register bodies of its own
(``csrc/stencil_regs.cuh``): ``regs`` (``swar``'s packing with the tile
and both passes in registers, neighbour lanes by warp shuffle) for the
binomial plans, and ``regs_direct`` (the same layout, 3x3 taps on packed
words, an exact finish per field) for the non-negative 3x3 direct plans
(:func:`regs_direct_ok`), which :func:`fused_body` picks from the plan
alone. Each body is its own kernel instance in the library; the wrapper
passes the body's index and nothing substitutes another body.

K1's launch is decided in one place, :func:`k1_launch`: a cached, frozen
:class:`K1Launch` of its body, tile, fuse, grid and C structs.
:func:`rep_loop` names a rep loop's kernel and K1's depths and records;
every other reader (the launch, driver, model, autotuner, roofline and
tools) takes its answer from those.

Geometry is re-derived for Hopper: the TPU's 16 MiB VMEM budget becomes
the 227 KB of shared memory a block may use (the ghost band must fit the
tile's shared memory, counted per body by :func:`tile_smem_bytes`) and,
for the resident kernel, a share of the L2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from tpu_stencil_torch.config import PALLAS_SCHEDULES
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.ops.lowering import StencilPlan

DEFAULT_BLOCK_H = 32      # output rows per tile (8-row aligned)
DEFAULT_FUSE = 8          # reps per trip through device memory
TILE_W = 256              # output flat lanes per tile
MAX_THREADS = 512         # threads per block at most (STENCIL_MAX_THREADS)
MAX_K = 15                # filter sizes the kernels take (STENCIL_MAX_K)
# Shared memory one block may use on an H100 (227 KB, opt-in above 48 KB).
SMEM_LIMIT = 232448
# L2 of an H100 (50 MB) and its SM count, used where no card is queried
# (the CPU path).
H100_L2_BYTES = 50 * 2 ** 20
H100_SMS = 132
# Share of the L2 the resident kernel's two buffers may take.
RESIDENT_L2_SHARE = 0.75
# The tile heights K2 chooses from (resident_geometry): multiples of 8
# from K1's default to twice it.
RESIDENT_BLOCK_HS = (32, 40, 48, 56, 64)
# Shared memory and threads one SM holds, and the shared memory the card
# reserves per block.
SM_SMEM = 233472
SM_THREADS = 2048
SMEM_PER_BLOCK_RESERVED = 1024
# Deep trapezoid depths, deepest first (as the JAX package's).
DEEP_FUSE_CANDIDATES = (64, 48, 40, 32, 24, 16, 12, 8)

FUSED = "fused"   # the reported schedule of every K1 run
DEEP = "deep"

# The tile bodies of K1, K2 and K3, by their index in
# csrc/stencil_tile.cuh (STENCIL_BODY_*).
BODIES = ("int32", "acc16", "swar")
# K1's register bodies (csrc/stencil_regs.cuh): ``regs`` for binomial
# separable plans (STENCIL_BODY_REGS) and ``regs_direct`` for non-negative
# 3x3 direct plans (STENCIL_BODY_REGS_DIRECT); K1's bodies by index.
REGS = "regs"
REGS_DIRECT = "regs_direct"
REGS_BODIES = (REGS, REGS_DIRECT)
K1_BODIES = BODIES + REGS_BODIES
assert K1_BODIES.index(REGS) == _build.REGS_BODY
# Its register tile (STENCIL_REGS_*, stencil_regs_q): flat lanes a thread
# holds, row pairs a thread holds by filter size (the filter sizes it is
# built for), the warps a block stacks, the lane alignment of a block's
# origin and tile width, the channel counts it is built for.
REGS_V = 8
REGS_Q = {3: 8, 5: 6}
REGS_KS = tuple(REGS_Q)
REGS_WARPS = 8
REGS_ALIGN = 8
REGS_CHANNELS = (1, 3)
# Row pairs a thread holds in ``regs_direct`` (STENCIL_REGS_DIRECT_Q).
REGS_DIRECT_Q = 8
# A packed word's field: the direct body's sums stay below it.
FIELD = 2 ** 16

class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (the C entry returned a cudaError_t).
    ``code`` is that cudaError_t (None when there was none), so a caller
    matches on the code and not on the message."""

    def __init__(self, msg: str, code: Optional[int] = None) -> None:
        super().__init__(msg)
        self.code = code


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


def acc16_ok(plan: StencilPlan) -> bool:
    """The rows-pass intermediate fits int16: a separable plan with
    non-negative taps and ``255 * sum(row_taps) < 2^15``."""
    if plan.kind != "sep_int":
        return False
    nonneg = all(t >= 0 for t in plan.row_taps + plan.col_taps)
    return nonneg and 255 * sum(plan.row_taps) < 2 ** 15


def swar_ok(plan: StencilPlan) -> bool:
    """Two 16-bit fields per word never carry into each other: a separable
    plan that shifts by at most 8 and needs no clip (non-negative taps of
    total weight 2^shift, so every intermediate is < 2^16)."""
    return (plan.kind == "sep_int" and plan.shift is not None
            and plan.shift <= 8 and not clip_needed(plan))


def tile_body(plan: StencilPlan) -> str:
    """The rep body K1 and K3 run ``plan`` with, from the plan alone:
    ``swar`` where :func:`swar_ok` holds, else ``acc16`` where
    :func:`acc16_ok` holds, else ``int32``."""
    if swar_ok(plan):
        return "swar"
    if acc16_ok(plan):
        return "acc16"
    return "int32"


def _binomial(taps) -> bool:
    """Whether ``taps`` are the binomial row of their size (1 2 1, ...)."""
    k = len(taps)
    return tuple(taps) == tuple(math.comb(k - 1, i) for i in range(k))


def _direct_taps(plan: StencilPlan) -> Tuple[int, ...]:
    """A direct plan's taps, row-major, as integers."""
    return tuple(int(t) for row in plan.taps for t in row)


def regs_direct_ok(plan: StencilPlan) -> bool:
    """``regs_direct`` computes ``plan`` exactly: a 3x3 ``direct_int`` plan
    whose taps are all >= 0 with ``255 * sum(taps) < 2^16`` (no packed
    field carries into the next) and that needs no clip, ``255 *
    sum(taps) / divisor < 256`` (the float32 divisor; a power of two on a
    dyadic plan) (``stencil_regs_direct_runs``)."""
    if plan.kind != "direct_int" or plan.k != 3:
        return False
    taps = _direct_taps(plan)
    total = sum(taps)
    return (min(taps) >= 0 and 255 * total < FIELD
            and 255.0 * total < 256.0 * ctypes.c_float(plan.divisor).value)


@functools.lru_cache(maxsize=256)
def direct_divide(plan: StencilPlan) -> Optional[Tuple[int, int]]:
    """(M, S) such that ``(s * M) >> S`` equals ``min(255, trunc(
    float32(s) / float32(divisor)))`` for every sum ``s`` the plan can
    make, ``[0, 255 * sum(taps)]``: the smallest S in 1..32 whose ``M =
    ceil(2^S / divisor)`` passes that exhaustive check, with ``M < 2^S``
    so that the kernel's ``__umulhi(s, M << (32 - S))`` computes it (on a
    dyadic plan, ``M = 1`` and ``S`` its shift). None for a plan
    ``regs_direct`` does not run, or where no (M, S) passes (the body then
    divides per field with ``__fdiv_rn``). Proven once per plan on the
    host."""
    if not regs_direct_ok(plan):
        return None
    s = torch.arange(255 * sum(_direct_taps(plan)) + 1, dtype=torch.int64)
    want = torch.clamp(torch.trunc(_lowering.divide_f32(
        s.to(torch.float32), plan.divisor)), 0, 255).to(torch.int64)
    for shift in range(1, 33):
        mul = math.ceil(2 ** shift / plan.divisor)
        if mul < 2 ** shift and torch.equal((s * mul) >> shift, want):
            return mul, shift
    return None


@functools.lru_cache(maxsize=256)
def fused_body(plan: StencilPlan) -> str:
    """The body K1 runs ``plan`` with, from the plan alone: ``regs`` for a
    :func:`swar_ok` plan with binomial taps of a size the body is built
    for (:data:`REGS_KS`) in both passes, gaussian and gaussian5;
    ``regs_direct`` where :func:`regs_direct_ok` holds (edge); else
    :func:`tile_body`'s. K2 and K3 run :func:`tile_body`'s."""
    if (swar_ok(plan) and plan.k in REGS_KS and _binomial(plan.row_taps)
            and _binomial(plan.col_taps)):
        return REGS
    if regs_direct_ok(plan):
        return REGS_DIRECT
    return tile_body(plan)


def regs_q(plan: StencilPlan) -> Optional[int]:
    """Row pairs a thread holds in the register body :func:`fused_body`
    names (``regs``: by filter size; ``regs_direct``:
    :data:`REGS_DIRECT_Q`); None for a plan neither runs."""
    body = fused_body(plan)
    if body == REGS_DIRECT:
        return REGS_DIRECT_Q
    return REGS_Q[plan.k] if body == REGS else None


def regs_left(plan: StencilPlan, channels: int, fuse: int) -> int:
    """Lanes of a ``regs`` block's left ghost band (``stencil_regs_left``):
    ``fuse * halo * C`` rounded up to :data:`REGS_ALIGN`."""
    gc = fuse * plan.halo * channels
    return -(-gc // REGS_ALIGN) * REGS_ALIGN


@functools.lru_cache(maxsize=1024)
def regs_geometry(plan: StencilPlan, channels: int,
                  fuse: int) -> Optional[Tuple[int, int, int]]:
    """(tile_h, tile_w, warps) of a ``regs`` or ``regs_direct`` launch at
    ``fuse`` reps: the output tile that the ghost bands (``fuse * halo``
    rows and ``fuse * halo * C`` lanes per side, the left one
    :func:`regs_left`'s) leave of the register extent (:data:`REGS_WARPS`
    warps of ``2 * regs_q(plan)`` rows by ``32 * REGS_V`` lanes),
    ``tile_w`` cut to whole :data:`REGS_ALIGN` lanes
    (``stencil_regs_tile_fits``). None where that leaves no tile, or for a
    plan neither body is built for."""
    q = regs_q(plan)
    if q is None:
        return None
    gr = fuse * plan.halo
    tile_w = ((32 * REGS_V - regs_left(plan, channels, fuse) - gr * channels)
              // REGS_ALIGN * REGS_ALIGN)
    tile_h = REGS_WARPS * 2 * q - 2 * gr
    if fuse < 1 or tile_w < REGS_ALIGN or tile_h < 1:
        return None
    return tile_h, tile_w, REGS_WARPS


def regs_smem_bytes() -> int:
    """Shared memory of a ``regs`` block (``stencil_regs_smem``): two
    buffers of each warp's first and last pair row."""
    return 2 * REGS_WARPS * 2 * 32 * REGS_V * 4


def regs_grid(plan: StencilPlan, channels: int, fuse: int, rows: int,
              wc: int) -> int:
    """Blocks of a ``regs`` or ``regs_direct`` launch at ``fuse`` reps on a
    flat (rows, wc) image (:func:`regs_geometry`'s tiles)."""
    tile_h, tile_w, _ = regs_geometry(plan, channels, fuse)
    return -(-rows // tile_h) * -(-wc // tile_w)


def tile_smem_bytes(plan: StencilPlan, block_h: int, fuse: int,
                    channels: int, tile_w: int = TILE_W,
                    body: Optional[str] = None) -> int:
    """Shared memory of one K1/K3 tile of ``body`` (default
    :func:`tile_body`) over the tile and its ghost bands, R x L elements
    (``stencil_tile_smem``): 5 bytes per element under ``int32`` (uint8
    carry, int32 intermediate), 3 under ``acc16``, and under ``swar`` one
    32-bit word per row pair for the carry (plus a zero pad pair at each
    end) and one for the intermediate."""
    body = tile_body(plan) if body is None else body
    g = fuse * plan.halo
    rr = block_h + 2 * g
    ll = tile_w + 2 * g * channels
    if body == "swar":
        return ((rr // 2 + 2) + rr // 2) * ll * 4
    return rr * ll * (3 if body == "acc16" else 5)


def block_threads(plan: StencilPlan, fuse: int, channels: int,
                  tile_w: int = TILE_W) -> int:
    """Threads per block of a K1/K2/K3 launch (``stencil_block_threads``):
    one per flat lane of the tile and its ghost bands, in whole warps, at
    most :data:`MAX_THREADS`."""
    lanes = tile_w + 2 * fuse * plan.halo * channels
    return min(-(-lanes // 32) * 32, MAX_THREADS)


def plan_supported(plan: StencilPlan, channels: int) -> bool:
    """Whether the kernels run this plan: an integer plan of at most
    :data:`MAX_K` taps whose single-rep ghost band fits shared memory at
    the smallest tile in the largest body (``int32``). Other plans run
    torch ops (reported as xla)."""
    return (
        plan.kind in ("sep_int", "direct_int")
        and plan.k <= MAX_K
        and tile_smem_bytes(plan, 8, 1, channels, body="int32") <= SMEM_LIMIT
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
                      block_h: Optional[int] = None,
                      body: Optional[str] = None) -> int:
    """The tile height a launch uses: 8-row aligned (so even, as ``swar``
    needs), clamped to the padded image height and to what fits shared
    memory at fuse 1 in ``body`` (default :func:`tile_body`)."""
    bh = DEFAULT_BLOCK_H if block_h is None else block_h
    bh = min(-(-bh // 8) * 8, -(-n_rows // 8) * 8)
    while bh > 8 and tile_smem_bytes(plan, bh, 1, channels,
                                     body=body) > SMEM_LIMIT:
        bh -= 8
    assert bh % 2 == 0, bh
    return bh


def deep_fuse_for(plan: StencilPlan, block_h: int, channels: int,
                  body: Optional[str] = None) -> int:
    """The depth 'deep' runs K1 at when the resident kernel does not run:
    the deepest :data:`DEEP_FUSE_CANDIDATES` entry whose ghost recompute
    stays <= 50% of the tile (``2*depth*halo <= block_h/2``) and whose tile
    fits shared memory in ``body``; shallower depths when none does."""
    if not plan.halo:
        return DEEP_FUSE_CANDIDATES[0]
    cap = max(1, block_h // (4 * plan.halo))
    for cand in DEEP_FUSE_CANDIDATES + (min(DEFAULT_FUSE, cap), 4, 2, 1):
        if cand <= cap and tile_smem_bytes(plan, block_h, cand, channels,
                                           body=body) <= SMEM_LIMIT:
            return cand
    return 1


def effective_geometry(plan: StencilPlan, n_rows: int, channels: int,
                       block_h: Optional[int] = None,
                       fuse: Optional[int] = None,
                       schedule: Optional[str] = None,
                       body: Optional[str] = None) -> Tuple[int, int]:
    """The (block_h, fuse) K1 launches with for an ``n_rows``-tall image:
    the aligned/clamped tile height, and fuse clamped to
    ``block_h / (2*halo)`` and to shared memory in ``body`` (default
    :func:`tile_body`, the body K1 runs). ``None`` = defaults, except that
    an unforced fuse under ``schedule='deep'`` is :func:`deep_fuse_for`'s
    depth."""
    bh = effective_block_h(plan, n_rows, channels, block_h, body)
    if fuse is None and schedule == DEEP:
        fz = deep_fuse_for(plan, bh, channels, body)
    else:
        fz = DEFAULT_FUSE if fuse is None else fuse
    if plan.halo:
        fz = max(1, min(fz, bh // (2 * plan.halo)))
    while fz > 1 and tile_smem_bytes(plan, bh, fz, channels,
                                     body=body) > SMEM_LIMIT:
        fz -= 1
    return bh, fz


def valid_geometry(plan: StencilPlan, th: int, channels: int, fuse: int,
                   block_h: Optional[int] = None) -> Tuple[int, int]:
    """The (block_h, fuse) K3 launches with on a ``th``-row interior:
    K1's aligned and clamped tile height, cut until the tile and its
    ``fuse * halo`` ghost band fit shared memory in the plan's body; then
    ``fuse`` cut where even 8 rows do not fit. The sharded runner takes the
    fuse from here (it sets the exchange width), :func:`valid_fused` the
    tile height."""
    bh = effective_block_h(plan, th, channels, block_h)
    while bh > 8 and tile_smem_bytes(plan, bh, fuse, channels) > SMEM_LIMIT:
        bh -= 8
    while fuse > 1 and tile_smem_bytes(plan, bh, fuse, channels) > SMEM_LIMIT:
        fuse -= 1
    assert bh % 2 == 0, bh
    return bh, fuse


def launch_schedule(repetitions: int, fuse: int) -> List[int]:
    """The rep depth of each K1 launch: ``reps // fuse`` fused launches,
    then ``reps % fuse`` single-rep launches."""
    if fuse <= 1:
        return [1] * repetitions
    return [fuse] * (repetitions // fuse) + [1] * (repetitions % fuse)


def device_caps(device: Optional[torch.device]) -> Tuple[int, int, bool]:
    """(L2 bytes, SM count, cooperative launch supported) of ``device``;
    an H100's where the device is not a CUDA card (the CPU path)."""
    if device is None or torch.device(device).type != "cuda":
        return H100_L2_BYTES, H100_SMS, True
    return _card_caps(torch.device(device))


@functools.lru_cache(maxsize=None)
def _card_caps(device: torch.device) -> Tuple[int, int, bool]:
    """:func:`device_caps` of a card, queried once per device (K2's path
    asks before every launch, and the answer does not change)."""
    props = torch.cuda.get_device_properties(device)
    with torch.cuda.device(device):
        coop = _resident_lib().stencil_resident_cooperative()
    if coop < 0:
        raise KernelLaunchError(
            f"cooperative-launch query failed: cudaError_t {-coop}", -coop
        )
    return (int(props.L2_cache_size), int(props.multi_processor_count),
            bool(coop))


def sm_count(device: Optional[torch.device]) -> int:
    """SMs of ``device``; an H100's where it is not a CUDA card (the CPU
    path). Unlike :func:`device_caps`, loads no kernel library: K1's
    launches ask it."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SMS
    return _card_sms(torch.device(device))


@functools.lru_cache(maxsize=None)
def _card_sms(device: torch.device) -> int:
    return int(torch.cuda.get_device_properties(device).multi_processor_count)


@functools.lru_cache(maxsize=256)
def resident_geometry(plan: StencilPlan, n_rows: int, wc: int,
                      channels: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """The (block_h, fuse) K2 launches with on an n_rows x wc image over
    ``sms`` SMs: K1's tile at :data:`DEFAULT_FUSE` reps per grid sync,
    clamped as K1 clamps (:func:`effective_geometry`), at the height of
    :data:`RESIDENT_BLOCK_HS` whose grid sync the model makes shortest,
    among those whose tile leaves two blocks per SM (K1's default height
    when none does). The model: a sync takes as many rounds as the grid
    (blocks per SM times ``sms``) needs to cover the tiles, each round as
    long as one SM takes to run one tile in each of its blocks, a tile's
    work being its reps on the contracting trapezoid. It counts the last,
    partly filled round that the grid sync waits for, which a tile height
    that divides the image into whole rounds saves. Cached: K2's launch
    asks for it every job, and the model takes as long as a short job."""
    best = None
    for bh in RESIDENT_BLOCK_HS:
        geo = effective_geometry(plan, n_rows, channels, bh, DEFAULT_FUSE)
        g = geo[1] * plan.halo
        rr, ll = geo[0] + 2 * g, TILE_W + 2 * g * channels
        threads = block_threads(plan, geo[1], channels)
        per_sm = min(SM_SMEM // (tile_smem_bytes(plan, *geo, channels)
                                 + SMEM_PER_BLOCK_RESERVED),
                     SM_THREADS // threads)
        if per_sm < 2:
            continue
        tiles = -(-n_rows // geo[0]) * -(-wc // TILE_W)
        work = sum((rr - 2 * t * plan.halo) * (ll - 2 * t * plan.halo
                                               * channels)
                   for t in range(1, geo[1] + 1))
        cost = -(-tiles // (per_sm * sms)) * per_sm * work
        if best is None or cost < best[0]:
            best = (cost, geo)
    if best is None:
        return effective_geometry(plan, n_rows, channels, DEFAULT_BLOCK_H,
                                  DEFAULT_FUSE)
    return best[1]


def resident_feasible(plan: StencilPlan, n_rows: int, wc: int,
                      channels: int, device: Optional[torch.device] = None,
                      l2_bytes: Optional[int] = None) -> bool:
    """Whether K2 runs: a supported plan, a card that supports cooperative
    launch, and both uint8 buffers (``2 * rows * W*C`` bytes) within
    :data:`RESIDENT_L2_SHARE` of the L2 (``l2_bytes`` overrides the
    device's)."""
    if not plan_supported(plan, channels):
        return False
    l2, _, coop = device_caps(device)
    if l2_bytes is not None:
        l2 = l2_bytes
    return coop and 2 * n_rows * wc <= RESIDENT_L2_SHARE * l2


# ---------------------------------------------------------------------------
# K1's launch: one record, decided once
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class K1Launch:
    """One K1 launch of ``fuse`` reps (:func:`k1_launch`): its body, output
    tile, grid (blocks along the lanes, the rows), threads per block,
    dynamic shared memory, and the plan's C parameters."""

    body: str
    tile_h: int
    tile_w: int
    fuse: int
    grid: Tuple[int, int]
    threads: int
    smem_bytes: int
    params: _Params = dataclasses.field(compare=False, repr=False)


@functools.lru_cache(maxsize=1024)
def k1_launch(plan: StencilPlan, rows: int, wc: int, channels: int,
              fuse: int, block_h: Optional[int] = None,
              sms: int = H100_SMS) -> K1Launch:
    """The one place K1's launch is decided: the :class:`K1Launch` of one
    launch of ``fuse`` reps on a flat (rows, wc) image over ``sms`` SMs.
    It runs :func:`fused_body`'s register body (``regs``, ``regs_direct``)
    at :func:`regs_geometry`'s tile where no tile height is forced
    (``block_h``; the register extent sets its own), the channel count is
    one the body is built for, and the ghost bands of ``fuse`` reps leave
    a tile; except that ``regs`` loses a single-rep launch whose grid has
    fewer blocks than the card has SMs: with no ghost rows to recompute,
    ``swar``'s 3-4x more threads a pixel fill the card that ``regs``
    leaves idle (5.4-5.9 against 6.1-8.1 us a launch on an H100 at 1-48
    blocks; from 196 blocks, and at fuse 8 at every size, ``regs`` won).
    ``regs_direct`` keeps such launches: against ``int32`` it read
    9.6-13.6 against 10.3-30.9 us a launch at 1-260 blocks, but for 11.6
    against 10.6 on four 256x256 RGB frames (36 blocks). Every other
    launch runs :func:`tile_body`'s shared tile, ``block_h`` rows (None:
    :func:`effective_block_h`'s) by :data:`TILE_W` lanes."""
    body = fused_body(plan)
    regs = (regs_geometry(plan, channels, fuse) if body in REGS_BODIES
            and block_h is None and channels in REGS_CHANNELS else None)
    if regs and body == REGS and fuse == 1 and regs_grid(
            plan, channels, 1, rows, wc) < sms:
        regs = None
    if regs:
        tile_h, tile_w, warps = regs
        threads, smem = 32 * warps, regs_smem_bytes()
    else:
        body, tile_w = tile_body(plan), TILE_W
        tile_h = block_h or effective_block_h(plan, rows, channels)
        threads = block_threads(plan, fuse, channels)
        smem = tile_smem_bytes(plan, tile_h, fuse, channels, body=body)
    return K1Launch(body, tile_h, tile_w, fuse,
                    (-(-wc // tile_w), -(-rows // tile_h)), threads, smem,
                    _params(plan))


@dataclasses.dataclass(frozen=True)
class RepLoop:
    """A rep loop on a flat (rows, wc) image (:func:`rep_loop`): K2
    ``stencil_resident`` (its geometry its own), or K1 ``stencil_fused`` at
    ``fuse`` reps a fused launch and ``block_h`` (a forced tile height,
    clamped; None: each launch's own), with the records of its fused and
    single-rep launches."""

    kernel: str
    rows: int
    wc: int
    fuse: Optional[int] = None
    block_h: Optional[int] = None
    fused: Optional[K1Launch] = None
    single: Optional[K1Launch] = None

    def launches(self, reps: int) -> List[K1Launch]:
        """K1's launches of a ``reps``-rep call, in order
        (:func:`launch_schedule`)."""
        return [self.fused if d == self.fuse else self.single
                for d in launch_schedule(reps, self.fuse)]


@functools.lru_cache(maxsize=1024)
def k1_loop(plan: StencilPlan, rows: int, wc: int, channels: int,
            block_h: Optional[int], fuse: Optional[int],
            schedule: Optional[str], sms: int = H100_SMS) -> RepLoop:
    """K1's rep loop on a flat (rows, wc) image over ``sms`` SMs: a
    register body at the forced ``fuse`` or :data:`DEFAULT_FUSE`, whatever
    the schedule and the image's height, where :func:`k1_launch` runs one
    at that depth; else the shared tile at :func:`effective_geometry`'s
    (block_h, fuse). ('deep' deepens the shared tile's launches to cut its
    trips through device memory; a ``regs`` rep is cheapest at 8: 5.66 us
    at 1920x2520 RGB on an H100, 6.49 at 12, 7.10 at 16.)"""
    if block_h is None:
        fz = DEFAULT_FUSE if fuse is None else fuse
        fused = k1_launch(plan, rows, wc, channels, fz, None, sms)
        if fused.body not in REGS_BODIES:
            fz = effective_geometry(plan, rows, channels, None, fuse,
                                    schedule=schedule)[1]
            fused = k1_launch(plan, rows, wc, channels, fz, None, sms)
    else:
        block_h, fz = effective_geometry(plan, rows, channels, block_h, fuse,
                                         schedule=schedule)
        fused = k1_launch(plan, rows, wc, channels, fz, block_h, sms)
    return RepLoop("stencil_fused", rows, wc, fz, block_h, fused,
                   k1_launch(plan, rows, wc, channels, 1, block_h, sms))


def rep_loop(plan: StencilPlan, rows: int, wc: int, channels: int,
             block_h: Optional[int], fuse: Optional[int],
             schedule: Optional[str],
             device: Optional[torch.device]) -> RepLoop:
    """The launches of a rep loop on a flat (rows, wc) image: K2 for an
    unforced 'deep' run that :func:`resident_feasible` admits, else K1's
    (:func:`k1_loop`, over the device's SMs)."""
    sched = check_schedule(schedule)
    if (sched == DEEP and block_h is None and fuse is None
            and resident_feasible(plan, rows, wc, channels, device)):
        return RepLoop("stencil_resident", rows, wc)
    return k1_loop(plan, rows, wc, channels, block_h, fuse, sched,
                   sm_count(device))


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
    padded band never reaches the interior. ``ext2`` may be a window of a
    larger array at any row pitch, as K3 takes it."""
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
        ("taps", ctypes.c_int * (MAX_K * MAX_K)), ("div_mul", ctypes.c_uint),
        ("pad", ctypes.c_uint * 3),
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
        ("tile_w", ctypes.c_int), ("src_pitch", ctypes.c_longlong),
        ("dst_pitch", ctypes.c_longlong),
    ]


@functools.lru_cache(maxsize=256)
def _params(plan: StencilPlan) -> _Params:
    """The plan's ``StencilParams``, built once per plan (read-only: every
    launch of the plan passes the same struct)."""
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
        divide = direct_divide(plan)
        if divide is not None:
            mul, shift = divide
            p.div_mul = mul << (32 - shift)  # __umulhi(s, .) = s * M >> S
    return p


def _geometry(x2: torch.Tensor, channels: int, rows_real: int, frame,
              block_h: int, tile_w: int = TILE_W) -> _Geometry:
    stride, frame_h = frame if frame is not None else (0, 0)
    return _Geometry(x2.shape[0], x2.shape[1], rows_real, channels, stride,
                     frame_h, block_h, tile_w)


_P = ctypes.c_void_p


def _bind_tile_lib(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C entries of a tile library (K1 ``stencil_fused`` or K3
    ``stencil_valid``): launch with a body index, the body of the last
    launch, shared memory and resident blocks per SM of a launch."""
    i = ctypes.c_int
    getattr(lib, f"{name}_launch").argtypes = [_P, _P, _P, _P, i, i, _P]
    getattr(lib, f"{name}_launch").restype = i
    getattr(lib, f"{name}_last_body").argtypes = []
    getattr(lib, f"{name}_last_body").restype = i
    getattr(lib, f"{name}_smem").argtypes = [_P, _P, i, i]
    getattr(lib, f"{name}_smem").restype = ctypes.c_longlong
    getattr(lib, f"{name}_occupancy").argtypes = [_P, _P, i, i, _P]
    getattr(lib, f"{name}_occupancy").restype = i
    getattr(lib, f"{name}_error_string").argtypes = [i]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


def _fused_lib() -> ctypes.CDLL:
    return _bind_tile_lib(_build.load("stencil_fused"), "stencil_fused")


def _resident_lib() -> ctypes.CDLL:
    lib = _build.load("stencil_resident")
    i = ctypes.c_int
    lib.stencil_resident_launch.argtypes = [_P, _P, _P, _P, _P, i, i, i, _P]
    lib.stencil_resident_launch.restype = i
    lib.stencil_resident_last_body.argtypes = []
    lib.stencil_resident_last_body.restype = i
    lib.stencil_resident_smem.argtypes = [_P, _P, i, i]
    lib.stencil_resident_smem.restype = ctypes.c_longlong
    lib.stencil_resident_shape.argtypes = [_P, _P, i, i, _P]
    lib.stencil_resident_shape.restype = i
    lib.stencil_resident_cooperative.argtypes = []
    lib.stencil_resident_cooperative.restype = i
    lib.stencil_resident_error_string.argtypes = [i]
    lib.stencil_resident_error_string.restype = ctypes.c_char_p
    return lib


def _valid_lib() -> ctypes.CDLL:
    return _bind_tile_lib(_build.load("stencil_valid"), "stencil_valid")


def _tile_lib(kernel: str) -> ctypes.CDLL:
    return _fused_lib() if kernel == "stencil_fused" else _valid_lib()


def _tile_query(kernel: str, fn: str, plan: StencilPlan, channels: int,
                body: str, tile_h: int, tile_w: int, fuse: int, *extra):
    """(library, result) of the C query ``{kernel}_{fn}`` (kernel:
    stencil_fused or stencil_valid) for one tile of ``body``, ``tile_h``
    rows by ``tile_w`` lanes (K3: :data:`TILE_W`), at ``fuse`` reps."""
    if kernel == "stencil_fused":
        geom = _Geometry(tile_h, tile_w, tile_h, channels, 0, 0, tile_h,
                         tile_w)
    else:
        g = fuse * plan.halo
        geom = _ValidGeometry(tile_h + 2 * g, TILE_W + 2 * g * channels,
                              tile_h, TILE_W, channels, 0, 0, tile_h,
                              TILE_W, tile_h, TILE_W,
                              TILE_W + 2 * g * channels, TILE_W)
    lib = _tile_lib(kernel)
    return lib, getattr(lib, f"{kernel}_{fn}")(
        ctypes.addressof(_params(plan)), ctypes.addressof(geom), fuse,
        K1_BODIES.index(body), *extra)


def kernel_smem_bytes(kernel: str, plan: StencilPlan, block_h: int,
                      fuse: int, channels: int) -> int:
    """What the built library of ``kernel`` says a shared tile of
    :func:`tile_body`'s at (block_h, fuse) takes; :func:`tile_smem_bytes`
    is the host model of it."""
    return int(_tile_query(kernel, "smem", plan, channels, tile_body(plan),
                           block_h, TILE_W, fuse)[1])


def blocks_per_sm(kernel: str, plan: StencilPlan, block_h: int, fuse: int,
                  channels: int, body: Optional[str] = None,
                  tile_w: int = TILE_W) -> int:
    """Resident blocks per SM of ``kernel``'s instance for a tile of
    ``body`` (default :func:`tile_body`), ``block_h`` rows by ``tile_w``
    lanes, at ``fuse`` reps (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    on the current card)."""
    blocks = ctypes.c_int(0)
    lib, rc = _tile_query(kernel, "occupancy", plan, channels,
                          tile_body(plan) if body is None else body, block_h,
                          tile_w, fuse, ctypes.addressof(blocks))
    _raise_on(rc, lib, f"{kernel}_error_string", f"{kernel} occupancy")
    return blocks.value


def instance_attributes(plan: StencilPlan, channels: int,
                        launch: K1Launch) -> Dict[str, int]:
    """Registers a thread and local-memory bytes a thread of the K1
    instance that ``launch`` runs ``plan`` with, as the card reports them
    (cudaFuncGetAttributes): a spill shows as local memory."""
    out = (ctypes.c_int * 2)()
    # declared here, not in _fused_lib: every K1 launch loads the library
    fn = _fused_lib().stencil_fused_attributes
    fn.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    lib, rc = _tile_query("stencil_fused", "attributes", plan, channels,
                          launch.body, launch.tile_h, launch.tile_w,
                          launch.fuse, ctypes.addressof(out))
    _raise_on(rc, lib, "stencil_fused_error_string",
              "stencil_fused attributes")
    return {"registers": out[0], "local_bytes": out[1]}


def ran_body(kernel: str) -> Optional[str]:
    """The body of the last launch of ``kernel`` (stencil_fused,
    stencil_resident or stencil_valid), as its library recorded it; None
    before any."""
    lib = _resident_lib() if kernel == "stencil_resident" else _tile_lib(
        kernel)
    idx = getattr(lib, f"{kernel}_last_body")()
    return K1_BODIES[idx] if idx >= 0 else None


def _resident_query(fn: str, plan: StencilPlan, n_rows: int, wc: int,
                    channels: int, device: torch.device, *extra):
    """(library, (block_h, fuse), result) of the C query
    ``stencil_resident_{fn}`` at K2's geometry for an n_rows x wc image on
    ``device``."""
    bh, fz = resident_geometry(plan, n_rows, wc, channels,
                               device_caps(device)[1])
    geom = _Geometry(n_rows, wc, n_rows, channels, 0, 0, bh, TILE_W)
    params = _params(plan)
    lib = _resident_lib()
    return lib, (bh, fz), getattr(lib, f"stencil_resident_{fn}")(
        ctypes.addressof(params), ctypes.addressof(geom), fz,
        BODIES.index(tile_body(plan)), *extra)


def resident_kernel_smem_bytes(plan: StencilPlan, n_rows: int, wc: int,
                               channels: int, device: torch.device) -> int:
    """What the built K2 library says its launch on ``device`` asks for; at
    K2's geometry the host model is :func:`tile_smem_bytes`."""
    return int(_resident_query("smem", plan, n_rows, wc, channels,
                               device)[2])


def resident_launch_shape(plan: StencilPlan, n_rows: int, wc: int,
                          channels: int, device: torch.device
                          ) -> Dict[str, int]:
    """K2's launch on ``device``: its tile, reps per sync, threads per
    block, resident blocks per SM and grid, as the library computes
    them."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        lib, (bh, fz), rc = _resident_query("shape", plan, n_rows, wc,
                                            channels, device,
                                            ctypes.addressof(out))
    _raise_on(rc, lib, "stencil_resident_error_string",
              "stencil_resident shape")
    return {"block_h": bh, "tile_w": TILE_W, "fuse": fz,
            "smem_bytes": tile_smem_bytes(plan, bh, fz, channels),
            "blocks_per_sm": out[0], "grid": out[1], "threads": out[2]}


def _instance_registers(kernel: str, plan: StencilPlan, body: str,
                        channels: int) -> Optional[dict]:
    """Registers (and spills) of the template instance ``kernel`` runs
    ``plan`` with in ``body``, from its build's ``-Xptxas -v`` lines; None
    when the library was not built here."""
    inst = _build.ptxas_instances(_build.build_log(kernel))
    idx = K1_BODIES.index(body)
    if body == REGS:
        return inst.get((plan.k, idx, channels))
    return inst.get((plan.k, idx)) or inst.get((0, idx))


def describe_launch(kernel: str, plan: StencilPlan, rows: int, wc: int,
                    channels: int, block_h: Optional[int] = None,
                    fuse: Optional[int] = None,
                    device: Optional[torch.device] = None) -> dict:
    """The instance one launch of ``kernel`` runs: K1 ``stencil_fused`` at
    ``fuse`` reps and K2 ``stencil_resident`` on a flat (rows, wc) image,
    K3 ``stencil_valid`` on one tile's (rows, wc) interior at ``fuse``
    reps; ``block_h`` a forced tile height (None: the kernel's own). Its
    body, tile, grid, threads per block and dynamic shared memory (K1's
    from its :class:`K1Launch`, the fused launch of :func:`k1_loop`; K2's
    and K3's from the host model), and on a card its resident blocks per
    SM (the library's occupancy query; K2's grid too) and registers (the
    build's ``-Xptxas -v`` lines; under ``regs_direct``,
    :func:`instance_attributes`'); None for those on the CPU."""
    on_card = device is not None and torch.device(device).type == "cuda"
    if kernel == "stencil_fused":
        k1 = k1_loop(plan, rows, wc, channels, block_h, fuse, None,
                     sm_count(device)).fused
        body, bh, tw, fz, grid, threads, smem = (
            k1.body, k1.tile_h, k1.tile_w, k1.fuse, list(k1.grid),
            k1.threads, k1.smem_bytes)
    else:
        body, tw = tile_body(plan), TILE_W
        if kernel == "stencil_resident":
            bh, fz = resident_geometry(plan, rows, wc, channels,
                                       device_caps(device)[1])
        else:
            bh, fz = valid_geometry(plan, rows, channels, fuse, block_h)
        threads = block_threads(plan, fz, channels)
        smem = tile_smem_bytes(plan, bh, fz, channels)
        # K2's grid is the co-resident blocks, which only the card knows.
        grid = (None if kernel == "stencil_resident"
                else [-(-wc // tw), -(-rows // bh)])
    rec = {"kernel": kernel, "body": body, "block_h": bh, "tile_w": tw,
           "fuse": fz, "grid": grid, "threads": threads, "smem_bytes": smem,
           "blocks_per_sm": None, "registers": None}
    if on_card:
        if kernel == "stencil_resident":
            shape = resident_launch_shape(plan, rows, wc, channels, device)
            rec["grid"] = [shape["grid"]]
            rec["blocks_per_sm"] = shape["blocks_per_sm"]
        else:
            with torch.cuda.device(device):
                rec["blocks_per_sm"] = blocks_per_sm(kernel, plan, bh, fz,
                                                     channels, body, tw)
        if body == REGS_DIRECT:  # its instance is the library's choice
            with torch.cuda.device(device):
                a = instance_attributes(plan, channels, k1)
            regs = {"registers": a["registers"],
                    "spill": f"{a['local_bytes']} bytes local memory"}
        else:
            regs = _instance_registers(kernel, plan, body, channels)
        if regs:
            rec["registers"] = regs.get("registers")
            if regs.get("spill"):
                rec["spill"] = regs["spill"]
    return rec


def build_kernels() -> Dict[str, str]:
    """Build every kernel library (in parallel) and return name -> path."""
    return {n: str(p) for n, p in _build.build().items()}


def _check_input(x2: torch.Tensor) -> None:
    if x2.dtype != torch.uint8 or x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(
            f"expected a contiguous 2-D uint8 tensor, got {x2.dtype} "
            f"{tuple(x2.shape)} contiguous={x2.is_contiguous()}"
        )


def row_pitch(x2: torch.Tensor) -> int:
    """The row pitch of a 2-D window (:func:`_check_window`): its row
    stride, or its width when it has one row (any stride is then one)."""
    return x2.stride(0) if x2.shape[0] > 1 else x2.shape[1]


def _check_window(x2: torch.Tensor) -> None:
    """K3's window form: a 2-D uint8 view whose lanes are unit stride and
    whose rows lie a positive pitch of at least one row apart (a rectangle
    of a larger row-major array)."""
    if (x2.dtype != torch.uint8 or x2.dim() != 2
            or (x2.shape[1] > 1 and x2.stride(1) != 1)
            or (x2.shape[0] > 1 and x2.stride(0) < x2.shape[1])):
        raise ValueError(
            f"expected a 2-D uint8 window with unit lane stride and a row "
            f"pitch of at least its width, got {x2.dtype} "
            f"{tuple(x2.shape)} strides {tuple(x2.stride())}"
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
        raise KernelLaunchError(
            f"{what} launch failed: cudaError_t {rc} ({msg})", rc)


def stencil_fused(x2: torch.Tensor, plan: StencilPlan, channels: int,
                  fuse: int, rows_real: Optional[int] = None, frame=None,
                  block_h: Optional[int] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``fuse`` reps of the flat (rows, W*C) uint8 image ``x2`` into
    ``out`` (allocated when None; must not alias ``x2``), as the
    :class:`K1Launch` of :func:`k1_launch` for this shape, depth and
    forced tile height ``block_h`` runs them (a forced height runs the
    shared tile). ``rows_real``: rows past it lie outside the image;
    ``frame`` = (stride, frame_h) marks the frames layout. CPU tensors run
    :func:`stencil_fused_plain`."""
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
    _launch_k1(lib, x2, out, k1_launch(plan, *x2.shape, channels, fuse,
                                       block_h, sm_count(x2.device)),
               channels, rows_real, frame)
    return out


def _launch_k1(lib, x2: torch.Tensor, out: torch.Tensor, launch: K1Launch,
               channels: int, rows_real: int, frame) -> None:
    """K1's ``launch`` from ``x2`` into ``out`` (checked by the caller),
    counted by body; only its ``StencilGeometry`` is built per call."""
    geom = _geometry(x2, channels, rows_real, frame, launch.tile_h,
                     launch.tile_w)
    with torch.cuda.device(x2.device):
        rc = lib.stencil_fused_launch(
            x2.data_ptr(), out.data_ptr(), ctypes.addressof(launch.params),
            ctypes.addressof(geom), launch.fuse,
            K1_BODIES.index(launch.body),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(rc, lib, "stencil_fused_error_string", "stencil_fused")
    _count(stencil_fused, launch.body, launch.fuse)


stencil_fused.launches = 0
# K1's launches, and the reps they ran, by the body their K1Launch names,
# under the same lock.
stencil_fused.body_launches = {}
stencil_fused.body_reps = {}


def stencil_resident(x2: torch.Tensor, plan: StencilPlan, channels: int,
                     reps: int, rows_real: Optional[int] = None,
                     frame=None, block_h: Optional[int] = None,
                     fuse: Optional[int] = None) -> torch.Tensor:
    """K2: all ``reps`` (>= 1) of the flat (rows, W*C) uint8 image in one
    cooperative launch, in the tile body :func:`tile_body` names for
    ``plan``, over two buffers; returns the one the last step wrote. Tiles
    of ``block_h`` rows, ``fuse`` reps per grid sync (None:
    :func:`resident_geometry`'s; the kernel lab times others). CPU tensors
    run :func:`stencil_resident_plain`."""
    _check_input(x2)
    if reps < 1:
        raise ValueError(f"the resident kernel runs >= 1 rep, got {reps}")
    rows_real = x2.shape[0] if rows_real is None else rows_real
    if x2.device.type == "cpu":
        return stencil_resident_plain(x2, plan, channels, reps, rows_real,
                                      frame)
    lib = _resident_lib()
    _check_cuda(x2)
    out, work = torch.empty_like(x2), torch.empty_like(x2)
    bh, fz = resident_geometry(plan, *x2.shape, channels,
                               device_caps(x2.device)[1])
    bh, fz = bh if block_h is None else block_h, fz if fuse is None else fuse
    params = _params(plan)
    geom = _geometry(x2, channels, rows_real, frame, bh)
    with torch.cuda.device(x2.device):
        rc = lib.stencil_resident_launch(
            x2.data_ptr(), out.data_ptr(), work.data_ptr(),
            ctypes.addressof(params), ctypes.addressof(geom), reps, fz,
            BODIES.index(tile_body(plan)),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(rc, lib, "stencil_resident_error_string", "stencil_resident")
    _count(stencil_resident)
    return out


stencil_resident.launches = 0


def stencil_valid(ext2: torch.Tensor, plan: StencilPlan, channels: int,
                  fuse: int, row0: int, col0: int,
                  global_shape: Tuple[int, int],
                  block_h: int = DEFAULT_BLOCK_H,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: ``fuse`` reps of the flat ghost-extended shard tile ``ext2``
    ((th + 2g, (tw + 2g) * C) uint8, g = fuse * halo) into the (th, tw * C)
    interior ``out`` (allocated when None; a distinct buffer), in the tile
    body :func:`tile_body` names for ``plan``. ``row0``/``col0``: the
    global row and flat lane of the interior's origin; ``global_shape``:
    the padded global (rows, cols * C).

    ``ext2`` and ``out`` may be windows of larger arrays
    (:func:`_check_window`: unit lane stride, any row pitch): a border band
    of an exchanged tile runs in place and writes straight into its
    rectangle of the output tile, as thin as ``g`` rows or ``g * C`` lanes.
    CPU tensors run :func:`stencil_valid_plain`."""
    _check_window(ext2)
    g = fuse * plan.halo
    th = ext2.shape[0] - 2 * g
    twc = ext2.shape[1] - 2 * g * channels
    if th < 1 or twc < 1:
        raise ValueError(
            f"ext tile {tuple(ext2.shape)} leaves no interior inside its "
            f"{g}-wide ghost band"
        )
    if out is not None:
        _check_window(out)
        if tuple(out.shape) != (th, twc):
            raise ValueError(
                f"out must be ({th}, {twc}), got {tuple(out.shape)}")
    if ext2.device.type == "cpu":
        res = stencil_valid_plain(ext2, plan, channels, fuse, row0, col0,
                                  global_shape)
        return res if out is None else out.copy_(res)
    lib = _valid_lib()
    if out is None:
        out = torch.empty((th, twc), dtype=torch.uint8, device=ext2.device)
    _check_cuda(ext2, out)
    if out.data_ptr() == ext2.data_ptr():
        raise ValueError("out must be a distinct buffer from ext2")
    params = _params(plan)
    geom = _ValidGeometry(ext2.shape[0], ext2.shape[1], th, twc, channels,
                          row0, col0, global_shape[0], global_shape[1],
                          block_h, TILE_W, row_pitch(ext2), row_pitch(out))
    with torch.cuda.device(ext2.device):
        rc = lib.stencil_valid_launch(
            ext2.data_ptr(), out.data_ptr(), ctypes.addressof(params),
            ctypes.addressof(geom), fuse, BODIES.index(tile_body(plan)),
            torch.cuda.current_stream(ext2.device).cuda_stream,
        )
    _raise_on(rc, lib, "stencil_valid_error_string", "stencil_valid")
    _count(stencil_valid)
    return out


stencil_valid.launches = 0


_COUNT_LOCK = threading.Lock()


def _count(wrapper, body: Optional[str] = None, reps: int = 0) -> None:
    """One launch of ``wrapper``'s kernel, counted under the lock (a
    read-modify-write of the counter from several threads); K1's also by
    the body it ran, with its ``reps``."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if body is not None:
            wrapper.body_launches[body] = (
                wrapper.body_launches.get(body, 0) + 1)
            wrapper.body_reps[body] = wrapper.body_reps.get(body, 0) + reps


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters, by kernel name."""
    return {"stencil_fused": stencil_fused.launches,
            "stencil_resident": stencil_resident.launches,
            "stencil_valid": stencil_valid.launches}


def body_launch_counts() -> Dict[str, int]:
    """K1's launches by the body they ran (``stencil_fused.body_launches``,
    a copy)."""
    with _COUNT_LOCK:
        return dict(stencil_fused.body_launches)


def body_rep_counts() -> Dict[str, int]:
    """K1's reps by the body whose launches ran them
    (``stencil_fused.body_reps``, a copy)."""
    with _COUNT_LOCK:
        return dict(stencil_fused.body_reps)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        stencil_fused.launches = 0
        stencil_fused.body_launches = {}
        stencil_fused.body_reps = {}
        stencil_resident.launches = 0
        stencil_valid.launches = 0


# ---------------------------------------------------------------------------
# Drivers: the JAX package's iterate / iterate_frames / padded_step
# ---------------------------------------------------------------------------


def warm_depths(calls: Iterable[int], fuse: Optional[int]) -> List[int]:
    """Rep counts, one call of a rep loop each, that between them launch
    every kernel instance that calls of ``calls`` reps launch: for a loop
    of ``fuse`` reps per launch (K1, K3) the fused depth and, where a
    call has a remainder, one rep (:func:`launch_schedule`); for
    ``fuse=None`` (K2's one launch, the torch ops) one rep. Empty when no
    call has a rep. The warm-up before a timed window runs these on a
    scratch copy, on one device and on a mesh alike."""
    depths = set()
    for n in calls:
        if n > 0:
            depths.update(launch_schedule(n, fuse) if fuse else [1])
    return sorted(depths, reverse=True)


def _run_rep_loop(x2: torch.Tensor, repetitions: int, plan: StencilPlan,
                  rows_real: int, channels: int, block_h: Optional[int],
                  fuse: Optional[int], schedule: Optional[str],
                  frame=None) -> torch.Tensor:
    """Run ``repetitions`` on the flat (rows, W*C) image as
    :func:`rep_loop` plans them: K2's one launch, or K1's fused launches
    plus single-rep remainders over two ping-pong buffers, each launch
    :func:`stencil_fused` of its depth at the loop's tile height."""
    rows, wc = x2.shape
    check_schedule(schedule)
    if repetitions == 0:
        return x2.clone()
    loop = rep_loop(plan, rows, wc, channels, block_h, fuse, schedule,
                    x2.device)
    if loop.kernel == "stencil_resident":
        return stencil_resident(x2, plan, channels, repetitions, rows_real,
                                frame)
    depths = launch_schedule(repetitions, loop.fuse)
    bufs = [torch.empty_like(x2) for _ in range(min(2, len(depths)))]
    cur = x2
    for i, depth in enumerate(depths):
        cur = stencil_fused(cur, plan, channels, depth, rows_real, frame,
                            block_h=loop.block_h, out=bufs[i % 2])
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
                block_h: Optional[int] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``valid_fused``: ``fuse`` reps of a ghost-extended
    flat shard tile (or window, :func:`stencil_valid`) through K3, into
    ``out`` when given, at the tile height :func:`valid_geometry` picks for
    its interior (``block_h`` forces one)."""
    th = ext2.shape[0] - 2 * fuse * plan.halo
    bh, _ = valid_geometry(plan, th, channels, fuse, block_h)
    return stencil_valid(ext2, plan, channels, fuse, row0, col0,
                         global_shape, block_h=bh, out=out)
