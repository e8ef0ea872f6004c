"""K1's register bodies ``regs`` and ``regs_direct``: the chooser, the
launch geometry, the packed arithmetic as the bodies compute it, the
direct body's finish, and the per-body launch counter.

``cuda_stencil.fused_body`` gives gaussian and gaussian5 (binomial taps of
size 3 and 5, which ``swar_ok`` admits) the ``regs`` body, the
non-negative 3x3 direct plans that need no clip and whose sums fit a
16-bit field (edge and its alias soft_blur, and two built here) the
``regs_direct`` body, and every other plan ``tile_body``'s; the
``K1Launch`` record of ``k1_launch`` runs the shared tile where a launch
forces a tile height,
has another channel count, leaves the register body no tile, or, under
``regs``, is a single rep whose grid has fewer blocks than the card has
SMs. The kernels
run only on the card (``chip_smoke.py`` phase ``k1`` holds them byte for
byte against the plain version). Here ``lab.regs_fused_plain`` computes
one launch as the body does, block by block over its register extent,
reading garbage past the extent as the kernel reads wrong values there,
and is held against the plain version and the JAX package's Pallas
kernels in interpret mode. The direct body's multiply-high finish is
proven here over every sum a plan can make. Tolerance: exact byte
equality (integer plans).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil.ops import pallas_stencil
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.ops import lowering as tlowering

torch.set_num_threads(1)

REGS_FILTERS = ("gaussian", "gaussian5")
# Non-negative 3x3 direct plans built here (taps, divisor), beside edge: a
# mirror-symmetric one and an asymmetric one, both on the divide path.
BUILT = {"sym13": ([[1, 2, 1], [2, 1, 2], [1, 2, 1]], 13.0),
         "asym17": ([[1, 2, 0], [3, 4, 1], [0, 3, 2]], 17.0)}
DIRECT_FILTERS = ("edge",) + tuple(BUILT)
OTHER_FILTERS = ("identity", "box", "soft_blur", "gaussian7", "gaussian9",
                 "gaussian15")
BODY_FILTERS = REGS_FILTERS + DIRECT_FILTERS
# (rows, W*C) of the cells (1920x2520 RGB, 1920x5040 grey), ragged widths
# and heights, and a small image.
SHAPES = {3: [(2520, 5760), (2519, 5763), (37, 87)],
          1: [(5040, 1920), (5041, 1917), (37, 29)]}


def _plan(name):
    if name in BUILT:
        return _direct(*BUILT[name])
    return tlowering.plan_filter(tfilters.get_filter(name))


def _direct(taps, divisor):
    return tlowering.plan_filter(tfilters.from_numpy(np.array(taps),
                                                     divisor))


def _plans(name):
    if name in BUILT:
        taps, divisor = BUILT[name]
        jf = jfilters.Filter(np.array(taps, np.float32), divisor)
    else:
        jf = jfilters.get_filter(name)
    return (jlowering.plan_filter(jf), _plan(name))


def _body(name):
    return "regs" if name in REGS_FILTERS else "regs_direct"


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ---------------------------------------------------------------------------
# The chooser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", BODY_FILTERS + OTHER_FILTERS)
def test_k1_chooser_per_filter(name):
    plan = _plan(name)
    want = ("regs" if name in REGS_FILTERS else "regs_direct"
            if name in DIRECT_FILTERS + ("soft_blur",) else cs.tile_body(plan))
    assert cs.fused_body(plan) == want
    if want in cs.REGS_BODIES:
        assert cs.tile_body(plan) != want
    # K2 and K3 keep the shared tile's body
    for kernel, rows in (("stencil_resident", 64), ("stencil_valid", 16)):
        rec = cs.describe_launch(kernel, plan, rows, 96, 3, fuse=2)
        assert rec["body"] == cs.tile_body(plan)


def test_k1_chooser_is_a_function_of_the_plan_alone():
    assert list(inspect.signature(cs.fused_body).parameters) == ["plan"]
    for name in BODY_FILTERS + OTHER_FILTERS:
        a = _plan(name)
        b = tlowering.plan_from_fields(
            {f: getattr(a, f) for f in a.__dataclass_fields__})
        assert cs.fused_body(a) == cs.fused_body(b)
        if a.kind == "direct_int":  # the same taps under no name
            assert cs.fused_body(_direct(a.taps, a.divisor)) == (
                cs.fused_body(a))
    assert cs.K1_BODIES == cs.BODIES + ("regs", "regs_direct")
    assert cs.K1_BODIES.index("regs") == _build.REGS_BODY
    # the C library's index of the direct body
    header = (_build.CSRC / "stencil_regs.cuh").read_text()
    assert "#define STENCIL_BODY_REGS_DIRECT %d\n" % cs.K1_BODIES.index(
        "regs_direct") in header
    # edge and soft_blur: the same plan, the same body
    assert _plan("edge") == _plan("soft_blur")
    # swar plans that are not binomial keep swar
    assert cs.swar_ok(_plan("identity")) and cs.fused_body(
        _plan("identity")) == "swar"


# ---------------------------------------------------------------------------
# regs_direct's gate and its finish
# ---------------------------------------------------------------------------

EDGE = [[1, 4, 1], [4, 8, 4], [1, 4, 1]]


@pytest.mark.parametrize("taps,divisor", [
    ([[1, 4, 1], [4, -8, 4], [1, 4, 1]], 8),      # a negative tap
    ([[1, 4, 1], [4, -2, 4], [1, 4, 1]], 17),     # ... on the divide path
    ([[1, 1, 1, 1, 1]] * 2 + [[1, 1, 2, 1, 1]] + [[1, 1, 1, 1, 1]] * 2,
     26),                                          # k = 5
    (EDGE, 16),          # dyadic, 255 * 28 / 16 > 255: a clip
    (EDGE, 27),          # 255 * 28 / 27 > 255: a clip
    ([[28, 29, 28], [29, 30, 29], [28, 29, 28]], 258),  # 255 * 258 >= 2^16
], ids=["negative-shift", "negative-divide", "k5", "clip-shift",
        "clip-divide", "field"])
def test_direct_plans_outside_the_gate_keep_int32(taps, divisor):
    plan = _direct(taps, divisor)
    assert plan.kind == "direct_int"
    assert not cs.regs_direct_ok(plan)
    assert cs.fused_body(plan) == cs.tile_body(plan) == "int32"
    for c, rows, wc in ((3, 5040, 5760), (1, 5040, 1920)):
        assert cs.k1_launch(plan, rows, wc, c, 8).body == "int32"
        assert cs.k1_loop(plan, rows, wc, c, None, None,
                          None).fused.body == "int32"
    assert cs.regs_geometry(plan, 3, 8) is None
    assert cs._params(plan).div_mul == 0


def test_the_field_bound_admits_2_16_less_1_and_nothing_above():
    # 255 * 257 = 2^16 - 1, the largest sum bound below 2^16; 255 * 258
    # passes it
    at = _direct([[28, 29, 28], [29, 29, 29], [28, 29, 28]], 257)
    assert 255 * 257 == 2 ** 16 - 1 and cs.regs_direct_ok(at)
    assert cs.fused_body(at) == "regs_direct"
    over = _direct([[28, 29, 28], [29, 30, 29], [28, 29, 28]], 258)
    assert 255 * 258 > 2 ** 16 and not cs.regs_direct_ok(over)
    assert cs.FIELD == 2 ** 16


@pytest.mark.parametrize("name", DIRECT_FILTERS)
def test_launch_body_runs_int32_where_regs_direct_cannot(name):
    plan = _plan(name)
    assert cs.k1_launch(plan, 5040, 5760, 3, 8).body == "regs_direct"
    # a forced tile height, a channel count the body is not built for
    assert cs.k1_launch(plan, 5040, 5760, 3, 8, 32).body == "int32"
    assert cs.k1_launch(plan, 5040, 3840, 2, 8).body == "int32"
    assert cs.k1_loop(plan, 5040, 5760, 3, 32, None,
                      None).fused.body == "int32"
    # a single rep on fewer blocks than SMs (serve's canvases) keeps
    # regs_direct, as the same launch on the cell's 960 blocks does
    assert cs.regs_grid(plan, 3, 1, 65, 192) < cs.H100_SMS
    assert cs.k1_launch(plan, 65, 192, 3, 1).body == "regs_direct"
    assert cs.regs_grid(plan, 3, 1, 5040, 5760) == 960
    assert cs.k1_launch(plan, 5040, 5760, 3, 1).body == "regs_direct"
    # a depth whose ghost bands leave no tile
    deep = next(f for f in range(1, 200)
                if cs.regs_geometry(plan, 3, f) is None)
    assert cs.k1_launch(plan, 5040, 5760, 3, deep).body == "int32"
    assert cs.k1_launch(plan, 5040, 5760, 3, deep - 1).body == "regs_direct"


@pytest.mark.parametrize("taps,divisor,want", [
    (EDGE, 28, (9363, 18)),
    ([[1, 1, 0], [1, 2, 1], [0, 1, 2]], 9, None),
    ([[1, 2, 1], [2, 1, 2], [1, 2, 1]], 13, None),
    ([[28, 28, 28], [28, 31, 28], [28, 28, 28]], 255, None),
    ([[28, 29, 28], [29, 29, 29], [28, 29, 28]], 257, None),
    ([[1, 2, 0], [3, 4, 1], [0, 3, 2]], 2.5 * 7, None),
    ([[1, 1, 1], [1, 8, 1], [1, 1, 1]], 16, (1, 4)),   # dyadic: the shift
    ([[0, 1, 0], [0, 0, 0], [0, 0, 1]], 2, (1, 1)),
], ids=["edge-28", "9", "13", "255", "257", "17.5", "dyadic-16",
        "dyadic-2"])
def test_the_multiply_high_equals_the_float32_divide_on_every_sum(
        taps, divisor, want):
    plan = _direct(taps, divisor)
    assert cs.regs_direct_ok(plan)
    mul, shift = cs.direct_divide(plan)
    if want is not None:
        assert (mul, shift) == want
    s = np.arange(255 * int(np.sum(taps)) + 1, dtype=np.int64)
    quotient = np.minimum(255, np.trunc(
        s.astype(np.float32) / np.float32(divisor))).astype(np.int64)
    np.testing.assert_array_equal((s * mul) >> shift, quotient)
    # as the kernel takes it: the high word of s * (M << (32 - S))
    div_mul = cs._params(plan).div_mul
    assert div_mul == mul << (32 - shift) < 2 ** 32
    np.testing.assert_array_equal((s * div_mul) >> 32, quotient)
    assert cs.direct_divide(plan) is cs.direct_divide(plan)  # cached


def test_a_plan_no_multiplier_passes_divides_per_field_in_float32():
    # 253 / 28.111112594604492 lies below 9 but rounds to 9.0 in float32:
    # no multiply-high of the candidates gives 9 there and 8 at 252
    d = 28.111112594604492
    assert np.float32(253) / np.float32(d) == 9 and 253 < 9 * d
    plan = _direct(EDGE, d)
    assert cs.regs_direct_ok(plan) and cs.fused_body(plan) == "regs_direct"
    assert cs.direct_divide(plan) is None
    assert cs._params(plan).div_mul == 0  # the library's divide instance
    x2 = torch.from_numpy(_img((131, 97 * 3), 63))
    for fuse in (1, 8):
        assert torch.equal(lab.regs_fused_plain(x2, plan, 3, fuse),
                           cs.stencil_fused_plain(x2, plan, 3, fuse))


@pytest.mark.parametrize("taps,divisor,mulhi", [
    (EDGE, 28, True),
    ([[1, 2, 1], [2, 3, 2], [0, 1, 0]], 13, True),
    ([[1, 2, 0], [3, 4, 1], [1, 2, 0]], 15, True),
    ([[1, 1, 1], [1, 8, 1], [1, 1, 1]], 16, True),
    ([[1, 2, 0], [3, 4, 1], [0, 3, 2]], 16, True),
    ([[0, 0, 0], [0, 1, 0], [0, 0, 0]], 1, False),
], ids=["edge", "mirror-columns", "mirror-rows", "dyadic", "asymmetric",
        "shift-0"])
def test_the_finish_follows_the_proven_multiplier(taps, divisor, mulhi):
    # The library runs the multiply-high instance where the launch's
    # parameters carry a multiplier, the float32 divide's otherwise; a
    # dyadic plan of shift 0 has no multiplier below 2^32 (plan_filter
    # lowers its one tap to sep_int: built from its fields here).
    plan = _direct(taps, divisor)
    if divisor == 1:
        plan = tlowering.plan_from_fields(
            {**{f: getattr(plan, f) for f in plan.__dataclass_fields__},
             "kind": "direct_int", "taps": tuple(map(tuple, taps)),
             "row_taps": None, "col_taps": None})
    assert cs.fused_body(plan) == "regs_direct"
    assert (cs.direct_divide(plan) is not None) == mulhi
    assert (cs._params(plan).div_mul != 0) == mulhi
    x2 = torch.from_numpy(_img((67, 45 * 3), 64))
    for fuse in (1, 3):
        assert torch.equal(lab.regs_fused_plain(x2, plan, 3, fuse),
                           cs.stencil_fused_plain(x2, plan, 3, fuse))


DIRECT_PTXAS = """\
ptxas info    : Compiling entry function '_Z25stencil_fused_regs_kernelILi3ELi3EEvPKhPh13StencilParams15StencilGeometryiii' for 'sm_90a'
ptxas info    : Used 125 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z32stencil_fused_regs_direct_kernelILi3ELb1ELb1EEvPKhPh13StencilParams15StencilGeometryiii' for 'sm_90a'
ptxas info    : Function properties for _Z32stencil_fused_regs_direct_kernelILi3ELb1ELb1EEvPKhPh13StencilParams15StencilGeometryiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 32768 bytes smem
ptxas info    : Compiling entry function '_Z32stencil_fused_regs_direct_kernelILi1ELb0ELb0EEvPKhPh13StencilParams15StencilGeometryiii' for 'sm_90a'
ptxas info    : Used 124 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z14lab_one_kernelILi3EEvPKhPh' for 'sm_90a'
ptxas info    : Used 30 registers
ptxas info    : Compiling entry function '_Z25stencil_fused_regs_kernelILi5ELi1EEvPKhPh13StencilParams15StencilGeometryiii' for 'sm_90a'
ptxas info    : Used 126 registers, used 1 barriers
"""


def test_the_build_log_skips_the_direct_instances(tmp_path, monkeypatch):
    # the direct body's lines, and a one-argument kernel's, go nowhere:
    # not into the instance before them either
    got = _build.ptxas_instances(DIRECT_PTXAS)
    assert got == {(3, 3, 3): {"registers": 125},
                   (5, 3, 1): {"registers": 126}}
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    path = _build.library_path("stencil_fused")
    path.with_name(path.name + ".log").write_text(DIRECT_PTXAS)
    for c in (1, 3):
        assert cs._instance_registers("stencil_fused", _plan("edge"),
                                      "regs_direct", c) is None
    rec = cs.describe_launch("stencil_fused", _plan("edge"), 5040, 5760, 3)
    assert (rec["body"], rec["block_h"], rec["tile_w"], rec["grid"],
            rec["threads"], rec["smem_bytes"], rec["registers"]) == (
        "regs_direct", 112, 208, [28, 45], 256, 32768, None)


@pytest.mark.parametrize("c,rows,wc", [(3, 5040, 5760), (1, 5040, 1920)])
def test_the_autotuner_varies_only_the_fuse_under_regs_direct(c, rows, wc):
    from tpu_stencil_torch.runtime import autotune

    cands = autotune._geometry_candidates(_plan("edge"), rows, c, None, wc,
                                          None)
    assert cands and all(req[0] is None and eff.body == "regs_direct"
                         for req, eff in cands)


@pytest.mark.parametrize("name", REGS_FILTERS)
def test_launch_body_runs_the_shared_tile_where_regs_cannot(name):
    plan = _plan(name)
    cells = {1: (5040, 1920), 3: (2520, 5760)}
    for c in (1, 3):
        for fz in range(1, 9):
            assert cs.k1_launch(plan, *cells[c], c, fz).body == "regs"
        # a forced tile height is the shared tile's
        assert cs.k1_launch(plan, *cells[c], c, 8, 32).body == "swar"
    # channel counts the body is not built for
    assert cs.k1_launch(plan, 2520, 3840, 2, 8).body == "swar"
    assert cs.k1_launch(plan, 2520, 7680, 4, 1).body == "swar"
    # a depth whose ghost bands leave no tile of the register extent
    deep = next(f for f in range(1, 200)
                if cs.regs_geometry(plan, 3, f) is None)
    assert cs.k1_launch(plan, *cells[3], 3, deep).body == "swar"
    assert cs.k1_launch(plan, *cells[3], 3, deep - 1).body == "regs"
    # the rep loop's fused launches take regs' own depth (forced, else
    # DEFAULT_FUSE) whatever the image's height and the schedule: the
    # shared tile's clamps do not cut it
    for n_rows in (5, 37, 2520, 5040):
        for fz in (None, 8, 16):
            for sched in (None, "deep"):
                want = cs.DEFAULT_FUSE if fz is None else fz
                loop = cs.k1_loop(plan, n_rows, 5760, 3, None, fz, sched)
                assert (loop.fused.body, loop.fused.tile_h, loop.fuse) == (
                    "regs", cs.regs_geometry(plan, 3, want)[0], want)
    assert cs.effective_geometry(plan, 5, 3)[1] < cs.DEFAULT_FUSE


@pytest.mark.parametrize("name", REGS_FILTERS)
def test_a_single_rep_launch_that_leaves_sms_idle_runs_the_shared_tile(
        name):
    plan = _plan(name)
    # serve's canvases in the frames layout (a 64x64 RGB frame, four 256x256
    # RGB, a 384x2048 grey one) and a ragged grey image: few regs blocks
    for c, rows, wc in ((3, 65, 192), (3, 4 * 257, 768), (1, 385, 2048),
                        (1, 301, 1917)):
        assert cs.regs_grid(plan, c, 1, rows, wc) < cs.H100_SMS
        assert cs.k1_launch(plan, rows, wc, c, 1).body == "swar"
        # deeper launches recompute the shared tile's ghost rows: regs
        assert cs.k1_launch(plan, rows, wc, c, 8).body == "regs"
        assert cs.k1_loop(plan, rows, wc, c, None, 1,
                          None).fused.body == "swar"
    # eight 768x768 grey frames, two 1024x1024 RGB ones, the cells' shapes
    for c, rows, wc in ((1, 8 * 769, 768), (3, 2 * 1025, 3072),
                        (3, 2520, 5760), (1, 5040, 1920)):
        assert cs.regs_grid(plan, c, 1, rows, wc) >= cs.H100_SMS
        assert cs.k1_launch(plan, rows, wc, c, 1).body == "regs"
    # the line: as many blocks as the card has SMs runs regs, one fewer not
    th, tw, _ = cs.regs_geometry(plan, 1, 1)
    assert cs.regs_grid(plan, 1, 1, 12 * th, 11 * tw) == 132
    assert cs.k1_launch(plan, 12 * th, 11 * tw, 1, 1, sms=132).body == "regs"
    assert cs.k1_launch(plan, 12 * th, 11 * tw, 1, 1, sms=133).body == "swar"
    assert cs.k1_launch(plan, 12 * th, 10 * tw, 1, 1, sms=132).body == "swar"
    assert cs.k1_launch(plan, 12 * th, 10 * tw + 1, 1, 1,
                        sms=132).body == "regs"


# ---------------------------------------------------------------------------
# The geometry, mirrored from csrc/stencil_regs.cuh
# ---------------------------------------------------------------------------


def _owners(plan, rows, wc, c, fuse):
    """Per output row and lane, how many (block, warp) and (block, lane)
    owners store it, and the fewest ghost rows / lanes any owner keeps on
    each side of what it stores, by the kernel's index arithmetic."""
    th, tw, nw = cs.regs_geometry(plan, c, fuse)
    q = cs.regs_q(plan)
    v = cs.REGS_V
    gr = fuse * plan.halo
    left = cs.regs_left(plan, c, fuse)
    gy, gx = -(-rows // th), -(-wc // tw)
    # rows: block by, warp w, pair row i of its 2Q rows
    by, w, i = np.meshgrid(np.arange(gy), np.arange(nw), np.arange(2 * q),
                           indexing="ij")
    r = by * th - gr + w * 2 * q + i
    e = r - (by * th - gr)  # the row's place in its block's extent
    stored = (r >= by * th) & (r < by * th + th) & (r < rows)
    row_count = np.bincount(r[stored], minlength=rows)
    row_ghost = min(e[stored].min(), (nw * 2 * q - 1 - e[stored]).min())
    # lanes: block bx, lane l of the warp, lane j of the thread's V
    bx, ln, j = np.meshgrid(np.arange(gx), np.arange(32), np.arange(v),
                            indexing="ij")
    x0 = bx * tw - left + ln * v
    x = x0 + j
    xe = x - (bx * tw - left)
    stored = (x0 >= bx * tw) & (x0 < bx * tw + tw) & (x0 < wc) & (x < wc)
    lane_count = np.bincount(x[stored], minlength=wc)
    lane_ghost = min(xe[stored].min(), (32 * v - 1 - xe[stored]).min())
    return row_count, lane_count, row_ghost, lane_ghost, (gx, gy)


@pytest.mark.parametrize("fuse", range(1, 9))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("name", BODY_FILTERS)
def test_every_output_has_one_owner_and_its_ghost_bands(name, c, fuse):
    plan = _plan(name)
    th, tw, nw = cs.regs_geometry(plan, c, fuse)
    gr = fuse * plan.halo
    q = cs.regs_q(plan)
    # the launch's checks (stencil_regs_runs)
    assert tw % cs.REGS_ALIGN == 0 and tw >= cs.REGS_ALIGN and th >= 1
    assert cs.regs_left(plan, c, fuse) % cs.REGS_ALIGN == 0
    assert cs.regs_left(plan, c, fuse) + tw + gr * c <= 32 * cs.REGS_V
    assert th + 2 * gr == 2 * q * nw and nw == cs.REGS_WARPS == 8
    for rows, wc in SHAPES[c]:
        rc, lc, rg, lg, grid = _owners(plan, rows, wc, c, fuse)
        assert (rc == 1).all() and (lc == 1).all()
        assert rg >= gr and lg >= gr * c
        assert grid == (-(-wc // tw), -(-rows // th))


def test_geometry_at_the_cells():
    g = _plan("gaussian")
    # 1920x2520 RGB and 1920x5040 grey at fuse 8: 112-row tiles of 208 and
    # 240 lanes, 8 warps of 16 rows
    assert cs.regs_geometry(g, 3, 8) == (112, 208, 8)
    assert cs.regs_geometry(g, 1, 8) == (112, 240, 8)
    assert cs.regs_geometry(g, 3, 1) == (126, 240, 8)
    assert cs.regs_smem_bytes() == 32768
    # gaussian5 holds 6 row pairs a thread: a 96-row extent
    assert cs.regs_geometry(_plan("gaussian5"), 3, 8) == (64, 160, 8)
    rec = cs.describe_launch("stencil_fused", g, 2520, 5760, 3, fuse=8)
    assert (rec["body"], rec["block_h"], rec["tile_w"], rec["grid"],
            rec["threads"], rec["smem_bytes"]) == (
        "regs", 112, 208, [28, 23], 256, 32768)
    forced = cs.describe_launch("stencil_fused", g, 2520, 5760, 3,
                                block_h=32, fuse=8)
    assert forced["body"] == "swar" and forced["block_h"] == 32
    # a single rep on one 512x512 RGB frame: the shared tile fills the card
    small = cs.describe_launch("stencil_fused", g, 513, 1536, 3, fuse=1)
    assert (small["body"], small["block_h"], small["grid"]) == (
        "swar", 32, [6, 17])


# ---------------------------------------------------------------------------
# The packed arithmetic, block by block, as the body computes it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [1, 7, 8])
@pytest.mark.parametrize("shape", [(37, 29), (37, 29, 3)], ids=str)
@pytest.mark.parametrize("name", BODY_FILTERS)
def test_regs_launch_matches_pallas(name, shape, fuse):
    jplan, tplan = _plans(name)
    img = _img(shape, 51 + fuse)
    want = np.asarray(pallas_stencil.iterate(
        jnp.asarray(img), jnp.int32(fuse), jplan, interpret=True))
    c = shape[2] if len(shape) == 3 else 1
    got = lab.regs_fused_plain(torch.from_numpy(img).reshape(37, -1), tplan,
                               c, fuse)
    np.testing.assert_array_equal(got.numpy().reshape(shape), want)


@pytest.mark.parametrize("fuse", [1, 3, 8])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("name", BODY_FILTERS)
def test_regs_launch_matches_plain_across_blocks(name, c, fuse):
    # several blocks each way, ragged in both, rows past rows_real
    plan = _plan(name)
    for rows, w in ((250, 170), (131, 97)):
        x2 = torch.from_numpy(_img((rows, w * c), rows + w + fuse))
        for rows_real in (rows, rows - 5):
            got = lab.regs_fused_plain(x2, plan, c, fuse, rows_real)
            want = cs.stencil_fused_plain(x2, plan, c, fuse, rows_real)
            assert torch.equal(got, want)


@pytest.mark.parametrize("name,c", [
    pytest.param(name, c, id=str(c) if name == "gaussian5" else f"{name}-{c}")
    for name in ("gaussian5",) + DIRECT_FILTERS for c in (1, 3)])
def test_regs_frames_matches_pallas(name, c):
    # three 37x29 frames as one tall image with halo-row gaps, the gap rows
    # re-zeroed by the packed mask every rep
    jplan, tplan = _plans(name)
    shape = (3, 37, 29) + ((c,) if c > 1 else ())
    frames = _img(shape, 53)
    want = np.asarray(pallas_stencil.iterate_frames(
        jnp.asarray(frames), jnp.int32(8), jplan, interpret=True))
    h = tplan.halo
    stride = cs.frames_stride(tplan, 37)
    x = torch.from_numpy(frames).reshape(3, 37, -1)
    x = torch.cat([x, torch.zeros((3, h, x.shape[2]), dtype=torch.uint8)], 1)
    x2 = x.reshape(3 * stride, -1)
    got = lab.regs_fused_plain(x2, tplan, c, 8, 3 * stride - h, (stride, 37))
    got = got.reshape(3, stride, -1)[:, :37].reshape(shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ("gaussian",) + DIRECT_FILTERS)
def test_regs_emulation_sees_a_short_ghost_band(monkeypatch, name):
    # the emulation's garbage past the extent shows when a tile is one
    # 8-lane group wider than its ghost bands allow
    plan = _plan(name)
    x2 = torch.from_numpy(_img((40, 600), 57))
    want = cs.stencil_fused_plain(x2, plan, 3, 8)
    assert torch.equal(lab.regs_fused_plain(x2, plan, 3, 8), want)
    th, tw, nw = cs.regs_geometry(plan, 3, 8)
    monkeypatch.setattr(cs, "regs_geometry",
                        lambda *a: (th, tw + cs.REGS_ALIGN, nw))
    assert not torch.equal(lab.regs_fused_plain(x2, plan, 3, 8), want)


def test_regs_plain_refuses_other_launches():
    x2 = torch.zeros((8, 8), dtype=torch.uint8)
    for plan in [_plan(n) for n in ("identity", "gaussian7", "box")] + [
            _direct(EDGE, 16)]:
        with pytest.raises(ValueError, match="regs"):
            lab.regs_fused_plain(x2, plan, 1, 1)
    for name in ("gaussian", "edge"):
        with pytest.raises(ValueError, match="regs"):
            lab.regs_fused_plain(x2, _plan(name), 2, 1)


# ---------------------------------------------------------------------------
# The counter and the reported body
# ---------------------------------------------------------------------------


class _FakeLib:
    def stencil_fused_launch(self, *args):
        return 0


class _Stream:
    cuda_stream = 0


def test_body_launches_count_each_body(monkeypatch):
    import contextlib

    monkeypatch.setattr(cs, "_fused_lib", lambda: _FakeLib())
    monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: id(self))
    cs.reset_launch_counts()
    meta = dict(dtype=torch.uint8, device="meta")
    g = _plan("gaussian")
    # 12 fused launches in regs; the 4 single reps on a one-block grid in
    # the shared tile
    cs.iterate(torch.empty((64, 48, 3), **meta), 100, g)
    assert cs.body_launch_counts() == {"regs": 12, "swar": 4}
    cs.iterate(torch.empty((64, 48), **meta), 9, g, block_h=32)
    cs.iterate(torch.empty((64, 48), **meta), 2, _plan("box"))
    assert cs.body_launch_counts() == {"regs": 12, "swar": 6, "acc16": 2}
    assert cs.launch_counts() == {"stencil_fused": 20, "stencil_resident": 0,
                                  "stencil_valid": 0}
    # edge at the edge cell's shape: 12 fused launches and the 4 single
    # reps (960 blocks) in regs_direct; forced into the shared tile, int32
    cs.reset_launch_counts()
    e = _plan("edge")
    cs.iterate(torch.empty((5040, 1920, 3), **meta), 100, e)
    assert cs.body_launch_counts() == {"regs_direct": 16}
    assert cs.body_rep_counts() == {"regs_direct": 100}
    cs.iterate(torch.empty((64, 48), **meta), 9, e, block_h=32)
    assert cs.body_launch_counts() == {"regs_direct": 16, "int32": 2}
    assert cs.body_rep_counts() == {"regs_direct": 100, "int32": 9}
    cs.reset_launch_counts()
    assert cs.body_launch_counts() == {}


def test_a_cached_launch_builds_no_params(monkeypatch):
    import contextlib

    monkeypatch.setattr(cs, "_fused_lib", lambda: _FakeLib())
    monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: id(self))
    x = torch.empty((2520, 5760), dtype=torch.uint8, device="meta")
    g = _plan("gaussian")
    for depth in (8, 1):
        cs.stencil_fused(x, g, 3, depth)
    built = []

    class Spy(cs._Params):
        def __init__(self, *a, **k):
            built.append(a)
            super().__init__(*a, **k)

    monkeypatch.setattr(cs, "_Params", Spy)
    # the rep loop's launches take their records, structs included, from
    # the cache: no launch builds the plan's parameters again
    cs.iterate(x.reshape(2520, 1920, 3), 100, g)
    for depth in (8, 1):
        cs.stencil_fused(x, g, 3, depth)
    assert built == []
    assert cs.k1_launch(g, 2520, 5760, 3, 8) is cs.k1_launch(
        g, 2520, 5760, 3, 8)


def test_cpu_runs_count_no_body():
    cs.reset_launch_counts()
    cs.iterate(torch.from_numpy(_img((16, 16), 59)), 9, _plan("gaussian"))
    assert cs.body_launch_counts() == {}


@pytest.mark.parametrize("extra,want", [
    ({}, "regs"), ({"fuse": 4}, "regs"), ({"block_h": 16}, "swar"),
    ({"schedule": "deep"}, "swar"), ({"frames": 2}, "regs"),
    # fewer reps than the depth: single reps on a one-block grid
    ({"reps": 5}, "swar")])
def test_job_reports_the_body_k1_ran(tmp_path, extra, want):
    extra = dict(extra)
    frames = extra.get("frames", 1)
    reps = extra.pop("reps", 9)
    src = tmp_path / "in.raw"
    src.write_bytes(_img((frames, 40, 24, 3), 61).tobytes())
    cfg = tconfig.JobConfig(str(src), 24, 40, reps, tconfig.ImageType.RGB,
                            backend="pallas", output=str(tmp_path / "o.raw"),
                            **extra)
    res = tdriver.run_job(cfg, device=torch.device("cpu"))
    assert res.body == want
