"""K1's register body ``regs``: the chooser, the launch geometry, the packed
arithmetic as the body computes it, and the per-body launch counter.

``cuda_stencil.fused_body`` gives gaussian and gaussian5 (binomial taps of
size 3 and 5, which ``swar_ok`` admits) the ``regs`` body and every other
plan ``tile_body``'s; ``launch_body`` runs the shared tile where a launch
forces a tile height, has another channel count, leaves ``regs`` no tile,
or is a single rep whose ``regs`` grid has fewer blocks than the card has
SMs. The kernel runs only on the card (``chip_smoke.py`` phase ``k1``
holds it byte for byte against the plain version). Here
``lab.regs_fused_plain`` computes one launch as the body does, block by
block over its register extent, reading garbage past the extent as the
kernel reads wrong values there, and is held against the plain version
and the JAX package's Pallas kernels in interpret mode. Tolerance: exact
byte equality (integer plans).
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
OTHER_FILTERS = ("identity", "box", "edge", "soft_blur", "gaussian7",
                 "gaussian9", "gaussian15")
# (rows, W*C) of the cells (1920x2520 RGB, 1920x5040 grey), ragged widths
# and heights, and a small image.
SHAPES = {3: [(2520, 5760), (2519, 5763), (37, 87)],
          1: [(5040, 1920), (5041, 1917), (37, 29)]}


def _plan(name):
    return tlowering.plan_filter(tfilters.get_filter(name))


def _plans(name):
    return (jlowering.plan_filter(jfilters.get_filter(name)), _plan(name))


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ---------------------------------------------------------------------------
# The chooser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", REGS_FILTERS + OTHER_FILTERS)
def test_k1_chooser_per_filter(name):
    plan = _plan(name)
    want = "regs" if name in REGS_FILTERS else cs.tile_body(plan)
    assert cs.fused_body(plan) == want
    # K2 and K3 keep the shared tile's body
    for kernel, rows in (("stencil_resident", 64), ("stencil_valid", 16)):
        rec = cs.describe_launch(kernel, plan, rows, 96, 3, fuse=2)
        assert rec["body"] == cs.tile_body(plan)


def test_k1_chooser_is_a_function_of_the_plan_alone():
    assert list(inspect.signature(cs.fused_body).parameters) == ["plan"]
    for name in REGS_FILTERS + OTHER_FILTERS:
        a = _plan(name)
        b = tlowering.plan_from_fields(
            {f: getattr(a, f) for f in a.__dataclass_fields__})
        assert cs.fused_body(a) == cs.fused_body(b)
    assert cs.K1_BODIES == cs.BODIES + ("regs",)
    assert cs.K1_BODIES.index("regs") == _build.REGS_BODY
    # swar plans that are not binomial keep swar
    assert cs.swar_ok(_plan("identity")) and cs.fused_body(
        _plan("identity")) == "swar"


@pytest.mark.parametrize("name", REGS_FILTERS)
def test_launch_body_runs_the_shared_tile_where_regs_cannot(name):
    plan = _plan(name)
    cells = {1: (5040, 1920), 3: (2520, 5760)}
    for c in (1, 3):
        for fz in range(1, 9):
            assert cs.launch_body(plan, c, fz, *cells[c]) == "regs"
        # a forced tile height is the shared tile's
        assert cs.launch_body(plan, c, 8, *cells[c], 32) == "swar"
    # channel counts the body is not built for
    assert cs.launch_body(plan, 2, 8, 2520, 3840) == "swar"
    assert cs.launch_body(plan, 4, 1, 2520, 7680) == "swar"
    # a depth whose ghost bands leave no tile of the register extent
    deep = next(f for f in range(1, 200)
                if cs.regs_geometry(plan, 3, f) is None)
    assert cs.launch_body(plan, 3, deep, *cells[3]) == "swar"
    assert cs.launch_body(plan, 3, deep - 1, *cells[3]) == "regs"
    # the rep loop's fused launches take regs' own depth (forced, else
    # DEFAULT_FUSE) whatever the image's height and the schedule: the
    # shared tile's clamps do not cut it
    for n_rows in (5, 37, 2520, 5040):
        for fz in (None, 8, 16):
            for sched in (None, "deep"):
                want = cs.DEFAULT_FUSE if fz is None else fz
                assert cs.k1_launch(plan, n_rows, 5760, 3, None, fz, sched,
                                    None) == (
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
        assert cs.launch_body(plan, c, 1, rows, wc) == "swar"
        # deeper launches recompute the shared tile's ghost rows: regs
        assert cs.launch_body(plan, c, 8, rows, wc) == "regs"
        assert cs.k1_launch(plan, rows, wc, c, None, 1, None, None)[:1] == (
            "swar",)
    # eight 768x768 grey frames, two 1024x1024 RGB ones, the cells' shapes
    for c, rows, wc in ((1, 8 * 769, 768), (3, 2 * 1025, 3072),
                        (3, 2520, 5760), (1, 5040, 1920)):
        assert cs.regs_grid(plan, c, 1, rows, wc) >= cs.H100_SMS
        assert cs.launch_body(plan, c, 1, rows, wc) == "regs"
    # the line: as many blocks as the card has SMs runs regs, one fewer not
    th, tw, _ = cs.regs_geometry(plan, 1, 1)
    assert cs.regs_grid(plan, 1, 1, 12 * th, 11 * tw) == 132
    assert cs.launch_body(plan, 1, 1, 12 * th, 11 * tw, sms=132) == "regs"
    assert cs.launch_body(plan, 1, 1, 12 * th, 11 * tw, sms=133) == "swar"
    assert cs.launch_body(plan, 1, 1, 12 * th, 10 * tw, sms=132) == "swar"
    assert cs.launch_body(plan, 1, 1, 12 * th, 10 * tw + 1,
                          sms=132) == "regs"


# ---------------------------------------------------------------------------
# The geometry, mirrored from csrc/stencil_regs.cuh
# ---------------------------------------------------------------------------


def _owners(plan, rows, wc, c, fuse):
    """Per output row and lane, how many (block, warp) and (block, lane)
    owners store it, and the fewest ghost rows / lanes any owner keeps on
    each side of what it stores, by the kernel's index arithmetic."""
    th, tw, nw = cs.regs_geometry(plan, c, fuse)
    q = cs.REGS_Q[plan.k]
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
@pytest.mark.parametrize("name", REGS_FILTERS)
def test_every_output_has_one_owner_and_its_ghost_bands(name, c, fuse):
    plan = _plan(name)
    th, tw, nw = cs.regs_geometry(plan, c, fuse)
    gr = fuse * plan.halo
    q = cs.REGS_Q[plan.k]
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
@pytest.mark.parametrize("name", REGS_FILTERS)
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
@pytest.mark.parametrize("name", REGS_FILTERS)
def test_regs_launch_matches_plain_across_blocks(name, c, fuse):
    # several blocks each way, ragged in both, rows past rows_real
    plan = _plan(name)
    for rows, w in ((250, 170), (131, 97)):
        x2 = torch.from_numpy(_img((rows, w * c), rows + w + fuse))
        for rows_real in (rows, rows - 5):
            got = lab.regs_fused_plain(x2, plan, c, fuse, rows_real)
            want = cs.stencil_fused_plain(x2, plan, c, fuse, rows_real)
            assert torch.equal(got, want)


@pytest.mark.parametrize("c", [1, 3])
def test_regs_frames_matches_pallas(c):
    # three 37x29 frames as one tall image with halo-row gaps, the gap rows
    # re-zeroed by the packed mask every rep
    jplan, tplan = _plans("gaussian5")
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


def test_regs_emulation_sees_a_short_ghost_band(monkeypatch):
    # the emulation's garbage past the extent shows when a tile is one
    # 8-lane group wider than its ghost bands allow
    plan = _plan("gaussian")
    x2 = torch.from_numpy(_img((40, 600), 57))
    want = cs.stencil_fused_plain(x2, plan, 3, 8)
    assert torch.equal(lab.regs_fused_plain(x2, plan, 3, 8), want)
    th, tw, nw = cs.regs_geometry(plan, 3, 8)
    monkeypatch.setattr(cs, "regs_geometry",
                        lambda *a: (th, tw + cs.REGS_ALIGN, nw))
    assert not torch.equal(lab.regs_fused_plain(x2, plan, 3, 8), want)


def test_regs_plain_refuses_other_launches():
    x2 = torch.zeros((8, 8), dtype=torch.uint8)
    for name in ("identity", "gaussian7", "box", "edge"):
        with pytest.raises(ValueError, match="regs"):
            lab.regs_fused_plain(x2, _plan(name), 1, 1)
    with pytest.raises(ValueError, match="regs"):
        lab.regs_fused_plain(x2, _plan("gaussian"), 2, 1)


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
    cs.reset_launch_counts()
    assert cs.body_launch_counts() == {}


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
