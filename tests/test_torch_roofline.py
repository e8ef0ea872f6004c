"""The port's roofline model: the traffic model against the JAX package's,
the launched depth it follows, and the operations bound."""

import re

import pytest

from tpu_stencil.runtime import roofline as jax_roofline

import chip_smoke
from tpu_stencil_torch import filters
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.runtime import roofline

FRAME = 2520 * 1920 * 3


def _plan(name):
    return lowering.plan_filter(filters.get_filter(name))


@pytest.mark.parametrize("filter_name", ["gaussian", "gaussian5", "box",
                                         "edge"])
@pytest.mark.parametrize("h", [64, 630, 2520])
def test_xla_traffic_equals_the_jax_packages(filter_name, h):
    frame = h * 1920 * 3
    want = jax_roofline.analytic_bytes_per_rep(frame, "xla", filter_name, h)
    got = roofline.analytic_bytes_per_rep(frame, "xla", filter_name, h)
    assert got == want == 2.0 * frame


def test_pallas_traffic_follows_the_launched_depth():
    g = _plan("gaussian")
    # fused: K1's clamped fuse, default and forced
    bh, fz = cs.effective_geometry(g, 2520, 3)
    assert roofline.effective_fuse("gaussian", 2520, channels=3) == fz == 8
    assert roofline.analytic_bytes_per_rep(
        FRAME, "pallas", "gaussian", 2520, channels=3) == 2.0 * FRAME / 8
    assert roofline.effective_fuse("gaussian", 2520, block_h=32, fuse=4,
                                   channels=3) == 4
    assert roofline.effective_fuse("gaussian", 2520, block_h=16, fuse=40,
                                   channels=3) == cs.effective_geometry(
        g, 2520, 3, 16, 40)[1] == 8
    # deep, resident: one trip through device memory per grid sync of K2
    assert cs.resident_feasible(g, 2520, 1920 * 3, 3)
    assert roofline.effective_fuse("gaussian", 2520, schedule="deep",
                                   w_img=1920, channels=3, reps=40) == 8
    assert roofline.analytic_bytes_per_rep(
        FRAME, "pallas", "gaussian", 2520, schedule="deep", w_img=1920,
        channels=3, reps=40) == 2.0 * FRAME / 8
    # deep past the L2 budget: K1 at the deep trapezoid depth
    deep = cs.rep_loop(g, 4320, 7680 * 3, 3, None, None, "deep", None)
    assert deep.fuse is not None
    assert roofline.effective_fuse("gaussian", 4320, schedule="deep",
                                   w_img=7680, channels=3,
                                   reps=1000) == deep.fuse
    # without a width the resident kernel is taken as infeasible
    assert roofline.effective_fuse("gaussian", 2520, schedule="deep",
                                   channels=3) == cs.effective_geometry(
        g, 2520, 3, schedule="deep")[1]
    # a forced geometry forces K1 under deep, as the launch does
    assert roofline.effective_fuse("gaussian", 2520, fuse=4, schedule="deep",
                                   w_img=1920, channels=3, reps=40) == 4
    # frames: the depth of the tall launch
    assert roofline.effective_fuse("gaussian", 256, n_frames=3,
                                   channels=3) == cs.effective_geometry(
        g, cs.frames_rows(g, 256, 3), 3)[1]
    # many channels: the fuse shared memory still holds, as the launch clamps
    assert roofline.effective_fuse("gaussian", 64, channels=200) == (
        cs.effective_geometry(g, 64, 200)[1]) < 8


def test_a_forced_fuse_counts_the_records_depth():
    g = _plan("gaussian")
    # fuse 20 on 1920x2520 RGB runs regs at 20 (an 88x128 register tile),
    # where the shared tile's clamp would stop at 16
    assert roofline.effective_fuse("gaussian", 2520, fuse=20, w_img=1920,
                                   channels=3) == 20
    assert roofline.effective_fuse("gaussian", 2520, fuse=20,
                                   channels=3) == 20
    assert roofline.analytic_bytes_per_rep(
        FRAME, "pallas", "gaussian", 2520, fuse=20, w_img=1920,
        channels=3) == 2.0 * FRAME / 20
    assert cs.effective_geometry(g, 2520, 3, None, 20)[1] == 16
    loop = cs.k1_loop(g, 2520, 5760, 3, None, 20, None)
    assert (loop.fused.body, loop.fused.tile_h, loop.fuse) == ("regs", 88,
                                                               20)


def test_achieved_and_frames():
    gbps, pct = roofline.achieved(FRAME, 40e-6, "pallas", "gaussian", 2520,
                                  channels=3)
    assert gbps == pytest.approx(2 * FRAME / 8 / 40e-6 / 1e9)
    assert pct == pytest.approx(100 * gbps / 3350.0)
    g2, p2 = roofline.achieved_frames(FRAME, 4, 160e-6, "xla", "gaussian",
                                      2520)
    assert g2 == pytest.approx(2 * 4 * FRAME / 160e-6 / 1e9)
    jg, _ = jax_roofline.achieved_frames(FRAME, 4, 160e-6, "xla", "gaussian",
                                         2520)
    assert g2 == pytest.approx(jg)  # same traffic, another card's peak


def test_device_memory_budget(monkeypatch):
    monkeypatch.delenv(roofline.ENV_DEVICE_HBM_BYTES, raising=False)
    assert roofline.device_hbm_bytes() == 80 * 10 ** 9
    assert roofline.hbm_frame_feasible(20 * 10 ** 9, pipeline_depth=2)
    assert not roofline.hbm_frame_feasible(30 * 10 ** 9, pipeline_depth=2)
    monkeypatch.setenv(roofline.ENV_DEVICE_HBM_BYTES, "3000")
    assert roofline.device_hbm_bytes() == 3000
    assert roofline.hbm_frame_feasible(1000) and not roofline.hbm_frame_feasible(1001)
    assert roofline.hbm_frame_feasible(1001, hbm_bytes=10 ** 6)
    # the JAX package's override does not move the port's budget
    monkeypatch.delenv(roofline.ENV_DEVICE_HBM_BYTES)
    monkeypatch.setenv("TPU_STENCIL_DEVICE_HBM_BYTES", "5")
    assert roofline.device_hbm_bytes() == 80 * 10 ** 9


def test_no_tpu_constant_crosses_over():
    src = open(roofline.__file__).read()
    assert "V5E" not in src and "v5e" not in src
    assert not [n for n in dir(roofline) if "V5E" in n.upper()]
    assert roofline.H100_HBM_BYTES_PER_S == 3.35e12
    assert roofline.H100_INT32_OPS_PER_S == 67e12 / 4


def test_the_operations_bound():
    g = _plan("gaussian")
    assert roofline.plan_ops(g) == (5, 0)          # 2 + 2 + the shift
    assert roofline.plan_ops(_plan("gaussian5")) == (9, 0)
    assert roofline.plan_ops(_plan("box"))[1] == 5  # convert/divide/clip
    n = 2520 * 1920 * 3
    ms, by = roofline.bound_ms_per_rep(g, n, 40)
    assert by == "operations"
    assert ms == pytest.approx(n * 5 / (67e12 / 4) * 1e3)
    assert ms == pytest.approx(0.00433, abs=5e-6)  # what the smoke printed
    # one rep per trip and no taps to speak of: the bytes bind
    ms1, by1 = roofline.bound_ms_per_rep(g, n, 1, n_bytes=200 * n)
    assert by1 == "bytes" and ms1 == pytest.approx(200 * n / 3.35e12 * 1e3)
    # the smoke reads this module's bound, not a copy of its own
    assert chip_smoke.bound_ms_per_rep(g, n, 40) == (ms, by)
    assert not re.search(r"^def plan_ops|INT32_OPS_PER_S\s*=",
                         open(chip_smoke.__file__).read(), re.M)


def test_the_op_chain_bound():
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import op_cost

    # add_i32 at the tool's tile, a chain of 8: 32 rows read and 32 stored
    # of 320 lanes on 1056 tiles, against 8 int32 adds a stored element
    ib, b, wc, grid = op_cost.tile_for("add_i32")
    assert (ib, b, wc, grid) == (48, 32, 320, 1056)
    ms, by = roofline.op_chain_bound_ms("add_i32", 8, ib, b, wc, grid)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 32 * 320 * 1056 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.00646, abs=5e-6)
    # an add or a multiply issues on the ALU and the FMA pipe (67e12 / 2):
    # the bytes still bind a chain of 16, the adds a chain of 32
    assert roofline.H100_INT32_ADD_MUL_OPS_PER_S == 67e12 / 2
    for case in ("add_i32", "mul_i32", "mul_add_i32", "add_u8"):
        assert roofline.op_chain_bound_ms(case, 16, ib, b, wc, grid) == (
            pytest.approx(ms), "bytes")
    assert roofline.op_chain_bound_ms("add_i32", 32, ib, b, wc, grid) == (
        pytest.approx(32 * 32 * 320 * 1056 / (67e12 / 2) * 1e3),
        "operations")
    # a shift, a max, a clip or a convert has the ALU alone (67e12 / 4)
    ms16, by16 = roofline.op_chain_bound_ms("clip_i32", 16, ib, b, wc, grid)
    assert by16 == "operations"
    assert ms16 == pytest.approx(2 * 16 * 32 * 320 * 1056 / (67e12 / 4)
                                 * 1e3)
    assert roofline.op_chain_bound_ms("shift_i32", 16, ib, b, wc,
                                      grid)[0] == pytest.approx(ms16 / 2)
    # the band products, by hand: 2 * 144 * 144 * 128 a tile and operation
    # on 132 tiles of 160 x 128 at the dense tensor-core peaks, against
    # 144 rows read and 32 stored
    ib, b, wc, grid = op_cost.tile_for("mxu_rows_bf16")
    assert (ib, b, wc, grid) == (160, 32, 128, 132)
    flops = 8 * 2 * 144 * 144 * 128 * 132
    assert roofline.op_chain_bound_ms("mxu_rows_bf16", 8, ib, b, wc,
                                      grid) == (
        pytest.approx(flops / 989e12 * 1e3), "operations")
    assert roofline.op_chain_bound_ms("mxu_rows_i8", 8, ib, b, wc,
                                      grid) == (
        pytest.approx(flops / 1979e12 * 1e3), "operations")
    assert roofline.op_chain_bound_ms("mxu_rows_i8", 3, ib, b, 8 * wc,
                                      grid)[1] == "operations"
    bytes_ = (144 + 32) * 128 * 132
    assert roofline.op_chain_bound_ms("mxu_rows_bf16", 1, ib, b, wc,
                                      grid) == (
        pytest.approx(bytes_ / 3.35e12 * 1e3), "bytes")
    # a shrinking add reads the rows its stored rows need, and computes
    # them: block + 8 * n_ops rows read, n * block + 8 * n (n - 1) / 2 rows
    # of adds; at a chain of 16 the 160 rows read and 32 stored bind, at
    # 32 the adds
    ib, b, wc, grid = op_cost.tile_for("al_slice_add_i16")
    assert lab.op_chain_rows_read("al_slice_add_i16", 8, ib, b) == 32 + 64
    assert roofline.op_chain_bound_ms("al_slice_add_i16", 16, ib, b, wc,
                                      grid) == (
        pytest.approx((160 + 32) * 320 * 1056 / 3.35e12 * 1e3), "bytes")
    assert roofline.op_chain_bound_ms("al_slice_add_i16", 32, 288, b, wc,
                                      grid) == (
        pytest.approx((32 * 32 + 8 * 32 * 31 // 2) * 320 * 1056
                      / (67e12 / 2) * 1e3), "operations")
    # float cases at the float32 rate, a bare roll moves and computes
    # nothing
    assert roofline.op_chain_bound_ms("mul_add_f32", 16, 48, 32, 320,
                                      1056)[0] == pytest.approx(
        2 * 16 * 32 * 320 * 1056 / (67e12 / 2) * 1e3)
    assert roofline.op_chain_bound_ms("roll3_i32", 16, 48, 32, 320,
                                      1056)[1] == "bytes"
    # the tool's bound beside each us/op-pass is the same difference of
    # its two chains as the measurement
    ms8 = roofline.op_chain_bound_ms("clip_i32", 8, 48, 32, 320, 1056)[0]
    assert op_cost.bound_us_per_op_pass("clip_i32") == pytest.approx(
        (ms16 - ms8) / 8 * 1e3)
    assert op_cost.bound_us_per_op_pass("add_i32") == 0
    # the smoke reads this module's bound, not a copy of its own
    src = open(chip_smoke.__file__).read()
    assert "op_chain_bound_ms" in src and "H100_HBM_BYTES_PER_S" not in src
