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
    # deep, resident: the whole rep loop is one trip through device memory
    assert cs.resident_feasible(g, 2520, 1920 * 3, 3)
    assert roofline.effective_fuse("gaussian", 2520, schedule="deep",
                                   w_img=1920, channels=3, reps=40) == 40
    assert roofline.analytic_bytes_per_rep(
        FRAME, "pallas", "gaussian", 2520, schedule="deep", w_img=1920,
        channels=3, reps=40) == 2.0 * FRAME / 40
    # deep past the L2 budget: K1 at the deep trapezoid depth
    deep = cs.deep_geometry(g, 4320, 7680, 3)
    assert deep[1] is not None
    assert roofline.effective_fuse("gaussian", 4320, schedule="deep",
                                   w_img=7680, channels=3, reps=1000) == deep[1]
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
