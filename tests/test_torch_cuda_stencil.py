"""The plain versions of the CUDA kernels and their drivers against the JAX
package's Pallas kernels, run as the JAX package's own tests run them
(``interpret=True``), and against the NumPy golden model.

On the CPU each kernel wrapper runs its plain version (K1
``stencil_fused``: ``iterate``, ``iterate_frames``, ``padded_step``; K2
``stencil_resident``: ``schedule='deep'``); the kernels themselves run only
on the card and are held against these same plain versions by
``chip_smoke.py``. Tolerance: exact byte equality — every plan here is
integer and exact, and the one float32 divide is correctly rounded on
both sides.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil.ops import pallas_stencil
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as tlowering


def _plans(name):
    return (jlowering.plan_filter(jfilters.get_filter(name)),
            tlowering.plan_filter(tfilters.get_filter(name)))


def _img(shape, seed=21):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_iterate(img, reps, plan, **kw):
    return np.asarray(pallas_stencil.iterate(
        jnp.asarray(img), jnp.int32(reps), plan, interpret=True, **kw))


def _port_iterate(img, reps, plan, **kw):
    return cs.iterate(torch.from_numpy(img), reps, plan, **kw).numpy()


@pytest.mark.parametrize("reps", [0, 1, 7, 8, 9])
@pytest.mark.parametrize("shape", [(37, 29), (64, 48, 3)], ids=str)
def test_k1_plain_matches_pallas_gaussian(shape, reps):
    jplan, tplan = _plans("gaussian")
    img = _img(shape)
    got = _port_iterate(img, reps, tplan)
    np.testing.assert_array_equal(got, _jax_iterate(img, reps, jplan))
    if shape == (37, 29) and reps <= 7:
        np.testing.assert_array_equal(got, jstencil.reference_stencil_numpy(
            img, jfilters.get_filter("gaussian"), reps))


@pytest.mark.parametrize("shape", [(37, 29), (64, 48, 3)], ids=str)
@pytest.mark.parametrize("name", ["box", "edge", "gaussian5"])
def test_k1_plain_matches_pallas_other_plans(name, shape):
    jplan, tplan = _plans(name)
    img = _img(shape, 22)
    np.testing.assert_array_equal(_port_iterate(img, 9, tplan),
                                  _jax_iterate(img, 9, jplan))


def test_k1_plain_multi_tile_image():
    # 130 rows x 387 flat lanes: several tiles each way on the card.
    jplan, tplan = _plans("gaussian")
    img = _img((130, 129, 3), 23)
    np.testing.assert_array_equal(_port_iterate(img, 9, tplan),
                                  _jax_iterate(img, 9, jplan))


def test_k1_forced_geometry_matches_pallas():
    jplan, tplan = _plans("edge")
    img = _img((64, 48, 3), 24)
    want = _jax_iterate(img, 8, jplan, block_h=16, fuse=3)
    np.testing.assert_array_equal(
        _port_iterate(img, 8, tplan, block_h=16, fuse=3), want)
    assert cs.effective_geometry(tplan, 64, 3, 16, 3) == (16, 3)


@pytest.mark.parametrize("name,shape,reps", [
    ("gaussian", (3, 20, 17, 3), 9), ("box", (3, 19, 16), 7)])
def test_k1_frames_matches_pallas(name, shape, reps):
    jplan, tplan = _plans(name)
    frames = _img(shape, 25)
    want = np.asarray(pallas_stencil.iterate_frames(
        jnp.asarray(frames), jnp.int32(reps), jplan, interpret=True))
    got = cs.iterate_frames(torch.from_numpy(frames), reps, tplan).numpy()
    np.testing.assert_array_equal(got, want)
    # frames never mix: each equals its own single-image run
    for f, out in zip(frames, got):
        np.testing.assert_array_equal(out, _port_iterate(f, reps, tplan))


def test_padded_step_is_one_rep_of_the_kernel():
    jplan, tplan = _plans("gaussian")
    img = _img((21, 18, 3), 26)
    want = np.asarray(pallas_stencil.padded_step(jnp.asarray(img), jplan,
                                                 interpret=True))
    got = cs.padded_step(torch.from_numpy(img), tplan).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gaussian", "edge"])
def test_k2_deep_resident_matches_pallas(name, monkeypatch):
    jplan, tplan = _plans(name)
    img = _img((40, 33, 3), 27)
    calls = []
    orig = cs.stencil_resident
    monkeypatch.setattr(cs, "stencil_resident",
                        lambda *a, **k: calls.append(a[3]) or orig(*a, **k))
    got = _port_iterate(img, 9, tplan, schedule="deep")
    assert calls == [9]  # one resident "launch" for the whole rep loop
    np.testing.assert_array_equal(
        got, _jax_iterate(img, 9, jplan, schedule="deep"))


def test_k2_plain_equals_k1_plain():
    # One plain function serves both kernels. Rows past rows_real lie
    # outside the image: they stay zero and the rows above them equal the
    # golden model on the cropped image.
    assert cs.stencil_resident_plain is cs.stencil_fused_plain
    _, tplan = _plans("gaussian5")
    img = _img((33, 17, 3), 28)
    x2 = torch.from_numpy(img.reshape(33, 51))
    got = cs.stencil_resident_plain(x2, tplan, 3, 6, rows_real=30).numpy()
    assert not got[30:].any()
    np.testing.assert_array_equal(
        got[:30].reshape(30, 17, 3), jstencil.reference_stencil_numpy(
            img[:30], jfilters.get_filter("gaussian5"), 6))


def test_deep_past_the_l2_budget_runs_k1(monkeypatch):
    jplan, tplan = _plans("gaussian")
    img = _img((40, 33, 3), 29)
    monkeypatch.setattr(cs, "H100_L2_BYTES", 1000)
    assert not cs.resident_feasible(tplan, 40, 99, 3)
    depths = []
    orig = cs.stencil_fused
    monkeypatch.setattr(cs, "stencil_fused",
                        lambda *a, **k: depths.append(a[3]) or orig(*a, **k))
    got = _port_iterate(img, 9, tplan, schedule="deep")
    loop = cs.rep_loop(tplan, 40, 99, 3, None, None, "deep", None)
    assert depths == cs.launch_schedule(9, loop.fuse)
    np.testing.assert_array_equal(
        got, _jax_iterate(img, 9, jplan, schedule="deep"))


@pytest.mark.parametrize("reps,fuse", [(0, 8), (1, 8), (7, 8), (8, 8),
                                       (9, 8), (40, 8), (40, 3), (5, 1)])
def test_launches_are_fused_then_single(reps, fuse, monkeypatch):
    _, tplan = _plans("gaussian")
    sched = cs.launch_schedule(reps, fuse)
    assert len(sched) == (reps // fuse + reps % fuse if fuse > 1 else reps)
    assert sum(sched) == reps
    depths = []
    orig = cs.stencil_fused
    monkeypatch.setattr(cs, "stencil_fused",
                        lambda *a, **k: depths.append(a[3]) or orig(*a, **k))
    img = torch.from_numpy(_img((48, 20), 30))
    out = cs.iterate(img, reps, tplan, block_h=48, fuse=fuse)
    assert depths == sched
    np.testing.assert_array_equal(
        out.numpy(), cs.stencil_fused_plain(img, tplan, 1, reps).numpy())


def test_cpu_runs_do_not_count_launches():
    _, tplan = _plans("gaussian")
    before = cs.launch_counts()
    cs.iterate(torch.from_numpy(_img((16, 16), 31)), 9, tplan)
    cs.iterate(torch.from_numpy(_img((16, 16), 31)), 9, tplan, schedule="deep")
    assert cs.launch_counts() == before


def test_geometry_clamps():
    _, g = _plans("gaussian")
    _, g7 = _plans("gaussian7")
    assert cs.effective_block_h(g, 2520, 3) == cs.DEFAULT_BLOCK_H
    assert cs.effective_block_h(g, 2520, 3, 20) == 24   # 8-row aligned
    assert cs.effective_block_h(g, 13, 3, 64) == 16     # clamped to image
    # a forced tall tile is cut to what fits shared memory at fuse 1
    bh = cs.effective_block_h(g, 10000, 3, 4096)
    assert cs.tile_smem_bytes(g, bh, 1, 3) <= cs.SMEM_LIMIT
    assert cs.tile_smem_bytes(g, bh + 8, 1, 3) > cs.SMEM_LIMIT
    assert cs.effective_geometry(g, 2520, 3) == (32, 8)
    assert cs.effective_geometry(g, 2520, 3, fuse=40) == (32, 16)  # bh/(2h)
    assert cs.effective_geometry(g7, 2520, 3, 32, 8) == (32, 5)    # bh/(2h)
    bh, fz = cs.effective_geometry(g7, 2520, 3, 160, 26)
    assert cs.tile_smem_bytes(g7, bh, fz, 3) <= cs.SMEM_LIMIT      # smem cap
    assert cs.tile_smem_bytes(g7, bh, fz + 1, 3) > cs.SMEM_LIMIT


def test_deep_depth_and_feasibility_verdicts():
    _, g = _plans("gaussian")
    assert cs.deep_fuse_for(g, 32, 3) == 8       # 2*8*1 <= 32/2
    assert cs.deep_fuse_for(g, 64, 3) == 16
    # at 128 rows the overhead cap allows 32, shared memory only 16 in
    # gaussian's swar body (4 bytes per element), 8 in the int32 body
    assert cs.deep_fuse_for(g, 128, 3) == 16
    assert cs.tile_smem_bytes(g, 128, 24, 3) > cs.SMEM_LIMIT
    assert cs.deep_fuse_for(g, 128, 3, body="int32") == 8
    assert cs.tile_smem_bytes(g, 128, 12, 3, body="int32") > cs.SMEM_LIMIT
    assert cs.effective_geometry(g, 2520, 3, schedule="deep") == (32, 8)
    # the reference job fits the resident kernel; 4K-by-8K RGB does not
    assert cs.resident_feasible(g, 2520, 1920 * 3, 3)
    assert not cs.resident_feasible(g, 4320, 7680 * 3, 3)
    assert not cs.resident_feasible(g, 2520, 1920 * 3, 3, l2_bytes=2 ** 20)
    assert cs.rep_loop(g, 2520, 5760, 3, None, None, "deep",
                       None).kernel == "stencil_resident"
    # K1 runs gaussian in regs, at that body's own tile and depth
    past = cs.rep_loop(g, 4320, 23040, 3, None, None, "deep", None)
    assert (past.fused.body, past.fused.tile_h, past.fuse) == (
        "regs", cs.regs_geometry(g, 3, cs.DEFAULT_FUSE)[0], cs.DEFAULT_FUSE)
    forced = cs.rep_loop(g, 2520, 5760, 3, 64, None, "deep", None)
    assert (forced.fused.tile_h, forced.fuse) == (64, 16)
    f32 = tlowering.plan_filter(tfilters.from_numpy(np.full((3, 3), 0.1)))
    assert not cs.plan_supported(f32, 3)
    assert not cs.resident_feasible(f32, 8, 8, 1)
    box = [tlowering.plan_filter(tfilters.from_numpy(np.ones((k, k)), k * k))
           for k in (15, 17)]
    assert [p.kind for p in box] == ["sep_int", "sep_int"]
    assert cs.plan_supported(box[0], 3)
    assert not cs.plan_supported(box[1], 1)  # more taps than MAX_K


def test_unsupported_plans_run_torch_ops():
    f = tfilters.from_numpy(np.array([[0.125, 0.25, 0.125]] * 3), 1.0)
    plan = tlowering.plan_filter(f)
    assert plan.kind == "direct_f32"
    img = torch.from_numpy(_img((12, 10, 3), 32))
    want = img
    for _ in range(3):
        want = tlowering.padded_step(want, plan)
    np.testing.assert_array_equal(cs.iterate(img, 3, plan).numpy(),
                                  want.numpy())


def test_schedule_names():
    for s in ("pad", "shrink", "strips", "pack", "pack_strips", None):
        assert cs.effective_schedule(s) == "fused"
    assert cs.effective_schedule("deep") == "deep"
    with pytest.raises(ValueError):
        cs.effective_schedule("fast")


def test_ctypes_structs_mirror_the_c_layout():
    assert ctypes.sizeof(cs._Params) == 4 * (9 + 2 * cs.MAX_K + cs.MAX_K ** 2)
    assert ctypes.sizeof(cs._Params) % 16 == 0
    assert cs._Params.div_mul.offset == 4 * (5 + 2 * cs.MAX_K + cs.MAX_K ** 2)
    assert ctypes.sizeof(cs._Geometry) == 4 * 8
    _, edge = _plans("edge")
    p = cs._params(edge)
    assert (p.kind, p.k, p.shift, p.clip, p.divisor) == (1, 3, -1, 1, 28.0)
    assert list(p.taps[:9]) == [1, 4, 1, 4, 8, 4, 1, 4, 1]  # stride k
    # the proven multiply-high of /28, as __umulhi's multiplier
    assert p.div_mul == 9363 << (32 - 18)
    _, g = _plans("gaussian")
    p = cs._params(g)
    assert (p.kind, p.shift, p.clip, p.div_mul) == (0, 4, 0, 0)
    assert list(p.row_taps[:3]) == [1, 2, 1] == list(p.col_taps[:3])


def test_cuda_call_without_a_library_raises(monkeypatch):
    # A non-CPU tensor never takes the plain version: with the library
    # loader failing, the wrapper raises (no fallback).
    def no_lib(name):
        raise _build.KernelBuildError(f"no {name}")

    monkeypatch.setattr(_build, "load", no_lib)
    _, g = _plans("gaussian")
    x = torch.empty((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(_build.KernelBuildError):
        cs.stencil_fused(x, g, 1, 1)
    with pytest.raises(_build.KernelBuildError):
        cs.stencil_resident(x, g, 1, 3)
    with pytest.raises(_build.KernelBuildError):
        cs.iterate(torch.empty((8, 8, 3), dtype=torch.uint8, device="meta"),
                   2, g)


def test_missing_nvcc_is_a_typed_error(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()


def test_failed_build_is_a_typed_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(_build.KernelBuildError, match="stencil_fused"):
        _build.build(["stencil_fused"])
    assert not list(tmp_path.glob("*.so"))


def test_library_names_follow_the_sources():
    a = _build.library_path("stencil_fused")
    b = _build.library_path("stencil_resident")
    assert a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("libstencil_fused-") and a != b
    assert a == _build.library_path("stencil_fused")  # stable hash
    assert "--use_fast_math" not in _build.NVCC_FLAGS
