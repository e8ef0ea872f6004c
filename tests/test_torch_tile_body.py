"""K1, K2 and K3's tile body, chosen per plan: the gate, the shared-memory
model, the geometry it prunes, and the ``swar`` body's packed arithmetic.
K1's own ``regs`` body is held in ``tests/test_torch_fused_regs.py``.

``cuda_stencil.tile_body`` picks ``swar`` (two rows per 32-bit word),
``acc16`` (int16 intermediate) or ``int32`` from the plan alone; the kernel
runs the body only on the card (``chip_smoke.py`` phases ``k1`` and ``k3``
hold every body against the plain versions). Here the packed arithmetic of
``swar`` is run in plain torch (``lab.swar_fused_plain``,
``lab.swar_valid_plain``) and held against the JAX package's Pallas kernels
in interpret mode, as ``tests/test_pallas.py`` runs them. Tolerance: exact
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
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.ops import lowering as tlowering
from tpu_stencil_torch.runtime import autotune
from tpu_stencil_torch.tools import bh_fuse_ab

torch.set_num_threads(1)

BODY_OF = {"gaussian": "swar", "gaussian5": "swar", "identity": "swar",
           "gaussian7": "acc16", "box": "acc16",
           "edge": "int32", "soft_blur": "int32"}
LAB_VARIANT = {"int32": "current", "acc16": "acc16", "swar": "swar"}


def _plan(name):
    return tlowering.plan_filter(tfilters.get_filter(name))


def _plans(name):
    return (jlowering.plan_filter(jfilters.get_filter(name)), _plan(name))


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("name", sorted(set(tfilters.FILTERS) | set(BODY_OF)))
def test_tile_body_per_filter(name):
    assert cs.tile_body(_plan(name)) == BODY_OF[name]


def test_every_registered_filter_has_its_body_pinned():
    assert set(tfilters.FILTERS) <= set(BODY_OF)


def test_body_is_a_function_of_the_plan_alone():
    assert list(inspect.signature(cs.tile_body).parameters) == ["plan"]
    for name in BODY_OF:
        a = _plan(name)
        b = tlowering.plan_from_fields(
            {f: getattr(a, f) for f in a.__dataclass_fields__})
        assert cs.tile_body(a) == cs.tile_body(b) == BODY_OF[name]
    assert cs.BODIES == ("int32", "acc16", "swar")
    # K2 sizes its tile in the plan's body too: at fuse 8, 56 rows leave
    # two blocks per SM in swar for gaussian but not for gaussian5
    g, g5 = _plan("gaussian"), _plan("gaussian5")
    assert cs.resident_geometry(g, 2520, 5760, 3) == (56, 8)
    assert cs.resident_geometry(g5, 2520, 5760, 3) == (48, 8)
    assert 2 * cs.tile_smem_bytes(g5, 56, 8, 3) > cs.SM_SMEM


def _worst_fields(plan):
    """The rows-pass and cols-pass maxima of one rep on an all-255 image,
    in numpy (int64, no wrap)."""
    k = plan.k
    img = np.full((3 * k, 3 * k), 255, np.int64)
    rows = sum(t * img[i:i + k + 1] for i, t in enumerate(plan.row_taps))
    cols = sum(t * rows[:, j:j + k + 1] for j, t in enumerate(plan.col_taps))
    return int(rows.max()), int(cols.max()), int(rows.min())


@pytest.mark.parametrize("name", sorted(BODY_OF) + [
    f"gaussian{k}" for k in range(3, 16, 2)])
def test_body_worst_case_holds(name):
    plan = _plan(name)
    body = cs.tile_body(plan)
    if plan.kind != "sep_int":
        assert body == "int32"
        return
    rows_max, cols_max, rows_min = _worst_fields(plan)
    if body == "swar":
        # every 16-bit field, intermediate and finished sum, stays < 2^16
        assert 0 <= rows_min and rows_max < 2 ** 16 and cols_max < 2 ** 16
        assert (cols_max >> plan.shift) <= 255
    elif body == "acc16":
        assert -2 ** 15 <= rows_min and rows_max < 2 ** 15
    else:
        assert not cs.acc16_ok(plan) and not cs.swar_ok(plan)
        assert rows_max >= 2 ** 15 or rows_min < 0


def test_wide_gaussians_fall_back_to_wider_bodies():
    bodies = {k: cs.tile_body(_plan(f"gaussian{k}")) for k in range(3, 16, 2)}
    assert bodies == {3: "swar", 5: "swar", 7: "acc16", 9: "int32",
                      11: "int32", 13: "int32", 15: "int32"}


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("body", list(LAB_VARIANT))
def test_tile_smem_equals_the_lab_variants(body, channels):
    g = _plan("gaussian")
    v = lab.parse_variant(LAB_VARIANT[body])
    for bh in (8, 16, 32, 64, 128):
        for fz in (1, 4, 8, 16):
            assert cs.tile_smem_bytes(g, bh, fz, channels, body=body) == (
                lab.lab_smem_bytes(v, g, bh, fz, channels))
    # the default body is the plan's
    assert cs.tile_smem_bytes(g, 32, 8, 3) == cs.tile_smem_bytes(
        g, 32, 8, 3, body="swar") == (24 + 2 + 24) * 304 * 4
    g7 = _plan("gaussian7")
    assert cs.tile_smem_bytes(g7, 32, 5, 3) == (32 + 30) * (256 + 90) * 3


@pytest.mark.parametrize("name", ["gaussian", "gaussian5", "gaussian7",
                                  "box", "edge"])
@pytest.mark.parametrize("channels", [1, 3])
def test_geometry_fits_shared_memory_with_even_tiles(name, channels):
    plan = _plan(name)
    for n_rows in (5, 37, 2520, 10000):
        for bh in (None, 8, 20, 64, 256, 4096):
            for fz in (None, 1, 8, 40):
                for sched in (None, "deep"):
                    ebh, efz = cs.effective_geometry(plan, n_rows, channels,
                                                     bh, fz, schedule=sched)
                    assert ebh % 8 == 0
                    assert (cs.tile_smem_bytes(plan, ebh, efz, channels)
                            <= cs.SMEM_LIMIT)
            vbh, vfz = cs.valid_geometry(plan, n_rows, channels, 8, bh)
            assert vbh % 2 == 0
            assert cs.tile_smem_bytes(plan, vbh, vfz, channels) <= (
                cs.SMEM_LIMIT)
    assert cs.plan_supported(plan, channels)


def test_swar_admits_taller_tiles_than_int32():
    g = _plan("gaussian")
    # 128 x 20 on grey: 201,280 bytes packed, 248,640 in the int32 body
    assert cs.tile_smem_bytes(g, 128, 20, 1) <= cs.SMEM_LIMIT
    assert cs.tile_smem_bytes(g, 128, 20, 1, body="int32") > cs.SMEM_LIMIT
    assert cs.effective_geometry(g, 2520, 1, 128, 20) == (128, 20)
    assert cs.effective_geometry(g, 2520, 1, 128, 20, body="int32")[1] < 20


def test_autotune_grid_admits_what_swar_admits():
    g = _plan("gaussian")
    # two channels: K1 runs gaussian in swar (regs is built for 1 and 3)
    cands = [req for req, _ in autotune._geometry_candidates(
        g, 2520, 2, None, 3840, None)]
    admitted = [req for req in autotune._GEOMETRY_GRID
                if cs.tile_smem_bytes(g, *req, 2) <= cs.SMEM_LIMIT]
    assert (128, 20) in cands
    assert all(req in admitted for req in cands)
    assert cs.tile_smem_bytes(g, 128, 20, 2, body="int32") > cs.SMEM_LIMIT
    # grey: K1 runs regs, where the grid varies only the fuse
    cands = autotune._geometry_candidates(g, 2520, 1, None, 1920, None)
    assert cands and all(req[0] is None and eff.body == "regs"
                         for req, eff in cands)


def test_bh_fuse_ab_admits_what_swar_admits():
    g = _plan("gaussian")
    assert bh_fuse_ab.parse_candidates(["128x20"], g, 1) == [(128, 20)]
    with pytest.raises(ValueError, match="shared"):
        bh_fuse_ab.parse_candidates(["128x40"], g, 1)


# ---------------------------------------------------------------------------
# The swar body's packed arithmetic against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reps", [1, 7, 8, 9])
@pytest.mark.parametrize("shape", [(37, 29), (37, 29, 3)], ids=str)
@pytest.mark.parametrize("name", ["gaussian", "gaussian5", "identity"])
def test_swar_k1_matches_pallas(name, shape, reps):
    jplan, tplan = _plans(name)
    img = _img(shape, 41 + reps)
    want = np.asarray(pallas_stencil.iterate(
        jnp.asarray(img), jnp.int32(reps), jplan, interpret=True))
    c = shape[2] if len(shape) == 3 else 1
    got = lab.swar_fused_plain(torch.from_numpy(img).reshape(37, -1), tplan,
                               c, reps)
    np.testing.assert_array_equal(got.numpy().reshape(shape), want)


@pytest.mark.parametrize("reps", [1, 7, 8, 9])
@pytest.mark.parametrize("channels", [1, 3])
def test_swar_k1_frames_matches_pallas(channels, reps):
    # three 37x29 frames as one tall image with halo-row gaps, the gap rows
    # re-zeroed by the packed mask every rep
    jplan, tplan = _plans("gaussian5")
    shape = (3, 37, 29) + ((channels,) if channels > 1 else ())
    frames = _img(shape, 43 + reps)
    want = np.asarray(pallas_stencil.iterate_frames(
        jnp.asarray(frames), jnp.int32(reps), jplan, interpret=True))
    h = tplan.halo
    stride = cs.frames_stride(tplan, 37)
    x = torch.from_numpy(frames).reshape(3, 37, -1)
    x = torch.cat([x, torch.zeros((3, h, x.shape[2]), dtype=torch.uint8)], 1)
    x2 = x.reshape(3 * stride, -1)
    got = lab.swar_fused_plain(x2, tplan, channels, reps, 3 * stride - h,
                               (stride, 37))
    got = got.reshape(3, stride, -1)[:, :37].reshape(shape)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), cs.iterate_frames(torch.from_numpy(frames), reps,
                                       tplan).numpy())


TH, TW, GRID = 9, 7, (3, 3)


@pytest.mark.parametrize("fuse", [1, 2, 8])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("position", [(0, 0), (0, 1), (1, 1), (2, 2)],
                         ids=str)
@pytest.mark.parametrize("name", ["gaussian", "gaussian5"])
def test_swar_k3_matches_pallas(name, position, channels, fuse):
    jplan, tplan = _plans(name)
    g = fuse * tplan.halo
    i, j = position
    row0, col0 = i * TH, j * TW * channels
    glob = (TH * GRID[0], TW * GRID[1] * channels)
    ext = _img((TH + 2 * g, (TW + 2 * g) * channels), 47 + fuse)
    want = np.asarray(pallas_stencil.valid_fused(
        jnp.asarray(ext), jplan, fuse, channels, jnp.int32(row0),
        jnp.int32(col0), glob, interpret=True))
    got = lab.swar_valid_plain(torch.from_numpy(ext), tplan, channels, fuse,
                               row0, col0, glob)
    np.testing.assert_array_equal(got.numpy(), want)


def test_swar_plain_refuses_other_plans():
    x2 = torch.zeros((8, 8), dtype=torch.uint8)
    for name in ("gaussian7", "box", "edge"):
        with pytest.raises(ValueError, match="swar"):
            lab.swar_fused_plain(x2, _plan(name), 1, 1)
        with pytest.raises(ValueError, match="swar"):
            lab.swar_valid_plain(x2, _plan(name), 1, 1, 0, 0, (4, 4))


# ---------------------------------------------------------------------------
# The wrapper passes the plan's body, and nothing falls back
# ---------------------------------------------------------------------------


class _FakeLib:
    """Stands in for a built tile library: records the body of each
    launch."""

    def __init__(self):
        self.bodies = []

    def stencil_fused_launch(self, *args):
        self.bodies.append(args[5])
        return 0

    stencil_valid_launch = stencil_fused_launch

    def stencil_resident_launch(self, *args):
        self.bodies.append(args[7])
        return 0


class _Stream:
    cuda_stream = 0


def _fake_card(monkeypatch):
    import contextlib

    lib = _FakeLib()
    monkeypatch.setattr(cs, "_fused_lib", lambda: lib)
    monkeypatch.setattr(cs, "_valid_lib", lambda: lib)
    monkeypatch.setattr(cs, "_resident_lib", lambda: lib)
    monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(cs, "resident_feasible", lambda *a, **k: False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    # meta tensors share address 0; the wrappers refuse aliased buffers
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: id(self))
    return lib


@pytest.mark.parametrize("kernel", ["stencil_fused", "stencil_resident",
                                    "stencil_valid"])
@pytest.mark.parametrize("name", sorted(BODY_OF))
def test_wrappers_pass_the_plans_body(name, kernel, monkeypatch):
    # K1 passes fused_body's (regs for gaussian and gaussian5), and the
    # shared tile's where a forced tile height asks for it; K2 and K3 pass
    # tile_body's.
    lib = _fake_card(monkeypatch)
    plan = _plan(name)
    meta = dict(dtype=torch.uint8, device="meta")
    if kernel == "stencil_fused":
        cs.iterate(torch.empty((37, 29, 3), **meta), 16, plan, fuse=8)
        cs.iterate(torch.empty((64, 48), **meta), 2, plan, fuse=2)
        cs.iterate(torch.empty((40, 32), **meta), 8, plan, schedule="deep")
        cs.iterate_frames(torch.empty((3, 20, 16, 3), **meta), 8, plan)
        assert lib.bodies and set(lib.bodies) == {
            cs.K1_BODIES.index(cs.fused_body(plan))}
        lib.bodies.clear()
        # a single rep on these few-block frames: regs loses it to the
        # shared tile (k1_launch), regs_direct keeps it
        cs.iterate_frames(torch.empty((3, 20, 16, 3), **meta), 1, plan)
        single = (cs.tile_body(plan) if cs.fused_body(plan) == cs.REGS
                  else cs.fused_body(plan))
        assert lib.bodies and set(lib.bodies) == {
            cs.K1_BODIES.index(single)}
        lib.bodies.clear()
        # a forced tile height runs the shared tile's
        cs.iterate(torch.empty((64, 48), **meta), 1, plan, block_h=16, fuse=2)
        cs.iterate(torch.empty((37, 29, 3), **meta), 9, plan, block_h=16)
        want = cs.tile_body(plan)
    elif kernel == "stencil_resident":
        monkeypatch.setattr(cs, "resident_feasible", lambda *a, **k: True)
        cs.iterate(torch.empty((40, 32), **meta), 8, plan, schedule="deep")
        cs.iterate_frames(torch.empty((3, 20, 16, 3), **meta), 7, plan,
                          schedule="deep")
        want = cs.tile_body(plan)
    else:
        g = 2 * plan.halo
        cs.valid_fused(torch.empty((9 + 2 * g, (7 + 2 * g) * 3), **meta),
                       plan, 2, 3, 0, 0, (27, 63))
        want = cs.tile_body(plan)
    assert lib.bodies and set(lib.bodies) == {cs.BODIES.index(want)}


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    ran = []
    monkeypatch.setattr(tlowering, "iterate", lambda *a, **k: ran.append(a))
    monkeypatch.setattr(cs, "stencil_fused_plain",
                        lambda *a, **k: ran.append(a))
    g = _plan("gaussian")
    before = cs.launch_counts()
    x = torch.empty((37, 29, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(_build.KernelBuildError, match="stencil_fused"):
        cs.iterate(x, 9, g)
    with pytest.raises(_build.KernelBuildError, match="stencil_valid"):
        cs.valid_fused(torch.empty((13, 33), dtype=torch.uint8,
                                   device="meta"), g, 2, 3, 0, 0, (9, 21))
    assert not ran and cs.launch_counts() == before
    assert not list(tmp_path.glob("*.so"))
