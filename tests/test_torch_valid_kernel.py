"""K3's plain version and wrapper against the JAX package's valid-ghost
Pallas kernel, run as the JAX package's own tests run it (``interpret=True``).

On the CPU :func:`cuda_stencil.stencil_valid` runs its plain version
(:func:`cuda_stencil.stencil_valid_plain`); the kernel itself runs only on
the card and is held against the same plain version by ``chip_smoke.py``
(phases ``k3`` and ``sharded_path``). Tolerance: exact byte equality —
every plan here is integer, and the one float32 divide is correctly
rounded on both sides.
"""

import ctypes

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
from tpu_stencil_torch.ops import lowering as tlowering

# A non-separable filter with a power-of-two divisor: a direct-int plan
# that finishes with a shift (edge is the direct-int plan that divides).
DIRECT16 = np.array([[1, 1, 1], [1, 8, 1], [1, 1, 1]])

# Tile (th, tw) at each position of a 3x3 grid over a 27x21 image.
TH, TW, GRID = 9, 7, (3, 3)
POSITIONS = {"corner": (0, 0), "edge": (0, 1), "interior": (1, 1)}


def _plans(name):
    if name == "direct16":
        return (jlowering.plan_filter(jfilters.Filter(DIRECT16, 16.0)),
                tlowering.plan_filter(tfilters.from_numpy(DIRECT16, 16)))
    return (jlowering.plan_filter(jfilters.get_filter(name)),
            tlowering.plan_filter(tfilters.get_filter(name)))


def _ext(plan, fuse, channels, seed=51):
    # Random bytes everywhere, ghosts past the global image included: both
    # kernels must use the input as given and re-zero only after each rep.
    g = fuse * plan.halo
    return np.random.default_rng(seed).integers(
        0, 256, (TH + 2 * g, (TW + 2 * g) * channels), dtype=np.uint8)


def _global(channels):
    return (TH * GRID[0], TW * GRID[1] * channels)


def test_direct16_is_a_shifting_direct_plan():
    jplan, tplan = _plans("direct16")
    assert tplan.kind == jplan.kind == "direct_int"
    assert tplan.shift == jplan.shift == 4


@pytest.mark.parametrize("position", list(POSITIONS))
@pytest.mark.parametrize("fuse", [1, 2, 8])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", ["gaussian", "box", "edge", "gaussian5",
                                  "direct16"])
def test_plain_matches_pallas_valid_fused(name, channels, fuse, position):
    jplan, tplan = _plans(name)
    i, j = POSITIONS[position]
    row0, col0 = i * TH, j * TW * channels
    ext = _ext(tplan, fuse, channels)
    want = np.asarray(pallas_stencil.valid_fused(
        jnp.asarray(ext), jplan, fuse, channels, jnp.int32(row0),
        jnp.int32(col0), _global(channels), interpret=True))
    got = cs.stencil_valid_plain(torch.from_numpy(ext), tplan, channels,
                                 fuse, row0, col0, _global(channels))
    assert got.shape == (TH, TW * channels)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gaussian", "edge"])
def test_cpu_wrapper_is_the_plain_version(name):
    _, tplan = _plans(name)
    ext = torch.from_numpy(_ext(tplan, 2, 3, seed=52))
    before = cs.launch_counts()
    got = cs.stencil_valid(ext, tplan, 3, 2, TH, 0, _global(3))
    np.testing.assert_array_equal(
        got.numpy(),
        cs.stencil_valid_plain(ext, tplan, 3, 2, TH, 0, _global(3)).numpy())
    np.testing.assert_array_equal(
        cs.valid_fused(ext, tplan, 2, 3, TH, 0, _global(3)).numpy(),
        got.numpy())
    out = torch.empty((TH, TW * 3), dtype=torch.uint8)
    assert cs.stencil_valid(ext, tplan, 3, 2, TH, 0, _global(3),
                            out=out) is out
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    assert cs.launch_counts() == before  # plain runs count no launch


def test_interior_tile_equals_single_device_run():
    # On a zero-padded image, the interior of every tile after `fuse` reps
    # is the single-device result's tile: the ghosts recompute the
    # neighbours' values exactly.
    _, tplan = _plans("gaussian")
    img = np.random.default_rng(53).integers(0, 256, (27, 21, 3), np.uint8)
    fuse = 3
    want = cs.iterate(torch.from_numpy(img), fuse, tplan).numpy()
    padded = np.pad(img, ((fuse, fuse), (fuse, fuse), (0, 0)))
    for i in range(GRID[0]):
        for j in range(GRID[1]):
            ext = padded[i * TH:(i + 1) * TH + 2 * fuse,
                         j * TW:(j + 1) * TW + 2 * fuse]
            got = cs.valid_fused(
                torch.from_numpy(np.ascontiguousarray(ext).reshape(
                    TH + 2 * fuse, -1)),
                tplan, fuse, 3, i * TH, j * TW * 3, _global(3))
            np.testing.assert_array_equal(
                got.numpy().reshape(TH, TW, 3),
                want[i * TH:(i + 1) * TH, j * TW:(j + 1) * TW])


def test_ext_without_interior_is_refused():
    _, tplan = _plans("gaussian")
    with pytest.raises(ValueError, match="no interior"):
        cs.stencil_valid(torch.zeros((16, 48), dtype=torch.uint8), tplan, 3,
                         8, 0, 0, (16, 48))


def test_cuda_call_without_a_library_raises(monkeypatch):
    # A non-CPU tensor never takes the plain version: with the library
    # loader failing, the wrapper raises (no fallback).
    def no_lib(name):
        raise _build.KernelBuildError(f"no {name}")

    monkeypatch.setattr(_build, "load", no_lib)
    _, tplan = _plans("gaussian")
    ext = torch.empty((12, 30), dtype=torch.uint8, device="meta")
    with pytest.raises(_build.KernelBuildError, match="stencil_valid"):
        cs.stencil_valid(ext, tplan, 3, 1, 0, 0, (10, 24))
    with pytest.raises(_build.KernelBuildError):
        cs.valid_fused(ext, tplan, 1, 3, 0, 0, (10, 24))


@pytest.mark.parametrize("name,th,fuse,block_h,want", [
    ("gaussian", 1260, 8, None, (32, 8)),     # the 2x2 reference tile
    ("gaussian", 5, 8, None, (8, 8)),         # 8-row aligned
    ("gaussian", 1260, 8, 64, (64, 8)),       # forced tile height
    ("gaussian", 1260, 40, None, (32, 40)),   # fits swar's 4 bytes/element
    ("gaussian7", 1260, 8, 128, (128, 8)),    # fits acc16's 3 bytes/element
    ("gaussian7", 1260, 40, None, (8, 19)),   # tile, then fuse cut
])
def test_valid_geometry_fits_shared_memory(name, th, fuse, block_h, want):
    _, tplan = _plans(name)
    got = cs.valid_geometry(tplan, th, 3, fuse, block_h)
    assert got == want
    assert cs.tile_smem_bytes(tplan, got[0], got[1], 3) <= cs.SMEM_LIMIT


def test_binding_mirrors_the_c_layout():
    # Eleven ints, then the input and output row pitches as 64-bit ints
    # at their natural alignment.
    assert ctypes.sizeof(cs._ValidGeometry) == 4 * 11 + 4 + 8 * 2
    assert cs._ValidGeometry.src_pitch.offset == 48
    assert cs._ValidGeometry.dst_pitch.offset == 56
    assert _build.SOURCES["stencil_valid"] == ("stencil_valid.cu",
                                               "stencil_tile.cuh")
    path = _build.library_path("stencil_valid")
    assert path.name.startswith("libstencil_valid-")
    assert path != _build.library_path("stencil_fused")
    assert set(cs.launch_counts()) == {"stencil_fused", "stencil_resident",
                                       "stencil_valid"}
