"""The overlap schedules on the K3 path (``pallas``), and K3 on windows,
against the JAX package on the CPU.

On the CPU K3's wrapper runs its plain version
(:func:`cuda_stencil.stencil_valid_plain`) on the same windows and pitches
the kernel takes on the card; ``chip_smoke.py`` (phase ``overlap_path``)
holds the kernel against it there. The JAX side runs its ``ShardedRunner``
with the valid-ghost Pallas kernel in interpret mode, as its own tests do,
on the 8 fake CPU devices of ``conftest.py``, and ``valid_fused`` with
``interpret=True``. Tolerance: exact bytes (integer plans; the one float32
divide is correctly rounded on both sides).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_stencil import filters as jfilters
from tpu_stencil.models.blur import IteratedConv2D as JaxModel
from tpu_stencil.ops import lowering as jlowering
from tpu_stencil.ops import pallas_stencil
from tpu_stencil.parallel.sharded import ShardedRunner as JaxRunner
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as tlowering
from tpu_stencil_torch.parallel import overlap
from tpu_stencil_torch.parallel.sharded import ShardedRunner

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_STENCIL_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "port.json"))
    monkeypatch.setenv("TPU_STENCIL_AUTOTUNE_CACHE", str(tmp_path / "j.json"))


def _img(shape, seed=81):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _count_k3(monkeypatch):
    """Count calls of K3's wrapper (on the CPU it runs the plain version,
    which the launch counter does not count)."""
    calls = []
    orig = cs.stencil_valid

    def spy(ext2, *a, **k):
        calls.append((tuple(ext2.shape), ext2.stride(0)))
        return orig(ext2, *a, **k)

    monkeypatch.setattr(cs, "stencil_valid", spy)
    return calls


# -- every K3 mode against the JAX package's same mode and off ----------------

K3_CASES = {
    # (mode, filter, shape, mesh, fuse)
    "fused_split_f1": ("fused-split", "gaussian", (32, 40, 3), (2, 2), 1),
    "fused_split_f2": ("fused-split", "gaussian", (32, 40, 3), (2, 2), 2),
    "fused_split_f8_grey": ("fused-split", "gaussian", (48, 48), (2, 2), 8),
    "edge_f1": ("edge", "gaussian", (32, 40, 3), (2, 2), 1),
    "edge_f2": ("edge", "gaussian", (32, 40, 3), (2, 2), 2),
    "edge_f8_grey": ("edge", "gaussian", (48, 48), (2, 2), 8),
    "split": ("split", "gaussian", (32, 40, 3), (2, 2), None),
    "masked": ("fused-split", "gaussian", (33, 41), (2, 4), None),
    "wide_halo_split": ("fused-split", "gaussian5", (48, 40), (2, 2), None),
    "wide_halo_edge": ("edge", "gaussian5", (48, 40), (2, 2), None),
    "direct_int_edge": ("edge", "edge", (24, 16, 3), (2, 2), 2),
    # Tiles of 16 rows at fuse 8: no ghost-free interior at the chunk's
    # depth, so fused-split runs that chunk whole, as the JAX one does.
    "degenerate_chunk": ("fused-split", "gaussian", (32, 40, 3), (2, 2), 8),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_modes_match_jax_and_off(case, monkeypatch):
    mode, name, shape, mesh, fuse = K3_CASES[case]
    img = _img(shape)
    c = shape[2] if len(shape) == 3 else 1
    n = mesh[0] * mesh[1]
    model = JaxModel(name, backend="pallas", fuse=fuse)
    jr = JaxRunner(model, shape[:2], c, mesh_shape=mesh,
                   devices=jax.devices()[:n], overlap=mode)
    want = jr.fetch(jr.run(jr.put(img), 5))
    calls = _count_k3(monkeypatch)
    runs = {}
    for m in (mode, "off"):
        r = ShardedRunner(IteratedConv2D(name, backend="pallas", fuse=fuse,
                                         device=CPU), shape[:2], c,
                          mesh_shape=mesh, devices=[CPU] * n, overlap=m)
        calls.clear()
        runs[m] = (r.fetch(r.run(r.put(img), 5)), r, len(calls))
    got, r, k3 = runs[mode]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, runs["off"][0])
    assert (r.backend, r.overlap, r.fuse) == ("pallas", jr.overlap, jr.fuse)
    # K3 calls: per chunk, one per tile under off, its pieces' otherwise.
    h = r.model.plan.halo
    th, tw = r.tile
    want_calls = n * sum(overlap.launches_per_chunk(r.overlap, th, tw, d * h)
                         for d in cs.launch_schedule(5, r.fuse))
    assert k3 == want_calls
    assert runs["off"][2] == n * len(cs.launch_schedule(5, runs["off"][1].fuse))


def test_edge_clamps_fuse_to_keep_an_interior():
    r = ShardedRunner(IteratedConv2D("gaussian5", backend="pallas",
                                     device=CPU), (48, 40), 1,
                      mesh_shape=(2, 2), devices=[CPU] * 4, overlap="edge")
    assert r.overlap == "edge"
    assert 2 * r.fuse * r.model.plan.halo < min(r.tile)


def test_k3_pieces_run_on_windows_without_copies_or_stitches(monkeypatch):
    # Every piece's input is a strided window of the slab (its row pitch
    # the slab's, not its own width), as thin as g = 8 lanes for grey at
    # fuse 8, and the schedule around K3 makes no torch.cat and no
    # .contiguous() copy (K3's plain version, which stands in for the
    # kernel on the CPU, is not counted).
    calls = _count_k3(monkeypatch)
    r = ShardedRunner(IteratedConv2D("gaussian", backend="pallas",
                                     device=CPU), (48, 48), 1,
                      mesh_shape=(2, 2), devices=[CPU] * 4, overlap="edge")
    assert r.fuse == 8  # 2 * 8 < 24: every chunk keeps an interior
    tiles = r.put(_img((48, 48)))
    counted = {"cat": 0, "contiguous": 0}
    inside = [0]

    def count(name, fn):
        def wrapped(*a, **k):
            if not inside[0]:
                counted[name] += 1
            return fn(*a, **k)
        return wrapped

    def plain_spy(*a, _plain=cs.stencil_valid_plain, **k):
        inside[0] += 1
        try:
            return _plain(*a, **k)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(cs, "stencil_valid_plain", plain_spy)
    monkeypatch.setattr(torch, "cat", count("cat", torch.cat))
    monkeypatch.setattr(torch.Tensor, "contiguous",
                        count("contiguous", torch.Tensor.contiguous))
    out = r.run(tiles, 8)
    assert counted == {"cat": 0, "contiguous": 0}
    g = 8 * r.model.plan.halo
    assert len(calls) == 4 * 9
    assert {stride for _, stride in calls} == {24 + 2 * g}
    # 24-lane windows: every piece's output 8 lanes wide and 8 rows tall.
    assert {shape for shape, _ in calls} == {(3 * g, 3 * g)}
    want = tlowering.iterate(torch.from_numpy(r.fetch(tiles)), 8,
                             r.model.plan).numpy()
    np.testing.assert_array_equal(r.fetch(out), want)


# -- K3 on strided, thin windows ------------------------------------------------


def _plans(name):
    return (jlowering.plan_filter(jfilters.get_filter(name)),
            tlowering.plan_filter(tfilters.get_filter(name)))


@pytest.mark.parametrize("channels,fuse,lane0", [
    (1, 8, 0),    # a grey 8-lane border at fuse 8, aligned origin
    (1, 8, 13),   # the same at an origin that is not 16-byte aligned
    (3, 2, 5),    # RGB, 6-lane interior, unaligned
    (3, 1, 32),   # RGB at fuse 1, 3-lane interior
])
def test_plain_on_a_thin_strided_window_matches_jax(channels, fuse, lane0):
    jplan, tplan = _plans("gaussian")
    g = fuse * tplan.halo
    gc = g * channels
    big = _img((40 + 2 * g, 96 + 3 * gc), seed=82)
    win = torch.from_numpy(big)[3:3 + 2 * g + 20, lane0:lane0 + 3 * gc]
    assert not win.is_contiguous() and win.stride(0) == big.shape[1]
    glob = (60, 300)
    row0, col0 = 10, 30
    want = np.asarray(pallas_stencil.valid_fused(
        jnp.asarray(np.ascontiguousarray(win.numpy())), jplan, fuse,
        channels, jnp.int32(row0), jnp.int32(col0), glob, interpret=True))
    got = cs.stencil_valid_plain(win, tplan, channels, fuse, row0, col0,
                                 glob)
    np.testing.assert_array_equal(got.numpy(), want)
    # Through the wrapper into a rectangle of a larger output.
    out_big = torch.zeros((30, 64), dtype=torch.uint8)
    out = out_big[2:22, 7:7 + gc]
    assert cs.valid_fused(win, tplan, fuse, channels, row0, col0, glob,
                          out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert out_big.sum() == int(want.astype(np.int64).sum())


def test_window_form_is_checked():
    _, tplan = _plans("gaussian")
    ext = torch.zeros((10, 30), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unit lane stride"):
        cs.stencil_valid(ext[:, ::2], tplan, 3, 1, 0, 0, (8, 24))
    with pytest.raises(ValueError, match="unit lane stride"):
        cs.stencil_valid(ext.t(), tplan, 3, 1, 0, 0, (8, 24))
    with pytest.raises(ValueError, match="out must be"):
        cs.stencil_valid(ext, tplan, 3, 1, 0, 0, (8, 24),
                         out=torch.zeros((8, 23), dtype=torch.uint8))
    assert cs.row_pitch(ext[2:3, 4:9]) == 5 and cs.row_pitch(ext[2:5]) == 30


def test_a_window_launch_on_the_card_never_takes_the_plain_version(
        monkeypatch):
    # A non-CPU window takes the kernel or raises: with the library failing
    # to load it raises, and a refused launch raises KernelLaunchError.
    _, tplan = _plans("gaussian")
    meta = torch.empty((40, 90), dtype=torch.uint8, device="meta")
    win = meta[4:14, 3:27]

    def no_lib(name):
        raise _build.KernelBuildError(f"no {name}")

    monkeypatch.setattr(_build, "load", no_lib)
    with pytest.raises(_build.KernelBuildError, match="stencil_valid"):
        cs.valid_fused(win, tplan, 1, 3, 0, 0, (10, 24))

    class Refusing:
        def stencil_valid_launch(self, *a):
            return 701

        def stencil_valid_error_string(self, code):
            return b"too many resources requested for launch"

    monkeypatch.setattr(cs, "_valid_lib", lambda: Refusing())
    monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: id(self))
    plain = []
    monkeypatch.setattr(cs, "stencil_valid_plain",
                        lambda *a, **k: plain.append(1))
    before = cs.launch_counts()
    with pytest.raises(cs.KernelLaunchError) as e:
        cs.valid_fused(win, tplan, 1, 3, 0, 0, (10, 24),
                       out=meta[20:28, 40:58])
    assert e.value.code == 701 and not plain
    assert cs.launch_counts() == before
