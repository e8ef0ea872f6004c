"""The warm-up before the compute window, against the JAX package's.

The JAX driver runs a fenced 0-rep warm-up call before its timer opens
(``prepare_engine``, and the sharded path's); the port launches each kernel
instance the window will launch once, on a scratch copy of the placed
input, before its window. On the CPU the wrappers run their plain
versions; a spy stands in for each kernel's launch (it counts as the
wrapper does, then runs the plain version) so the counts of the window and
of the warm-up can be read apart. Tolerance: exact bytes.
"""

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import filters
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 48, 64
GAUSS = lowering.plan_filter(filters.get_filter("gaussian"))


def _raw(tmp_path, channels, seed=5):
    shape = (H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    path = tmp_path / f"in{channels}.raw"
    img.tofile(path)
    return str(path), img


def _spy(monkeypatch, name):
    """Replace the kernel wrapper ``name`` with one that counts a launch
    as the wrapper does on a card, then runs the real wrapper (the plain
    version, on the CPU)."""
    real = getattr(cs, name)

    def fake(*args, **kwargs):
        fake.launches += 1
        return real(*args, **kwargs)

    fake.launches = 0
    monkeypatch.setattr(cs, name, fake)
    return fake


@pytest.mark.parametrize("reps,fuse,want", [
    (40, 8, [8]), (43, 8, [8, 1]), (5, 8, [1]), (0, 8, []), (9, 1, [1]),
])
def test_warm_depths_cover_every_launch_depth(reps, fuse, want):
    kernel, _, fz = cs.rep_loop_kernel(GAUSS, H, W * 3, 3, None, fuse, None,
                                       CPU)
    assert (kernel, fz) == ("stencil_fused", fuse)
    got = cs.warm_depths([reps], fz)
    assert got == want
    assert set(got) == set(cs.launch_schedule(reps, fuse))
    # Several calls: the union of their instances, largest first.
    assert cs.warm_depths([reps, 3, 0], fz) == sorted(
        set(want) | set(cs.launch_schedule(3, fuse)), reverse=True)


def test_warm_depths_deep_is_one_resident_launch():
    assert cs.rep_loop_kernel(GAUSS, H, W * 3, 3, None, None, "deep",
                              CPU) == ("stencil_resident", None, None)
    assert cs.warm_depths([40, 7], None) == [1]
    assert cs.warm_depths([0], None) == []
    # A forced geometry forces K1 at the deep depth.
    kernel, _, fz = cs.rep_loop_kernel(GAUSS, H, W * 3, 3, None, 4, "deep",
                                       CPU)
    assert (kernel, fz) == ("stencil_fused", 4)
    assert cs.warm_depths([40], fz) == [4]


@pytest.mark.parametrize("reps,every,traced,want", [
    (11, 0, False, [11]), (11, 3, False, [2, 3]), (9, 3, False, [3]),
    (11, 0, True, [1]), (0, 3, False, []),
])
def test_window_calls(reps, every, traced, want):
    assert tdriver._window_calls(reps, every, traced) == want


@pytest.mark.parametrize("schedule,kernel,window,warm", [
    (None, "stencil_fused", 4, 2),        # 11 = 8 + 1 + 1 + 1; warm 8, 1
    ("deep", "stencil_resident", 1, 1),
])
def test_timed_call_is_not_the_first_and_warmup_adds_no_launches(
        tmp_path, monkeypatch, schedule, kernel, window, warm):
    src, img = _raw(tmp_path, 3)
    spy = _spy(monkeypatch, kernel)
    calls = []
    real_forward = IteratedConv2D.forward

    def forward(self, x, repetitions):
        calls.append((int(repetitions), x.data_ptr(), x.clone()))
        return real_forward(self, x, repetitions)

    monkeypatch.setattr(IteratedConv2D, "forward", forward)
    argv = [src, str(W), str(H), "11", "rgb", "--backend", "pallas"]
    if schedule:
        argv += ["--schedule", schedule]
    cfg, _ = tconfig.parse_args(argv + ["--output", str(tmp_path / "t.raw")])
    res = tdriver.run_job(cfg, devices=[CPU])
    # The timed call (all 11 reps) is the last; calls came before it, on a
    # scratch copy, never on the placed input, which they left unchanged.
    assert calls[-1][0] == 11 and len(calls) >= 2
    timed_ptr = calls[-1][1]
    assert all(ptr != timed_ptr for _, ptr, _ in calls[:-1])
    assert np.array_equal(calls[-1][2].numpy(), img)
    assert res.launches[kernel] == window
    assert res.warmup_launches[kernel] == warm
    assert spy.launches == window + warm
    jcfg, _ = jconfig.parse_args(argv + ["--output", str(tmp_path / "j.raw")])
    jdriver.run_job(jcfg, devices=jax.devices("cpu")[:1])
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()


def test_torch_ops_path_warms_one_rep(tmp_path, monkeypatch):
    src, _ = _raw(tmp_path, 1)
    seen = []
    real = lowering.iterate

    def spy(x, reps, *a, **k):
        seen.append(int(reps))
        return real(x, reps, *a, **k)

    monkeypatch.setattr(lowering, "iterate", spy)
    cfg, _ = tconfig.parse_args([src, str(W), str(H), "7", "grey",
                                 "--backend", "xla", "--output",
                                 str(tmp_path / "o.raw")])
    tdriver.run_job(cfg, devices=[CPU])
    assert seen == [1, 7]


def test_zero_reps_warm_nothing(tmp_path, monkeypatch):
    src, img = _raw(tmp_path, 3)
    spy = _spy(monkeypatch, "stencil_fused")
    cfg, _ = tconfig.parse_args([src, str(W), str(H), "0", "rgb",
                                 "--backend", "pallas", "--output",
                                 str(tmp_path / "o.raw")])
    res = tdriver.run_job(cfg, devices=[CPU])
    assert spy.launches == 0 and res.warmup_launches["stencil_fused"] == 0
    assert (tmp_path / "o.raw").read_bytes() == img.tobytes()


def test_sharded_warmup_is_one_chunk_per_depth_off_the_window(
        tmp_path, monkeypatch):
    src, _ = _raw(tmp_path, 3)
    spy = _spy(monkeypatch, "stencil_valid")
    argv = [src, str(W), str(H), "11", "rgb", "--mesh", "2x2", "--backend",
            "pallas", "--output"]
    cfg, _ = tconfig.parse_args(argv + [str(tmp_path / "t.raw")])
    res = tdriver.run_job(cfg, devices=[CPU] * 4)
    # fuse 8 on 32x24 tiles: the window runs chunks 8, 1, 1, 1 on 4
    # tiles; the warm-up one chunk of 8 and one of 1.
    assert res.launches["stencil_valid"] == 16
    assert res.warmup_launches["stencil_valid"] == 8
    assert spy.launches == 24
    jcfg, _ = jconfig.parse_args(argv + [str(tmp_path / "j.raw")])
    jdriver.run_job(jcfg, devices=jax.devices()[:4])
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()


def test_sharded_warmup_leaves_the_tiles_alone():
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    img = np.random.default_rng(3).integers(0, 256, (H, W), np.uint8)
    model = IteratedConv2D("gaussian", backend="pallas", device=CPU)
    runner = ShardedRunner(model, (H, W), 1, mesh_shape=(2, 2),
                           devices=[CPU] * 4)
    tiles = runner.put(img)
    before = [[t.clone() for t in row] for row in tiles]
    assert runner.warm_reps([11]) == [8, 1]
    assert runner.warm_reps([3, 8]) == [8, 1]
    assert runner.warm_reps([0]) == []
    runner.warmup(tiles, runner.warm_reps([11]))
    for row, brow in zip(tiles, before):
        for t, b in zip(row, brow):
            assert torch.equal(t, b)
