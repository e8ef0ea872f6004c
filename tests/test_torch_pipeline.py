"""The port's temporal pipeline (``--pipe-stages K``) against the JAX
package's.

The same seeded clip goes through the JAX package's ``run_stream`` over
its 8 forced host devices and through the port's over ``[cpu] * n``:
every output byte equal (integer plans: exact), for grey and RGB, reps
below, at and above K, fewer frames than stages, the degenerate K = 1, the
three-axis composition and the fan of sharded groups. Mirrors
``tests/test_pipeline.py`` case for case (the runner cache's key, the
topology in the checkpoint sidecar, a resume, the explicit and auto
resolution with its roofline gate and cache, the stage partition, the
fill and drain, the CLI and the gauge), then the port's own traps: the
tick against the JAX package's tick by tick (the port runs each stage's
own rep count where the JAX package masks a remainder rep on every
stage), the carry never sharing storage with the zero tiles or a tick's
output, a resume under another (G, K, RxC), the models at the H100's
constants, and the sweep's ``pipe`` row.

No assertion reads a wall clock; every run of the port has a deadline.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tpu_stencil import config as jconfig
from tpu_stencil.models.blur import IteratedConv2D as JModel
from tpu_stencil.parallel import pipeline as jpipe
from tpu_stencil.runtime import checkpoint as jckpt
from tpu_stencil.runtime import roofline as jroofline
from tpu_stencil.stream import cli as jstream_cli
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import obs
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.parallel import pipeline as ppipe
from tpu_stencil_torch.parallel import sharded as psharded
from tpu_stencil_torch.resilience import faults as tfaults
from tpu_stencil_torch.runtime import autotune, bench_sweep
from tpu_stencil_torch.runtime import checkpoint as ckpt
from tpu_stencil_torch.runtime import roofline
from tpu_stencil_torch.stream import cli as stream_cli

from test_torch_stream import (_bounded, _jax_stream, _make_clip, _port_cfg,
                               _port_stream)

torch.set_num_threads(1)

CPU = torch.device("cpu")
GREY, RGB = tconfig.ImageType.GREY, tconfig.ImageType.RGB


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_STENCIL_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    tfaults.clear()
    obs.reset()
    psharded.clear_runner_cache()
    yield
    tfaults.reset()
    obs.reset()
    psharded.clear_runner_cache()


def _run(cfg, n_dev, **kw):
    return _port_stream(cfg, devices=[CPU] * n_dev, **kw)


# -- the pipeline against the JAX package's, byte for byte

@pytest.mark.parametrize("image_type,reps,stages,n,depth", [
    (RGB, 5, 4, 7, 2),    # reps % K != 0, steady state reached
    (GREY, 3, 4, 2, 2),   # fewer frames than stages: the drain rules
    (GREY, 8, 4, 4, 1),   # frames == stages
    (RGB, 4, 2, 5, 4),    # a shallow pipeline, depth 4
    (GREY, 2, 4, 1, 2),   # one frame through a deep pipeline, reps < K
    (GREY, 3, 1, 3, 2),   # K = 1: the single-device engine
])
def test_pipeline_stream_matches_jax(tmp_path, image_type, reps, stages, n,
                                     depth):
    h, w, ch = 20, 16, image_type.channels
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=stages * 10 + n)
    want = _jax_stream(clip_path, h, w, image_type, reps,
                       str(tmp_path / "jax.raw"), frames=n,
                       pipe_stages=stages, pipeline_depth=depth)
    out = str(tmp_path / "out.raw")
    res = _run(_port_cfg(clip_path, h, w, image_type, reps, output=out,
                         frames=n, pipe_stages=stages, pipeline_depth=depth),
               stages)
    assert res.frames == n and res.pipe_stages == stages
    assert res.n_devices == stages
    assert res.backend == ("xla" if stages > 1 else res.backend)
    assert open(out, "rb").read() == want


def test_pipeline_reps_below_stage_count(tmp_path):
    h, w, reps, stages, n = 16, 12, 2, 4, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=3)
    want = _jax_stream(clip_path, h, w, GREY, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    res = _run(_port_cfg(clip_path, h, w, GREY, reps, output=out, frames=n,
                         pipe_stages=stages), stages)
    assert res.frames == n
    assert open(out, "rb").read() == want


@pytest.mark.parametrize("reps", [0, 1])
def test_pipeline_zero_and_one_rep(tmp_path, reps):
    # Every stage, or every stage but the first, passes its frame through.
    h, w, n = 12, 10, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=reps)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    _run(_port_cfg(clip_path, h, w, RGB, reps, output=out, frames=n,
                   pipe_stages=3), 3)
    assert open(out, "rb").read() == want


# -- the three axes

def test_three_axis_composition_matches_jax(tmp_path):
    h, w, reps, n = 24, 20, 3, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=8)
    kw = dict(frames=n, mesh_frames=2, pipe_stages=2, shard_frames=(2, 1),
              shard_min_pixels=1)
    want = _jax_stream(clip_path, h, w, GREY, reps, str(tmp_path / "j.raw"),
                       **kw)
    out = str(tmp_path / "out.raw")
    res = _run(_port_cfg(clip_path, h, w, GREY, reps, output=out, **kw), 8)
    assert res.frames == n and res.n_devices == 8 and res.pipe_stages == 2
    assert res.shard_frames == (2, 1) and res.per_device_frames == [3, 2]
    assert open(out, "rb").read() == want


def test_fan_of_sharded_groups_matches_jax(tmp_path):
    h, w, reps, n = 24, 20, 2, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=9)
    kw = dict(frames=n, mesh_frames=2, shard_frames=(2, 2),
              shard_min_pixels=1)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       **kw)
    out = str(tmp_path / "out.raw")
    res = _run(_port_cfg(clip_path, h, w, RGB, reps, output=out, **kw), 8)
    assert res.frames == n and res.n_devices == 8 and res.pipe_stages == 1
    assert open(out, "rb").read() == want


def test_indivisible_frame_through_sharded_stages(tmp_path):
    # The pad mask on every stage's tiles: 21 x 17 over 2x2, K = 2.
    h, w, reps, n = 21, 17, 5, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=11)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    _run(_port_cfg(clip_path, h, w, RGB, reps, output=out, frames=n,
                   pipe_stages=2, shard_frames=(2, 2), shard_min_pixels=1), 8)
    assert open(out, "rb").read() == want


# -- the tick against the JAX package's tick

@pytest.mark.parametrize("reps,stages", [(7, 3), (2, 4), (5, 1)])
def test_tick_equals_the_jax_packages_tick_by_tick(reps, stages):
    h, w = 14, 11
    frames = np.random.default_rng(reps).integers(0, 256, (stages + 3, h, w),
                                                  dtype=np.uint8)
    jr = jpipe.PipelineRunner(JModel("gaussian", backend="xla"), (h, w), 1,
                              stages, devices=jax.devices()[:stages])
    tr = ppipe.PipelineRunner(IteratedConv2D("gaussian", device="cpu"),
                              (h, w), 1, stages, devices=[CPU] * stages)
    jcarry, tcarry = jr.warm(reps), tr.warm(reps)
    d0 = jr.stage0_devices[0]
    last = {d.id for d in jr.last_devices}
    feed = list(frames) + [None] * (stages - 1)
    for f in feed:
        if f is None:
            jinp, tinp = jr.zero_input(), tr.zero_input()
        else:
            jinp = jr.assemble_input({d0.id: jax.device_put(f[None].copy(),
                                                            d0)})
            tinp = tr.assemble_input([torch.from_numpy(f.copy())])
        jcarry, jout = jr.tick(jcarry, jinp, reps)
        tcarry, tout = tr.tick(tcarry, tinp, reps)
        jlast = [np.asarray(s.data)[0] for s in jout.addressable_shards
                 if s.device.id in last]
        assert np.array_equal(jlast[0], tout[0][0].numpy())


def test_stage_rep_counts_partition():
    assert ppipe.stage_rep_counts(10, 4) == (3, 3, 2, 2)
    assert ppipe.stage_rep_counts(2, 4) == (1, 1, 0, 0)
    for reps in range(13):
        for k in range(1, 6):
            counts = ppipe.stage_rep_counts(reps, k)
            assert counts == jpipe.stage_rep_counts(reps, k)
            assert sum(counts) == reps and len(counts) == k
            assert max(counts) - min(counts) <= 1


# -- buffers: the carry never shares storage

def _ptrs(grid):
    return {t.untyped_storage().data_ptr() for row in grid for t in row}


@pytest.mark.parametrize("reps,stages,shard", [
    (0, 3, (1, 1)), (2, 4, (1, 1)), (5, 2, (2, 1)), (3, 1, (1, 1)),
])
def test_carry_and_zero_tiles_never_share_storage(reps, stages, shard):
    r, c = shard
    runner = ppipe.PipelineRunner(IteratedConv2D("gaussian", device="cpu"),
                                  (12, 10), 3, stages, shard_shape=shard,
                                  devices=[CPU] * (stages * r * c))
    zero = runner.zero_input()
    carry = runner.warm(reps)
    rng = np.random.default_rng(0)
    for tick in range(stages + 3):
        zeros = _ptrs(zero)
        carries = set().union(*(_ptrs(g) for g in carry[1:]))
        assert not zeros & carries
        fed = tick < 3
        inp = (runner.assemble_input([
            torch.from_numpy(rng.integers(0, 256, runner.local_shape,
                                          dtype=np.uint8))
            for _ in range(r * c)]) if fed else zero)
        carry, out = runner.tick(carry, inp, reps)
        # The finished frame is no carry buffer and no zero tile: the next
        # tick rewrites the carry in place while the drain still reads it.
        assert not _ptrs(out) & (carries | zeros)
        assert all(int(t.abs().sum()) == 0 for row in zero for t in row)


# -- the runner cache

def test_runner_cache_never_shares_across_stage_counts():
    model = IteratedConv2D("gaussian", backend="xla", device="cpu")
    k2 = ppipe.pipeline_runner_key(model, (8, 8), 1, 2, (1, 1), [CPU] * 2)
    k4 = ppipe.pipeline_runner_key(model, (8, 8), 1, 4, (1, 1), [CPU] * 4)
    assert k2 != k4
    ks = psharded.runner_key(model, (8, 8), 1, (2, 1), [CPU] * 2, "off")
    assert ks != k2
    r2 = ppipe.shared_pipeline_runner(model, (8, 8), 1, 2, devices=[CPU] * 2)
    assert r2 is not None and psharded.runner_cache_len() == 1
    assert ppipe.shared_pipeline_runner(model, (8, 8), 1, 2,
                                        devices=[CPU] * 2) is r2
    r4 = ppipe.shared_pipeline_runner(model, (8, 8), 1, 4, devices=[CPU] * 4)
    assert r4 is not None and r4 is not r2
    assert psharded.runner_cache_len() == 2
    # A geometry the stages cannot serve is cached as such.
    assert ppipe.shared_pipeline_runner(
        IteratedConv2D("gaussian7", device="cpu"), (2, 40), 1, 2, (2, 1),
        devices=[CPU] * 4) is None


# -- checkpoint: the three-axis topology

def _ckpt_cfgs(tmp_path, **kw):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 4, 12, 10, 1, seed=7)
    base = dict(input=str(clip_path), width=10, height=12, repetitions=1,
                output=str(tmp_path / "out.raw"), frames=4, **kw)
    return (jconfig.StreamConfig(**base, image_type=jconfig.ImageType.GREY),
            tconfig.StreamConfig(**base, image_type=GREY))


def test_checkpoint_records_pipe_stages(tmp_path):
    jcfg, cfg = _ckpt_cfgs(tmp_path, pipe_stages=4, checkpoint_every=2)
    path = str(tmp_path / "out.raw") + ".stream.ckpt.json"
    jckpt.save_stream_progress(jcfg, 2, pipe_stages=4)
    jmeta = json.load(open(path))
    ckpt.save_stream_progress(cfg, 2, pipe_stages=4)
    meta = json.load(open(path))
    assert meta["pipe_stages"] == jmeta["pipe_stages"] == 4
    assert ckpt.restore_stream_progress(cfg, pipe_stages=4) == 2
    with pytest.raises(ckpt.MeshCursorMismatch) as ei:
        ckpt.restore_stream_progress(cfg, pipe_stages=2)
    assert "4" in str(ei.value) and "--pipe-stages 2" in str(ei.value)
    with pytest.raises(ckpt.MeshCursorMismatch):
        ckpt.restore_stream_progress(cfg)
    ckpt.save_stream_progress(cfg, 2)
    with pytest.raises(ckpt.MeshCursorMismatch):
        ckpt.restore_stream_progress(cfg, pipe_stages=4)


def test_checkpoint_records_full_composed_topology(tmp_path):
    _, cfg = _ckpt_cfgs(tmp_path, mesh_frames=2, pipe_stages=2,
                        shard_frames=(2, 1), shard_min_pixels=1)
    ckpt.save_stream_progress(cfg, 2, mesh_devices=2, cursors=[1, 1],
                              shard_frames=(2, 1), pipe_stages=2)
    meta = json.load(open(str(tmp_path / "out.raw") + ".stream.ckpt.json"))
    assert meta["mesh_devices"] == 2 and meta["shard_frames"] == [2, 1]
    assert meta["pipe_stages"] == 2
    assert ckpt.restore_stream_progress(
        cfg, mesh_devices=2, shard_frames=(2, 1), pipe_stages=2) == 2
    for kw in (dict(mesh_devices=4, shard_frames=(2, 1), pipe_stages=2),
               dict(mesh_devices=2, shard_frames=(1, 2), pipe_stages=2),
               dict(mesh_devices=2, shard_frames=(2, 1), pipe_stages=4)):
        with pytest.raises(ckpt.MeshCursorMismatch):
            ckpt.restore_stream_progress(cfg, **kw)


@pytest.mark.parametrize("wrote,resumes", [
    (dict(pipe_stages=2), dict(pipe_stages=4)),
    (dict(mesh_frames=2, pipe_stages=2, shard_frames=(2, 1)),
     dict(mesh_frames=2, pipe_stages=2, shard_frames=(1, 2))),
    (dict(mesh_frames=2, pipe_stages=2, shard_frames=(2, 1)),
     dict(mesh_frames=2, pipe_stages=1, shard_frames=(2, 1))),
])
def test_resume_under_another_topology_fails_typed(tmp_path, wrote,
                                                   resumes):
    h, w, n = 12, 10, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=12)
    out = str(tmp_path / "out.raw")
    cfg = _port_cfg(clip_path, h, w, GREY, 1, output=out, frames=n,
                    checkpoint_every=1, shard_min_pixels=1, **wrote)
    g = wrote.get("mesh_frames", 1)
    ckpt.save_stream_progress(
        cfg, 2, mesh_devices=g, cursors=[2, 3] if g > 1 else None,
        shard_frames=wrote.get("shard_frames"),
        pipe_stages=wrote["pipe_stages"])
    open(out, "wb").write(b"\0" * (2 * h * w))
    with pytest.raises(ckpt.MeshCursorMismatch):
        _run(dataclasses.replace(cfg, **resumes), 8, resume=True)


def test_pipe_resume_mid_stream(tmp_path):
    h, w, reps, stages, n = 16, 12, 3, 2, 6
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=11)
    want = _jax_stream(clip_path, h, w, GREY, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    cfg = _port_cfg(clip_path, h, w, GREY, reps, output=out, frames=n,
                    pipe_stages=stages, checkpoint_every=1)
    open(out, "wb").write(want[:3 * h * w])
    ckpt.save_stream_progress(cfg, 3, pipe_stages=stages)
    res = _run(cfg, stages, resume=True)
    assert res.skipped == 3 and res.frames == n - 3
    assert open(out, "rb").read() == want


@pytest.mark.chaos
def test_pipe_engine_restart_from_checkpoint(tmp_path):
    h, w, reps, n = 16, 12, 3, 6
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=14)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    tfaults.configure("compute:frame=3")
    res = _run(_port_cfg(clip_path, h, w, RGB, reps, output=out, frames=n,
                         pipe_stages=3, checkpoint_every=1), 3)
    assert res.restarts == 1 and res.pipe_stages == 3
    assert open(out, "rb").read() == want


# -- resolution: explicit, auto, the roofline gate

def test_explicit_pipe_stages_overflow_fails_loud(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 1, 10, 8, 1)
    cfg = _port_cfg(clip_path, 10, 8, GREY, 1, frames=1, pipe_stages=16,
                    output="null")
    with pytest.raises(ValueError, match="16 devices.*have"):
        _run(cfg, 8)
    cfg = _port_cfg(clip_path, 10, 8, GREY, 1, frames=1, mesh_frames=2,
                    pipe_stages=4, shard_frames=(2, 1), shard_min_pixels=1,
                    output="null")
    with pytest.raises(ValueError, match="16 devices.*have"):
        _run(cfg, 8)


def _auto_cfg(reps, frames=None):
    return tconfig.StreamConfig(
        input="synthetic", width=64, height=64, repetitions=reps,
        image_type=GREY, output="null", frames=frames, pipe_stages=0)


def _jauto_cfg(reps, frames=None):
    return jconfig.StreamConfig(
        input="synthetic", width=64, height=64, repetitions=reps,
        image_type=jconfig.ImageType.GREY, output="null", frames=frames,
        pipe_stages=0)


def test_auto_pipe_never_enables_a_measured_loss():
    cfg = _auto_cfg(reps=500)
    devs = [CPU] * 8
    for arms, want in (((1.0, 0.5), 8), ((0.5, 1.0), 1), ((1.0, 1.0), 1)):
        assert ppipe.resolve_pipe_stages(cfg, devs,
                                         measure=lambda *a: arms) == want
        assert jpipe.resolve_pipe_stages(_jauto_cfg(500), jax.devices(),
                                         measure=lambda *a: arms) == want
    assert ppipe.resolve_pipe_stages(
        cfg, devs[:1], measure=lambda *a: pytest.fail("probed")) == 1


@pytest.mark.parametrize("one_card", [False, True])
def test_auto_pipe_roofline_gate_skips_probe(capsys, one_card):
    cfg = _auto_cfg(reps=1, frames=3)
    devs = [CPU] * 8 if one_card else [torch.device("cpu", i)
                                       for i in range(8)]
    pick = ppipe.resolve_pipe_stages(
        cfg, devs, measure=lambda *a: pytest.fail("probed a modeled loss"))
    assert pick == 1
    assert "probe skipped" in capsys.readouterr().err


def test_auto_pipe_warm_cache_pays_zero_probe_frames(capsys):
    cfg = _auto_cfg(reps=500)
    devs = [CPU] * 8
    autotune.store_stream_verdict(
        "pipeline", (64, 64, 1), 500, cfg.pipeline_depth, "pipe8",
        {"pick": 8, "single_us": 2.0, "pipe_us": 1.0},
        autotune.stream_cfg_token(cfg), device=CPU)
    assert ppipe.resolve_pipe_stages(
        cfg, devs, measure=None) == 8
    assert "warm cache" in capsys.readouterr().err


def test_auto_pipe_measures_and_persists(tmp_path, monkeypatch):
    cfg = _auto_cfg(reps=500, frames=4)
    devs = [CPU] * 2
    calls = []
    monkeypatch.setattr(ppipe, "measure_pipeline_ab",
                        lambda *a, **k: calls.append(1) or (1.0, 2.0))
    assert ppipe.resolve_pipe_stages(cfg, devs) == 1
    assert ppipe.resolve_pipe_stages(cfg, devs) == 1
    assert calls == [1]
    store = autotune._load_cache()
    key = next(k for k in store if "|stream|pipeline|" in k)
    assert store[key]["pick"] == 1
    assert {"single_us", "pipe_us"} <= set(store[key])


def test_measured_pipeline_ab_streams_both_arms():
    cfg = tconfig.StreamConfig(
        input="synthetic", width=32, height=32, repetitions=8,
        image_type=GREY, output="null", frames=4, pipe_stages=0)
    t_single, t_pipe = _bounded(ppipe.measure_pipeline_ab, cfg, [CPU] * 2,
                                stages=2)
    assert t_single > 0 and t_pipe > 0


# -- the models at the H100's constants

def test_pipeline_fill_drain_factor():
    for frames in (None, 0, 1, 2, 4, 16, 256):
        for k in (1, 2, 4, 8):
            assert roofline.pipeline_fill_drain_factor(frames, k) == \
                jroofline.pipeline_fill_drain_factor(frames, k)
    assert roofline.pipeline_fill_drain_factor(1, 4) == pytest.approx(0.25)


def test_pipeline_roofline_by_hand():
    fb = 64 * 64
    hbm, link, pcie = 3.35e12, 450e9, 64e9
    per_rep = max(2 * fb / hbm, fb * 5 / (67e12 / 4))  # xla gaussian
    for one_card, hop in ((False, link), (True, hbm / 2)):
        st = roofline.pipeline_stream_stage_seconds(
            fb, 400, "xla", "gaussian", 64, pipe_stages=4, one_card=one_card)
        assert st["compute"] == pytest.approx(100 * per_rep + fb / hop)
        assert st["h2d"] == st["d2h"] == pytest.approx(fb / pcie)
        pipe = roofline.pipeline_stream_frames_per_second(
            fb, 400, "xla", "gaussian", 64, pipe_stages=4, frames=16,
            one_card=one_card)
        assert pipe == pytest.approx((16 / 19) / max(st.values()))
    solo = roofline.pipeline_stream_stage_seconds(fb, 400, "xla", "gaussian",
                                                  64, pipe_stages=1)
    assert solo["compute"] == pytest.approx(400 * per_rep)
    assert roofline.pipeline_stream_frames_per_second(
        fb, 400, "xla", "gaussian", 64, pipe_stages=4) > \
        roofline.stream_frames_per_second(fb, 400, "xla", "gaussian", 64)
    assert roofline.pipeline_stream_frames_per_second(
        fb, 1, "xla", "gaussian", 64, pipe_stages=4, frames=2) < \
        roofline.stream_frames_per_second(fb, 1, "xla", "gaussian", 64)


def test_choose_stream_topology_never_pipeline_on_modeled_loss():
    for reps, frames in ((1, 2), (1, 4), (2, 3)):
        for one_card in (False, True):
            pick = autotune.choose_stream_topology(
                (64, 64, 1), reps, 2, 8, frames=frames, one_card=one_card)
            assert pick != "pipeline", (reps, frames)
    assert autotune.choose_stream_topology((64, 64, 1), 400, 2, 1) == \
        "single"


# -- CLI, gauge, sweep

def test_cli_pipe_stream_matches_jax_cli(tmp_path, capsys):
    h, w, reps, n, stages = 16, 12, 2, 4, 2
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=6)
    args = [str(clip_path), str(w), str(h), str(reps), "grey", "--frames",
            str(n), "--pipe-stages", str(stages)]
    jout = str(tmp_path / "j.raw")
    assert jstream_cli.main(args + ["--output", jout]) == 0
    capsys.readouterr()
    out, stats = str(tmp_path / "out.raw"), str(tmp_path / "stats.json")
    rc = _bounded(stream_cli.main, args + ["--output", out, "--platform",
                                           "cpu", "--stats-json", stats,
                                           "--breakdown"])
    assert rc == 0
    text = capsys.readouterr().out
    assert f"pipe-stages={stages}" in text
    assert "modeled pipeline bound" in text and "fill/drain factor" in text
    payload = json.load(open(stats))
    assert payload["pipe_stages"] == stages and payload["n_devices"] == stages
    assert open(out, "rb").read() == open(jout, "rb").read()


def test_cli_resume_under_another_topology_exits_as_the_jax_cli(tmp_path,
                                                                capsys):
    h, w, n = 12, 10, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=13)
    out = str(tmp_path / "out.raw")
    args = [str(clip_path), str(w), str(h), "1", "grey", "--frames", str(n),
            "--output", out, "--checkpoint-every", "1", "--resume",
            "--pipe-stages", "4"]
    rcs = []
    for main, save, extra in (
            (jstream_cli.main, jckpt.save_stream_progress, []),
            (stream_cli.main, ckpt.save_stream_progress,
             ["--platform", "cpu"])):
        cfg = _port_cfg(clip_path, h, w, GREY, 1, output=out, frames=n,
                        checkpoint_every=1, pipe_stages=2)
        save(cfg, 2, pipe_stages=2)
        open(out, "wb").write(b"\0" * (2 * h * w))
        rcs.append(_bounded(main, args + extra))
        assert "--pipe-stages 4" in capsys.readouterr().err
    # A usage error, as the JAX package's CLI reports it.
    assert rcs == [2, 2]


def test_pipe_gauge_reports_what_ran(tmp_path):
    h, w, n = 16, 12, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=4)
    _run(_port_cfg(clip_path, h, w, GREY, 2, output="null", frames=n,
                   pipe_stages=2), 2)
    assert obs.snapshot()["gauges"]["stream_pipe_stages"]["value"] == 2
    _run(_port_cfg(clip_path, h, w, GREY, 2, output="null", frames=n), 1)
    assert obs.snapshot()["gauges"]["stream_pipe_stages"]["value"] == 0


def test_sweep_pipe_row_is_exact():
    rows = bench_sweep.run_sweep(quick=True, backends=["xla"], device="cpu",
                                 sizes=[24], width=16, pipe_stages=3)
    pipe = [r for r in rows if r["backend"] == "xla:pipe3"]
    assert len(pipe) == 1 and pipe[0]["exact"] is True
    assert pipe[0]["size"] == "16x24 pipe3" and pipe[0]["us_per_rep"] > 0
