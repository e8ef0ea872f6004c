"""The port's spatially sharded stream (``--shard-frames``) against the JAX
package's.

The same seeded clip goes through the JAX package's ``run_stream`` and
through the port's sharded stream over ``[cpu] * R*C`` (the sharded
runner: torch ops, or K3's plain version under ``--backend pallas``,
under every ``--overlap`` mode): every output byte equal (integer plans:
exact). Sharding changes where a frame computes, never what, so the
reference is the JAX package's stream on one device: its own sharded
stream at depth >= 2 on the CPU now and then writes a wrong byte (its
staging tile is rewritten while an earlier frame's ``device_put``, which
may alias host memory on the CPU, is still read), and a reference must
not be flaky. Mirrors ``tests/test_shardstream.py`` case for
case: the routing threshold, the device-count and geometry refusals, the
config and CLI, the topology in the checkpoint sidecar and a resume under
another, the engine restart, the torn staging tile, the witness, the
frame too large for one device, the per-shard spans, the auto A/B and its
cache, the roofline model at the H100's constants, the breakdown, and
``TileScatter``. The JAX test of the cache shared with the serving engine
waits for the port's serving slice; here the runner cache's key and its
hit and miss counters are pinned without it.

No assertion reads a wall clock; every run of the port has a deadline.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tpu_stencil import config as jconfig
from tpu_stencil.runtime import checkpoint as jckpt
from tpu_stencil.stream import cli as jstream_cli
from tpu_stencil.stream import frames as jframes
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import obs
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.parallel import sharded as psharded
from tpu_stencil_torch.resilience import faults as tfaults
from tpu_stencil_torch.runtime import autotune
from tpu_stencil_torch.runtime import checkpoint as ckpt
from tpu_stencil_torch.runtime import roofline
from tpu_stencil_torch.stream import cli as stream_cli
from tpu_stencil_torch.stream import frames as frames_io
from tpu_stencil_torch.stream import sharded as shardstream
from tpu_stencil_torch.stream.engine import StreamFailure

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


def _cfg(clip_path, h, w, image_type, reps, **kw):
    kw.setdefault("shard_min_pixels", 1)
    return _port_cfg(clip_path, h, w, image_type, reps, **kw)


def _run(cfg, n_dev, **kw):
    return _port_stream(cfg, devices=[CPU] * n_dev, **kw)


# -- the sharded stream against the JAX package's, byte for byte ----------

@pytest.mark.parametrize("image_type,depth,shard,backend,overlap", [
    (RGB, 2, (2, 2), "auto", "edge"),
    (GREY, 1, (1, 2), "auto", "edge"),
    (GREY, 4, (2, 2), "pallas", "edge"),
    (RGB, 2, (1, 2), "pallas", "edge"),
    (RGB, 1, (2, 2), "pallas", "off"),
    (GREY, 2, (2, 1), "pallas", "fused-split"),
])
def test_shard_stream_matches_jax(tmp_path, image_type, depth, shard,
                                  backend, overlap):
    h, w, reps, n = 22, 18, 9, 4
    ch = image_type.channels
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=depth)
    want = _jax_stream(clip_path, h, w, image_type, reps,
                       str(tmp_path / "jax.raw"), frames=n,
                       pipeline_depth=depth)
    out = str(tmp_path / "out.raw")
    res = _run(_cfg(clip_path, h, w, image_type, reps, output=out, frames=n,
                    pipeline_depth=depth, shard_frames=shard,
                    backend=backend, overlap=overlap), shard[0] * shard[1])
    assert res.frames == n and res.shard_frames == shard
    assert res.n_devices == shard[0] * shard[1] and res.pipe_stages == 1
    assert res.backend == ("pallas" if backend == "pallas" else "xla")
    assert open(out, "rb").read() == want


def test_shard_stream_overlap_off_also_matches(tmp_path):
    h, w, reps, n = 16, 14, 2, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=9)
    want = _jax_stream(clip_path, h, w, GREY, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    _run(_cfg(clip_path, h, w, GREY, reps, output=out, frames=n,
              shard_frames=(2, 2), overlap="off"), 4)
    assert open(out, "rb").read() == want


def test_shard_stream_indivisible_frame_pads_and_crops(tmp_path):
    # 21 x 19 over 2x2: the tiles carry a pad the scatter zeroes once and
    # the gather crops; the runner re-zeroes it every rep.
    h, w, reps, n = 21, 19, 5, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=12)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    _run(_cfg(clip_path, h, w, RGB, reps, output=out, frames=n,
              shard_frames=(2, 2), backend="pallas"), 4)
    assert open(out, "rb").read() == want


# -- the process-shared runner cache ---------------------------------------

def test_runner_cache_key_hits_and_misses(tmp_path):
    h, w, n = 18, 14, 2
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=3)
    cfg = _cfg(clip_path, h, w, GREY, 2, output="null", frames=n,
               shard_frames=(2, 2))
    _run(cfg, 4)
    assert psharded.runner_cache_len() == 1
    counters = obs.snapshot()["counters"]
    assert counters["sharded_runner_misses_total"] == 1
    assert "sharded_runner_hits_total" not in counters
    # A second run of the same geometry is a hit: nothing resolves again.
    _run(cfg, 4)
    counters = obs.snapshot()["counters"]
    assert counters["sharded_runner_hits_total"] == 1
    assert psharded.runner_cache_len() == 1
    # The key holds everything the runner depends on.
    model = IteratedConv2D("gaussian", device="cpu")
    devs = [CPU] * 4
    key = psharded.runner_key(model, (h, w), 1, (2, 2), devs, "edge")
    assert key != psharded.runner_key(model, (h, w), 1, (2, 2), devs, "off")
    assert key != psharded.runner_key(model, (h, w), 3, (2, 2), devs, "edge")
    assert key != psharded.runner_key(model, (h, w), 1, (1, 4), devs, "edge")
    assert key != psharded.runner_key(model, (h, w), 1, (2, 2), devs, "edge",
                                      pipe_stages=2)
    r1 = psharded.shared_runner(model, (h, w), 1, (2, 2), devs, "edge")
    assert psharded.shared_runner(model, (h, w), 1, (2, 2), devs,
                                  "edge") is r1
    # An explicit RxC and the default grid that resolves alike share one.
    assert psharded.shared_runner(model, (h, w), 1, None, devs,
                                  "edge") is r1


def test_runner_cache_remembers_an_unservable_geometry():
    model = IteratedConv2D("gaussian7", device="cpu")
    reg = obs.registry()
    for _ in range(2):
        assert psharded.shared_runner(model, (2, 300), 1, (2, 2), [CPU] * 4,
                                      registry=reg) is None
    # The refusal is cached: one build (the miss), then a hit.
    counters = obs.snapshot()["counters"]
    assert counters["sharded_runner_misses_total"] == 1
    assert counters["sharded_fallbacks_total"] == 1
    assert counters["sharded_runner_hits_total"] == 1


def test_runner_cache_is_bounded():
    model = IteratedConv2D("gaussian", device="cpu")
    reg = obs.registry()
    for h in range(8, 8 + psharded.RUNNER_CACHE_CAP + 2):
        psharded.shared_runner(model, (h, 8), 1, (2, 1), [CPU] * 2,
                               registry=reg)
    assert psharded.runner_cache_len() == psharded.RUNNER_CACHE_CAP
    assert obs.snapshot()["counters"][
        "sharded_runner_evictions_total"] == 2


# -- routing and refusals

def test_shard_stream_routing_threshold(tmp_path):
    h, w, reps, n = 12, 10, 1, 2
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=4)
    want = _jax_stream(clip_path, h, w, GREY, reps, str(tmp_path / "j.raw"),
                       frames=n, shard_frames=(2, 2), shard_min_pixels=10_000)
    out = str(tmp_path / "out.raw")
    res = _run(_cfg(clip_path, h, w, GREY, reps, output=out, frames=n,
                    shard_frames=(2, 2), shard_min_pixels=10_000), 4)
    assert res.shard_frames is None and res.n_devices == 1
    assert open(out, "rb").read() == want


def test_shard_stream_too_many_devices_fails_loudly(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 10, 8, 1)
    cfg = _cfg(clip_path, 10, 8, GREY, 1, frames=2, shard_frames=(8, 8),
               output="null")
    with pytest.raises(ValueError, match="64 devices.*have"):
        _run(cfg, 8)


def test_shard_stream_unservable_geometry_fails_typed(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 1, 2, 300, 1)
    cfg = _cfg(clip_path, 2, 300, GREY, 1, frames=1, shard_frames=(2, 2),
               filter_name="gaussian7", output="null")
    with pytest.raises(ValueError, match="cannot serve"):
        _run(cfg, 4)


@pytest.mark.parametrize("kw,match", [
    (dict(shard_frames=(0, 2)), "shard_frames"),
    (dict(shard_frames=(2,)), "shard_frames"),
    (dict(shard_frames=(0, 0), mesh_frames=2), "composed topologies must be"),
    (dict(shard_frames=(2, 2), pipe_stages=0), "composed topologies must be"),
    (dict(shard_min_pixels=0), "shard_min_pixels"),
    (dict(overlap="sideways"), "overlap"),
])
def test_config_refuses_what_the_jax_config_refuses(kw, match):
    base = dict(input="x", width=8, height=8, repetitions=1, frames=1)
    with pytest.raises(ValueError, match=match):
        jconfig.StreamConfig(**base, image_type=jconfig.ImageType.GREY, **kw)
    with pytest.raises(ValueError, match=match):
        tconfig.StreamConfig(**base, image_type=GREY, **kw)


def test_config_accepts_composition_and_normalizes():
    base = dict(input="x", width=8, height=8, repetitions=1,
                image_type=GREY, frames=1)
    cfg = tconfig.StreamConfig(**base, shard_frames=(2, 2), mesh_frames=2)
    assert cfg.shard_frames == (2, 2) and cfg.mesh_frames == 2
    assert tconfig.StreamConfig(**base,
                                shard_frames=(0, 0)).shard_frames == (0, 0)
    assert tconfig.StreamConfig(**base,
                                shard_frames=[2, 2]).shard_frames == (2, 2)


def test_cli_parses_shard_frames(capsys):
    p = stream_cli.build_parser()
    jp = jstream_cli.build_parser()
    for v in (None, "0", "2x4", "3X1"):
        assert stream_cli._parse_shard_frames(p, v) == \
            jstream_cli._parse_shard_frames(jp, v)
    with pytest.raises(SystemExit):
        stream_cli._parse_shard_frames(p, "2x")
    capsys.readouterr()


def test_cli_shard_stream_matches_jax_cli(tmp_path, capsys):
    h, w, reps, n = 16, 12, 3, 2
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=6)
    args = [str(clip_path), str(w), str(h), str(reps), "grey", "--frames",
            str(n)]
    jout = str(tmp_path / "j.raw")
    assert jstream_cli.main(args + ["--output", jout]) == 0
    capsys.readouterr()
    out, stats = str(tmp_path / "out.raw"), str(tmp_path / "stats.json")
    rc = _bounded(stream_cli.main, args + [
        "--shard-frames", "2x2", "--shard-min-pixels", "1", "--output", out,
        "--platform", "cpu", "--stats-json", stats])
    assert rc == 0
    assert "shard-frames=2x2" in capsys.readouterr().out
    payload = json.load(open(stats))
    assert payload["shard_frames"] == [2, 2] and payload["n_devices"] == 4
    assert open(out, "rb").read() == open(jout, "rb").read()


# -- checkpoint: the shard topology ------------------------------------------

def test_shard_checkpoint_records_topology(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 4, 12, 10, 1, seed=7)
    out = str(tmp_path / "out.raw")
    kw = dict(input=str(clip_path), width=10, height=12, repetitions=1,
              output=out, frames=4, shard_frames=(2, 2), shard_min_pixels=1,
              checkpoint_every=2)
    jcfg = jconfig.StreamConfig(**kw, image_type=jconfig.ImageType.GREY)
    cfg = tconfig.StreamConfig(**kw, image_type=GREY)
    jckpt.save_stream_progress(jcfg, 2, shard_frames=(2, 2))
    jmeta = json.load(open(out + ".stream.ckpt.json"))
    ckpt.save_stream_progress(cfg, 2, shard_frames=(2, 2))
    meta = json.load(open(out + ".stream.ckpt.json"))
    assert meta["shard_frames"] == jmeta["shard_frames"] == [2, 2]
    assert ckpt.restore_stream_progress(cfg, shard_frames=(2, 2)) == 2
    with pytest.raises(ckpt.MeshCursorMismatch) as ei:
        ckpt.restore_stream_progress(cfg, shard_frames=(1, 2))
    assert "2x2" in str(ei.value) and "1x2" in str(ei.value)
    with pytest.raises(ckpt.MeshCursorMismatch):
        ckpt.restore_stream_progress(cfg)
    ckpt.save_stream_progress(cfg, 2)
    with pytest.raises(ckpt.MeshCursorMismatch):
        ckpt.restore_stream_progress(cfg, shard_frames=(2, 2))


def test_shard_writer_commits_the_topology(tmp_path, monkeypatch):
    h, w, n = 12, 10, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=5)
    saved = []
    real = ckpt.save_stream_progress

    def spy(cfg, k, **kw):
        saved.append((k, kw))
        return real(cfg, k, **kw)

    monkeypatch.setattr(ckpt, "save_stream_progress", spy)
    _run(_cfg(clip_path, h, w, GREY, 1, output=str(tmp_path / "o.raw"),
              frames=n, shard_frames=(2, 2), checkpoint_every=2), 4)
    assert saved == [(2, {"shard_frames": (2, 2)}),
                     (4, {"shard_frames": (2, 2)})]


def test_shard_resume_different_topology_fails_typed(tmp_path):
    h, w, n = 12, 10, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=8)
    out = str(tmp_path / "out.raw")
    cfg = _cfg(clip_path, h, w, GREY, 1, output=out, frames=n,
               shard_frames=(2, 2), checkpoint_every=1)
    ckpt.save_stream_progress(cfg, 2, shard_frames=(1, 2))
    open(out, "wb").write(b"\0" * (2 * h * w))
    with pytest.raises(ckpt.MeshCursorMismatch):
        _run(cfg, 4, resume=True)
    with pytest.raises(ckpt.MeshCursorMismatch):
        _run(dataclasses.replace(cfg, shard_frames=None), 4, resume=True)


def test_shard_resume_same_topology_completes(tmp_path):
    h, w, ch, reps, n = 16, 12, 3, 2, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=10)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       frames=n)
    fb = h * w * ch
    out = str(tmp_path / "out.raw")
    cfg = _cfg(clip_path, h, w, RGB, reps, output=out, frames=n,
               shard_frames=(2, 2), checkpoint_every=1)
    open(out, "wb").write(want[:2 * fb])
    ckpt.save_stream_progress(cfg, 2, shard_frames=(2, 2))
    res = _run(cfg, 4, resume=True)
    assert res.skipped == 2 and res.frames == n - 2
    assert open(out, "rb").read() == want


# -- chaos -------------------------------------------------------------------

@pytest.mark.chaos
def test_shard_stream_engine_restart_from_checkpoint(tmp_path):
    h, w, ch, reps, n = 16, 12, 3, 2, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=13)
    want = _jax_stream(clip_path, h, w, RGB, reps, str(tmp_path / "j.raw"),
                       frames=n)
    out = str(tmp_path / "out.raw")
    tfaults.configure("compute:frame=1")
    res = _run(_cfg(clip_path, h, w, RGB, reps, output=out, frames=n,
                    shard_frames=(2, 2), checkpoint_every=1), 4)
    assert res.restarts == 1 and res.shard_frames == (2, 2)
    assert open(out, "rb").read() == want


@pytest.mark.chaos
def test_shard_stream_torn_staging_fails_typed(tmp_path):
    h, w, n = 12, 10, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=14)
    tfaults.configure("integrity.corrupt_ingest:frame=1")
    with pytest.raises(StreamFailure) as ei:
        _run(_cfg(clip_path, h, w, GREY, 1, output="null", frames=n,
                  shard_frames=(2, 2)), 4)
    assert ei.value.stage == "h2d" and ei.value.frame_index == 1
    assert "ChecksumMismatch" in str(ei.value)


@pytest.mark.chaos
def test_shard_stream_torn_tile_fails_typed(tmp_path, monkeypatch):
    # A staging tile torn after its CRC and before its upload fails at
    # the tile's own re-verification (frame 1's last tile).
    h, w, n = 12, 10, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=21)
    real = shardstream._checksum

    class Tearing:
        calls = 0

        def __getattr__(self, name):
            return getattr(real, name)

        def native_crc32c(self, t, *a):
            v = real.native_crc32c(t, *a)
            self.calls += 1
            if self.calls == 8:  # four tiles a frame
                t.reshape(-1)[0] ^= 1
            return v

    monkeypatch.setattr(shardstream, "_checksum", Tearing())
    with pytest.raises(StreamFailure) as ei:
        _run(_cfg(clip_path, h, w, GREY, 1, output="null", frames=n,
                  shard_frames=(2, 2)), 4)
    assert ei.value.stage == "h2d" and ei.value.frame_index == 1
    assert "ChecksumMismatch" in str(ei.value)


@pytest.mark.chaos
def test_shard_stream_witness_withholds_corrupt_frame(tmp_path):
    h, w, n = 12, 10, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=15)
    sink = frames_io.NullSink()
    tfaults.configure("integrity.corrupt_result:frame=1")
    with pytest.raises(StreamFailure) as ei:
        _run(_cfg(clip_path, h, w, GREY, 1, output="null", frames=n,
                  shard_frames=(2, 2), witness_rate=1.0), 4, sink=sink)
    assert ei.value.stage == "write" and ei.value.frame_index == 1
    assert "WitnessMismatch" in str(ei.value)
    assert sink.frames_written == 1


# -- the frame one device cannot hold ----------------------------------------

def test_infeasible_frame_streams_via_shard_frames(tmp_path, monkeypatch):
    h, w, reps, n = 24, 20, 2, 3
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=16)
    want = _jax_stream(clip_path, h, w, GREY, reps, str(tmp_path / "j.raw"),
                       frames=n)
    cfg = _cfg(clip_path, h, w, GREY, reps, output=str(tmp_path / "o.raw"),
               frames=n, shard_frames=(0, 0))
    monkeypatch.setenv(roofline.ENV_DEVICE_HBM_BYTES, str(cfg.frame_bytes))
    assert not roofline.hbm_frame_feasible(cfg.frame_bytes,
                                           cfg.pipeline_depth)
    grid = shardstream.resolve_shard_frames(
        cfg, [CPU] * 8, measure=lambda *a: pytest.fail("probed"))
    assert grid == (4, 2)
    th, tw = roofline.shard_tile_shape(h, w, grid)
    assert roofline.hbm_frame_feasible(th * tw, cfg.pipeline_depth)
    res = _run(cfg, 8)
    assert res.shard_frames == grid and res.frames == n
    assert open(str(tmp_path / "o.raw"), "rb").read() == want


# -- spans and gauges --------------------------------------------------------

def test_shard_spans_split_per_shard_and_gauges(tmp_path):
    h, w, n = 24, 20, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=17)
    cfg = _cfg(clip_path, h, w, GREY, 3, output="null", frames=n,
               pipeline_depth=2, shard_frames=(2, 2))
    tracer = obs.enable()
    try:
        _run(cfg, 4)
    finally:
        obs.disable()
    for name in ("stream.h2d", "stream.d2h"):
        spans = [s for s in tracer.spans() if s.name == name]
        assert len(spans) == 4 * n
        assert {s.args.get("dev") for s in spans} == {0, 1, 2, 3}
        assert sorted(s.args["frame"] for s in spans) == sorted(
            list(range(n)) * 4)
    assert len([s for s in tracer.spans()
                if s.name == "stream.compute"]) == n
    snap = obs.snapshot()
    assert snap["gauges"]["stream_shard_devices"]["value"] == 4
    assert snap["gauges"]["stream_inflight_depth"]["peak"] <= 2
    _run(dataclasses.replace(cfg, shard_frames=None, frames=1), 1)
    assert obs.snapshot()["gauges"]["stream_shard_devices"]["value"] == 0


# -- auto --------------------------------------------------------------------

def test_shard_auto_decides_from_measurement(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 16, 12, 1)
    cfg = _cfg(clip_path, 16, 12, GREY, 1, frames=2, shard_frames=(0, 0))
    devs = [CPU] * 4
    jcfg = jconfig.StreamConfig(input=str(clip_path), width=12, height=16,
                                repetitions=1,
                                image_type=jconfig.ImageType.GREY, frames=2,
                                shard_frames=(0, 0), shard_min_pixels=1)
    from tpu_stencil.stream import sharded as jshardstream

    for arms in ((1.0, 0.5), (0.5, 1.0), (1.0, 1.0)):
        pick = shardstream.resolve_shard_frames(cfg, devs,
                                                measure=lambda *a: arms)
        jpick = jshardstream.resolve_shard_frames(
            jcfg, [None] * 4, measure=lambda *a: arms)
        assert pick == jpick
        assert pick == ((2, 2) if arms[1] < arms[0] else None)
    assert shardstream.resolve_shard_frames(
        cfg, devs[:1], measure=lambda *a: pytest.fail("probed")) is None
    small = dataclasses.replace(cfg, shard_min_pixels=10_000)
    assert shardstream.resolve_shard_frames(
        small, devs, measure=lambda *a: pytest.fail("probed")) is None


def test_shard_auto_never_enables_measured_loss(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 3, 20, 16, 1, seed=18)
    cfg = _cfg(clip_path, 20, 16, GREY, 2, frames=3, shard_frames=(0, 0),
               output="null")
    devs = [CPU] * 2
    t_single, t_shard = _bounded(shardstream.measure_shard_ab, cfg, devs,
                                 (1, 2))
    assert t_single > 0 and t_shard > 0
    pick = shardstream.resolve_shard_frames(
        cfg, devs, measure=lambda *a: (t_single, t_shard))
    assert pick == ((1, 2) if t_shard < t_single else None)


def test_shard_auto_verdict_persists_in_autotune_cache(tmp_path,
                                                       monkeypatch):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 16, 12, 1)
    cfg = _cfg(clip_path, 16, 12, GREY, 1, frames=2, shard_frames=(0, 0),
               output="null")
    devs = [CPU] * 2
    calls = [0]
    real = shardstream.measure_shard_ab

    def counting(cfg_, devs_, mesh_shape, frames=shardstream.PROBE_FRAMES):
        calls[0] += 1
        return real(cfg_, devs_, mesh_shape, frames)

    monkeypatch.setattr(shardstream, "measure_shard_ab", counting)
    p1 = _bounded(shardstream.resolve_shard_frames, cfg, devs)
    p2 = shardstream.resolve_shard_frames(cfg, devs)
    assert calls[0] == 1 and p1 == p2
    store = autotune._load_cache()
    key = next(k for k in store if "|stream|shardstream|" in k)
    assert {"pick", "single_us", "shard_us"} <= set(store[key])


# -- the roofline model at the H100's constants

def test_shard_roofline_model_by_hand():
    assert roofline.shard_tile_shape(30, 20, (2, 2)) == (15, 10)
    assert roofline.shard_tile_shape(31, 21, (2, 2)) == (16, 11)
    assert roofline.H100_NVLINK_BYTES_PER_S == 450e9
    assert roofline.H100_D2D_COPY_BYTES_PER_S == 3.35e12 / 2
    # 2x2 over 64x48 RGB: tile 32x24x3 = 2304 B; xla moves 2 x 2304 B a
    # rep (1.3755e-9 s at 3.35e12 B/s), 5 int32 ops per element over
    # 67e12 / 4 op/s (6.8776e-10 s): bytes bound. Ghosts of the edge
    # exchange per rep: n, s = 24*3, w, e = 32*3, corners 4*3 = 348 B.
    reps = 10
    tile_b = 32 * 24 * 3
    ghost = 2 * 24 * 3 + 2 * 32 * 3 + 4 * 3
    for one_card, link in ((False, 450e9), (True, 3.35e12 / 2)):
        st = roofline.sharded_stream_stage_seconds(
            reps, "xla", "gaussian", 64, 48, 3, (2, 2), one_card=one_card)
        compute = reps * (2 * tile_b / 3.35e12 + ghost / link)
        assert st["compute"] == pytest.approx(compute, rel=1e-9)
        assert st["h2d"] == st["d2h"] == pytest.approx(4 * tile_b / 64e9)
        fps2 = roofline.sharded_stream_frames_per_second(
            64 * 48 * 3, reps, "xla", "gaussian", 64, 48, 3, (2, 2),
            one_card=one_card)
        fps1 = roofline.sharded_stream_frames_per_second(
            64 * 48 * 3, reps, "xla", "gaussian", 64, 48, 3, (2, 2),
            pipeline_depth=1, one_card=one_card)
        assert fps2 == pytest.approx(1 / max(st.values()))
        assert fps1 == pytest.approx(1 / sum(st.values())) and fps2 > fps1
    single = roofline.stream_stage_seconds(64 * 48 * 3, reps, "xla",
                                           "gaussian", 64)
    assert st["compute"] < single["compute"]


def test_device_memory_bound_gates_the_frame(monkeypatch):
    monkeypatch.setenv(roofline.ENV_DEVICE_HBM_BYTES, "3000")
    assert roofline.device_hbm_bytes() == 3000
    assert roofline.hbm_frame_feasible(1000, pipeline_depth=2)
    assert not roofline.hbm_frame_feasible(1001, pipeline_depth=2)
    assert roofline.hbm_frame_feasible(1500, pipeline_depth=1)
    monkeypatch.delenv(roofline.ENV_DEVICE_HBM_BYTES)
    assert roofline.device_hbm_bytes() == roofline.H100_HBM_BYTES


def test_choose_stream_topology_ranks_the_shard_arm():
    # The shard's bound beats one device's where the reps bind, but never
    # the fan's over as many devices (its tiles cost a share of the frame
    # plus ghosts): the chooser keeps the fan, as the JAX package's does.
    geo = (2048, 64, 1)
    fb = 2048 * 64
    single = roofline.stream_frames_per_second(fb, 4000, "xla", "gaussian",
                                               2048)
    shard = roofline.sharded_stream_frames_per_second(
        fb, 4000, "xla", "gaussian", 2048, 64, 1, (8, 1))
    fan = roofline.mesh_stream_frames_per_second(fb, 4000, "xla",
                                                 "gaussian", 2048,
                                                 n_devices=8)
    assert single < shard < fan
    assert autotune.choose_stream_topology(geo, 4000, 2, 8, "xla") == \
        "fanout"
    assert autotune.choose_stream_topology(geo, 4000, 2, 1, "xla") == \
        "single"


def test_shard_breakdown_renders_sharded_bound(tmp_path, capsys):
    h, w, reps, n = 16, 12, 1, 2
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=19)
    rc = _bounded(stream_cli.main, [
        str(clip_path), str(w), str(h), str(reps), "grey", "--frames",
        str(n), "--output", "null", "--shard-frames", "2x2",
        "--shard-min-pixels", "1", "--breakdown", "--platform", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "2x2 shards" in text and "modeled sharded bound" in text
    assert "ICI ghost model" in text and "one card" in text


# -- TileScatter --------------------------------------------------------------

SPECS = [(slice(0, 3), slice(0, 4)), (slice(0, 3), slice(4, 8)),
         (slice(3, 6), slice(0, 4)), (slice(3, 6), slice(4, 8))]


def test_tile_scatter_round_trip_equals_the_jax_packages():
    rng = np.random.default_rng(20)
    scat = frames_io.TileScatter((5, 7, 3), SPECS)
    jscat = jframes.TileScatter((5, 7, 3), SPECS)
    for _ in range(2):
        frame = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
        tiles = scat.scatter(frame.ravel())
        jtiles = jscat.scatter(frame.ravel())
        assert all(np.array_equal(a, b) for a, b in zip(tiles, jtiles))
        assert all(t.shape == (3, 4, 3) for t in tiles)
        assert np.all(tiles[2][2:] == 0) and np.all(tiles[3][:, 3:] == 0)
        out = np.empty((5, 7, 3), np.uint8)
        scat.gather_into(out, list(enumerate(tiles)))
        assert np.array_equal(out, frame)
    # The tiles are views of the tensors the copies read.
    assert all(np.shares_memory(t, x.numpy())
               for t, x in zip(scat.tiles, scat.tensors))


def test_tile_scatter_waits_for_each_tiles_copy_before_rewriting():
    scat = frames_io.TileScatter((5, 7), [(r, c) for r, c in SPECS])
    first = np.arange(35, dtype=np.uint8).reshape(5, 7)
    scat.scatter(first.ravel())
    seen = []

    class Event:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            # The tile still holds the bytes its copy reads.
            seen.append((self.i, scat.tiles[self.i].copy()))

    for i in (0, 3):
        scat.uploaded(i, Event(i))
    before = [t.copy() for t in scat.tiles]
    scat.scatter((first + 100).ravel())
    assert [i for i, _ in seen] == [0, 3]
    for i, snap in seen:
        assert np.array_equal(snap, before[i])
    # Each event is waited for once.
    scat.scatter(first.ravel())
    assert len(seen) == 2
