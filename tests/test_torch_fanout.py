"""The port's mesh fan-out and batch-axis ``--frames`` against the JAX
package's.

Fan-out: the same seeded clip through the JAX package's ``run_stream``
with ``mesh_frames=N`` over its 8 forced host devices and through the
port's over ``[cpu] * N``, every output byte equal (integer plans: exact),
mirroring the stream half of ``tests/test_fanout.py``: the per-device
cursors and the device-count contract of the checkpoint, the auto A/B's
verdict (injected measurements, and the cache round trip), the whole-fan
roofline, the CLI, the restart ladder, the spans and gauges.

Batch-axis ``--frames`` (``tests/test_cli.py``'s frames tests): a clip
over several devices, a contiguous share each, zero-padded to a device
multiple; the same bytes as one device and as the JAX package, in one
process and across two gloo processes of two devices each.

No assertion reads a wall clock; every run of the port has a deadline.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpu_stencil import cli as jcli
from tpu_stencil import config as jconfig
from tpu_stencil.parallel import fanout as jfanout
from tpu_stencil.runtime import checkpoint as jckpt
from tpu_stencil.stream import cli as jstream_cli
from tpu_stencil.stream import engine as jengine
from tpu_stencil_torch import cli as tcli
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.parallel import fanout
from tpu_stencil_torch.resilience import faults as tfaults
from tpu_stencil_torch.runtime import autotune
from tpu_stencil_torch.runtime import checkpoint as ckpt
from tpu_stencil_torch.runtime import roofline
from tpu_stencil_torch.stream import cli as stream_cli
from tpu_stencil_torch.stream import engine as stream_engine
from tpu_stencil_torch.stream import frames as frames_io

from test_torch_stream import _bounded, _make_clip

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_STENCIL_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    tfaults.clear()
    obs.reset()
    yield
    tfaults.reset()
    obs.reset()


def _cfg(clip_path, h, w, image_type, reps, **kw):
    return tconfig.StreamConfig(
        input=str(clip_path), width=w, height=h, repetitions=reps,
        image_type=image_type, **kw)


def _jax_stream(clip_path, h, w, image_type, reps, out, **kw):
    jengine.run_stream(jconfig.StreamConfig(
        input=str(clip_path), width=w, height=h, repetitions=reps,
        image_type=jconfig.ImageType(image_type.value), output=out, **kw))
    return open(out, "rb").read()


def _run(cfg, n_dev, **kw):
    return _bounded(stream_engine.run_stream, cfg, devices=[CPU] * n_dev,
                    **kw)


# -- the fan against the JAX package's fan, byte for byte -----------------

@pytest.mark.parametrize("image_type,boundary,depth,n_dev,backend", [
    (tconfig.ImageType.RGB, "zero", 2, 2, "pallas"),
    (tconfig.ImageType.GREY, "zero", 1, 4, "pallas"),
    (tconfig.ImageType.RGB, "periodic", 4, 2, "xla"),
    (tconfig.ImageType.GREY, "periodic", 2, 3, "auto"),
    (tconfig.ImageType.RGB, "zero", 4, 4, "pallas"),
    (tconfig.ImageType.GREY, "zero", 2, 2, "xla"),
])
def test_mesh_fan_matches_jax(tmp_path, image_type, boundary, depth, n_dev,
                              backend):
    h, w, reps, n = 16, 12, 3, 7
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, image_type.channels, seed=n_dev + depth)
    want = _jax_stream(clip_path, h, w, image_type, reps,
                       str(tmp_path / "jax.raw"), frames=n,
                       boundary=boundary, pipeline_depth=depth,
                       mesh_frames=n_dev)
    out = str(tmp_path / "out.raw")
    res = _run(_cfg(clip_path, h, w, image_type, reps, output=out,
                    frames=n, boundary=boundary, pipeline_depth=depth,
                    mesh_frames=n_dev, backend=backend), n_dev)
    assert res.frames == n and res.n_devices == n_dev
    assert sum(res.per_device_frames) == n
    assert res.per_device_frames == [len(range(d, n, n_dev))
                                     for d in range(n_dev)]
    assert open(out, "rb").read() == want


@pytest.mark.parametrize("filt", ["gaussian", "box", "edge"])
@pytest.mark.parametrize("reps", [0, 1, cs.DEFAULT_FUSE + 1])
def test_mesh_fan_filters_and_reps_match_jax(tmp_path, filt, reps):
    h, w, n = 14, 10, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 3, seed=reps)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n,
                       filter_name=filt, mesh_frames=2)
    out = str(tmp_path / "out.raw")
    _run(_cfg(clip_path, h, w, tconfig.ImageType.RGB, reps, output=out,
              frames=n, filter_name=filt, mesh_frames=2, backend="pallas",
              schedule="deep" if reps == 1 else None), 2)
    assert open(out, "rb").read() == want


def test_mesh_fan_until_eof_and_dir_sink(tmp_path):
    h, w, ch, reps, n = 12, 10, 3, 2, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=3)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    sink_dir = str(tmp_path / "out_frames")
    res = _run(_cfg(clip_path, h, w, tconfig.ImageType.RGB, reps,
                    output=sink_dir + "/", frames=None, mesh_frames=2), 2)
    assert res.frames == n and res.n_devices == 2
    fb = h * w * ch
    for i in range(n):
        got = open(f"{sink_dir}/{frames_io.FRAME_PATTERN.format(i)}",
                   "rb").read()
        assert got == want[i * fb:(i + 1) * fb], f"frame {i} differs"


def test_mesh_fan_too_few_devices(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 8, 1)
    cfg = _cfg(clip_path, 8, 8, tconfig.ImageType.GREY, 1, frames=2,
               mesh_frames=64, output=str(tmp_path / "o.raw"))
    with pytest.raises(ValueError, match="64 devices.*have"):
        _run(cfg, 2)


def test_mesh_fan_witness_and_integrity(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 4, 10, 8, 3, seed=2)
    res = _run(_cfg(clip_path, 10, 8, tconfig.ImageType.RGB, 2,
                    output=str(tmp_path / "o.raw"), frames=4,
                    mesh_frames=2, witness_rate=1.0), 2)
    assert res.frames == 4
    snap = obs.snapshot()["counters"]
    assert snap["integrity_witness_total"] == 4
    assert snap["integrity_ingest_verified_total"] == 4


# -- checkpoint/resume: cursors and the device-count contract --------------

def test_device_cursors_equal_the_jax_packages():
    for done in range(0, 9):
        for start in range(0, 4):
            for n in (1, 2, 3, 4):
                assert (fanout.device_cursors(done, start, n)
                        == jfanout.device_cursors(done, start, n))
    assert fanout.device_cursors(5, 0, 4) == [8, 5, 6, 7]


def test_mesh_checkpoint_records_count_and_cursors(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 4, 10, 8, 1, seed=2)
    out = str(tmp_path / "out.raw")
    cfg = _cfg(clip_path, 10, 8, tconfig.ImageType.GREY, 1, output=out,
               frames=4, mesh_frames=2, checkpoint_every=2)
    ckpt.save_stream_progress(cfg, 2, mesh_devices=2,
                              cursors=fanout.device_cursors(2, 0, 2))
    meta = json.load(open(str(tmp_path / "out.raw.stream.ckpt.json")))
    assert meta["mesh_devices"] == 2
    assert meta["device_cursors"] == [2, 3]
    assert ckpt.restore_stream_progress(cfg, mesh_devices=2) == 2
    jcfg = jconfig.StreamConfig(str(clip_path), 8, 10, 1,
                                jconfig.ImageType.GREY, output=out,
                                frames=4, mesh_frames=2)
    assert jckpt.restore_stream_progress(jcfg, mesh_devices=2) == 2
    with pytest.raises(ckpt.MeshCursorMismatch) as ei:
        ckpt.restore_stream_progress(cfg, mesh_devices=4)
    assert "2-device" in str(ei.value) and "4 device" in str(ei.value)
    assert ei.value.recorded == 2 and ei.value.requested == 4


def test_mesh_writer_checkpoints_carry_the_cursors(tmp_path, monkeypatch):
    # The writer's own commits (not a hand-made sidecar): each records the
    # fan width and the cursors of the deal at that progress.
    saved = []
    real = ckpt.save_stream_progress

    def spy(cfg, frames_done, **kw):
        saved.append((frames_done, kw))
        return real(cfg, frames_done, **kw)

    monkeypatch.setattr(ckpt, "save_stream_progress", spy)
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 5, 8, 6, 1)
    _run(_cfg(clip_path, 8, 6, tconfig.ImageType.GREY, 1,
              output=str(tmp_path / "o.raw"), frames=5, mesh_frames=2,
              checkpoint_every=2), 2)
    assert [d for d, _ in saved] == [2, 4]
    assert saved[0][1] == {"mesh_devices": 2, "cursors": [2, 3]}
    assert saved[1][1] == {"mesh_devices": 2, "cursors": [4, 5]}


def test_mesh_resume_different_count_fails_typed(tmp_path):
    h, w, reps, n = 10, 8, 1, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=5)
    out = str(tmp_path / "out.raw")
    cfg4 = _cfg(clip_path, h, w, tconfig.ImageType.GREY, reps, output=out,
                frames=n, mesh_frames=4, checkpoint_every=1)
    ckpt.save_stream_progress(cfg4, 2, mesh_devices=2, cursors=[2, 3])
    open(out, "wb").write(b"\0" * (2 * h * w))
    with pytest.raises(ckpt.MeshCursorMismatch):
        _run(cfg4, 4, resume=True)
    cfg1 = dataclasses.replace(cfg4, mesh_frames=1)
    with pytest.raises(ckpt.MeshCursorMismatch):
        _run(cfg1, 4, resume=True)


def test_mesh_resume_same_count_completes(tmp_path):
    h, w, ch, reps, n = 12, 10, 3, 2, 5
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=6)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    out = str(tmp_path / "out.raw")
    cfg = _cfg(clip_path, h, w, tconfig.ImageType.RGB, reps, output=out,
               frames=n, mesh_frames=2, checkpoint_every=1)
    fb = h * w * ch
    with open(out, "wb") as fh:
        fh.write(want[:2 * fb])
    ckpt.save_stream_progress(cfg, 2, mesh_devices=2,
                              cursors=fanout.device_cursors(2, 0, 2))
    res = _run(cfg, 2, resume=True)
    assert res.skipped == 2 and res.frames == n - 2
    assert res.per_device_frames == [2, 1]
    assert open(out, "rb").read() == want


def test_single_device_sidecar_still_resumes(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 3, 8, 8, 1, seed=1)
    cfg = _cfg(clip_path, 8, 8, tconfig.ImageType.GREY, 1,
               output=str(tmp_path / "o.raw"), frames=3)
    ckpt.save_stream_progress(cfg, 1)
    meta = json.load(open(str(tmp_path / "o.raw.stream.ckpt.json")))
    assert "mesh_devices" not in meta and "device_cursors" not in meta
    assert ckpt.restore_stream_progress(cfg) == 1
    with pytest.raises(ckpt.MeshCursorMismatch):
        ckpt.restore_stream_progress(cfg, mesh_devices=2)


@pytest.mark.chaos
def test_mesh_fan_engine_restart_from_checkpoint(tmp_path):
    h, w, ch, reps, n = 16, 12, 3, 2, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, ch, seed=13)
    want = _jax_stream(clip_path, h, w, tconfig.ImageType.RGB, reps,
                       str(tmp_path / "jax.raw"), frames=n)
    out = str(tmp_path / "out.raw")
    tfaults.configure("compute:frame=1")
    res = _run(_cfg(clip_path, h, w, tconfig.ImageType.RGB, reps,
                    output=out, frames=n, mesh_frames=2,
                    checkpoint_every=1, backend="pallas"), 2)
    assert res.restarts == 1
    assert res.n_devices == 2
    assert open(out, "rb").read() == want


# -- auto (--mesh-frames 0): measured, never a loss ------------------------

def test_auto_decides_from_measurement(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 8, 1)
    cfg = _cfg(clip_path, 8, 8, tconfig.ImageType.GREY, 1, frames=2,
               mesh_frames=0)
    devs = [CPU] * 3
    assert fanout.resolve_mesh_frames(
        cfg, devs, measure=lambda *a: (1.0, 0.5)) == 3
    assert fanout.resolve_mesh_frames(
        cfg, devs, measure=lambda *a: (0.5, 1.0)) == 1
    # A tie is not a win.
    assert fanout.resolve_mesh_frames(
        cfg, devs, measure=lambda *a: (1.0, 1.0)) == 1
    # One device: nothing to fan, no probe.
    assert fanout.resolve_mesh_frames(
        cfg, devs[:1], measure=lambda *a: pytest.fail("probed")) == 1
    assert not os.path.exists(os.environ[autotune.ENV_CACHE])


def test_auto_verdict_round_trips_the_cache(tmp_path, monkeypatch):
    # The real probe's verdict is stored; a second resolution reads it
    # with zero probe frames, under a key of its own per compute identity.
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 8, 1)
    cfg = _cfg(clip_path, 8, 8, tconfig.ImageType.GREY, 1, frames=2,
               mesh_frames=0)
    calls = []

    def fake(c, devs):
        calls.append(len(devs))
        return 0.2, 0.1

    monkeypatch.setattr(fanout, "measure_fanout_ab", fake)
    assert fanout.resolve_mesh_frames(cfg, [CPU] * 2) == 2
    assert fanout.resolve_mesh_frames(cfg, [CPU] * 2) == 2
    assert calls == [2]
    hit = autotune.cached_stream_verdict(
        "fanout", (8, 8, 1), 1, 2, "ndev2", autotune.stream_cfg_token(cfg),
        device=CPU)
    assert hit["pick"] == 2 and hit["single_us"] == 200000.0
    other = dataclasses.replace(cfg, filter_name="box")
    assert autotune.cached_stream_verdict(
        "fanout", (8, 8, 1), 1, 2, "ndev2",
        autotune.stream_cfg_token(other), device=CPU) is None


def test_measure_fanout_ab_streams_both_arms(tmp_path):
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, 2, 8, 8, 1)
    cfg = _cfg(clip_path, 8, 8, tconfig.ImageType.GREY, 1, frames=2,
               mesh_frames=0, output="null")
    t_single, t_mesh = _bounded(fanout.measure_fanout_ab, cfg, [CPU] * 2)
    assert t_single > 0 and t_mesh > 0
    # The probe's frames did not land in the run's registry.
    assert "stream_frames_total" not in obs.snapshot()["counters"]


def test_stream_config_validates_mesh_frames():
    with pytest.raises(ValueError, match="mesh_frames"):
        tconfig.StreamConfig(input="x", width=8, height=8, repetitions=1,
                             image_type=tconfig.ImageType.GREY, frames=1,
                             mesh_frames=-2)
    tconfig.StreamConfig(input="x", width=8, height=8, repetitions=1,
                         image_type=tconfig.ImageType.GREY, frames=1,
                         mesh_frames=0)


# -- whole-fan roofline and topology model ---------------------------------

def test_mesh_roofline_scales_and_caps():
    fb, reps = 64 * 48 * 3, 10
    geo = dict(w_img=48, channels=3)
    one = roofline.stream_frames_per_second(fb, reps, "xla", "gaussian", 64,
                                            **geo)
    four = roofline.mesh_stream_frames_per_second(
        fb, reps, "xla", "gaussian", 64, n_devices=4, **geo)
    cap = roofline.pcie_contention_frames_per_second(fb)
    assert four == pytest.approx(min(4 * one, cap))
    assert roofline.mesh_stream_frames_per_second(
        fb, reps, "xla", "gaussian", 64, n_devices=1, **geo
    ) == pytest.approx(min(one, cap))
    big = 4 * 3840 * 2160 * 3
    assert roofline.mesh_stream_frames_per_second(
        big, 1, "xla", "gaussian", 4 * 2160, n_devices=64
    ) <= roofline.pcie_contention_frames_per_second(big)
    assert cap == pytest.approx(roofline.H100_PCIE_BYTES_PER_S / fb)


def test_choose_stream_topology_single_or_fanout():
    # Link-bound at the reference frame: the fan's bound ties one device's
    # under the shared link, and a tie stays single.
    assert autotune.choose_stream_topology((2520, 1920, 3), 40, 2, 4,
                                           "pallas") == "single"
    # Compute-bound (many reps of torch ops): the fan's bound wins.
    assert autotune.choose_stream_topology((256, 256, 3), 2000, 2, 4,
                                           "xla") == "fanout"
    assert autotune.choose_stream_topology((256, 256, 3), 2000, 2, 1,
                                           "xla") == "single"


# -- CLI -----------------------------------------------------------------------

def test_stream_cli_mesh_frames_round_trip(tmp_path, capsys):
    # --platform cpu offers the CPU --mesh-frames times over, as the JAX
    # package's forced host devices do; the bytes are its CLI's.
    h, w, ch, reps, n = 12, 10, 3, 2, 4
    clip_path = str(tmp_path / "clip.raw")
    _make_clip(clip_path, n, h, w, ch, seed=8)
    args = [clip_path, str(w), str(h), str(reps), "rgb", "--frames", str(n),
            "--mesh-frames", "2"]
    jout = str(tmp_path / "jax.raw")
    assert jstream_cli.main(args + ["--output", jout]) == 0
    capsys.readouterr()
    out = str(tmp_path / "out.raw")
    stats = str(tmp_path / "stats.json")
    rc = stream_cli.main(args + ["--output", out, "--stats-json", stats,
                                 "--platform", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "mesh-frames=2dev" in text
    assert "per-device frames: dev0=2 dev1=2" in text
    payload = json.load(open(stats))
    assert payload["n_devices"] == 2
    assert payload["per_device_frames"] == [2, 2]
    assert open(out, "rb").read() == open(jout, "rb").read()


def test_stream_cli_mesh_frames_beyond_the_cards_fails_loudly(
        tmp_path, capsys, monkeypatch):
    # On the card --mesh-frames N takes the visible devices: fewer fail.
    monkeypatch.setattr(stream_cli, "resolve_devices",
                        lambda platform=None: [torch.device("cuda", 0)])
    clip_path = str(tmp_path / "clip.raw")
    _make_clip(clip_path, 2, 8, 8, 1)
    rc = stream_cli.main([clip_path, "8", "8", "1", "grey", "--frames", "2",
                          "--mesh-frames", "2", "--output", "null"])
    assert rc == 2
    assert "asks for 2 devices, have 1" in capsys.readouterr().err


def test_stream_cli_rejects_negative_mesh_frames(tmp_path):
    clip_path = str(tmp_path / "clip.raw")
    _make_clip(clip_path, 1, 8, 8, 1)
    with pytest.raises(SystemExit):
        stream_cli.main([clip_path, "8", "8", "1", "grey", "--frames", "1",
                         "--mesh-frames", "-1"])


def test_mesh_breakdown_renders_whole_mesh_bound(tmp_path, capsys):
    clip_path = str(tmp_path / "clip.raw")
    _make_clip(clip_path, 4, 16, 12, 3, seed=11)
    rc = stream_cli.main([
        clip_path, "12", "16", "2", "rgb", "--frames", "4",
        "--mesh-frames", "2", "--output", "null", "--breakdown",
        "--platform", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "mesh fan-out: 2 devices -> modeled whole-mesh bound" in text
    assert "PCIe contention cap" in text
    assert "pipeline bound (2 lanes)" in text
    assert text.count("per-device frames: dev0=2 dev1=2") == 1


def test_mesh_fan_emits_stream_spans(tmp_path):
    h, w, reps, n = 12, 10, 2, 4
    clip_path = tmp_path / "clip.raw"
    _make_clip(clip_path, n, h, w, 1, seed=12)
    obs.enable()
    try:
        _run(_cfg(clip_path, h, w, tconfig.ImageType.GREY, reps,
                  output="null", frames=n, mesh_frames=2), 2)
        spans = obs.get_tracer().spans()
    finally:
        obs.disable()
    names = {s.name for s in spans}
    assert {"stream.read", "stream.h2d", "stream.compute", "stream.d2h",
            "stream.write"} <= names
    assert {s.args.get("dev") for s in spans
            if s.name == "stream.compute"} == {0, 1}
    gauges = obs.snapshot()["gauges"]
    assert gauges["stream_mesh_devices"]["value"] == 2
    assert gauges["stream_inflight_depth"]["peak"] >= 1
    assert gauges["stream_inflight_depth"]["value"] == 0
    _run(_cfg(clip_path, h, w, tconfig.ImageType.GREY, reps, output="null",
              frames=n), 1)
    gauges = obs.snapshot()["gauges"]
    assert gauges["stream_mesh_devices"]["value"] == 1
    assert gauges["stream_mesh_devices"]["peak"] == 2


# -- batch-axis --frames (tests/test_cli.py's frames tests) ------------------

def _clip_file(tmp_path, rng, shape, name="clip.raw"):
    frames = rng.integers(0, 256, size=shape, dtype=np.uint8)
    src = str(tmp_path / name)
    frames.tofile(src)
    return frames, src


def _port_job(argv, n_dev, **kw):
    cfg, _ = tconfig.parse_args(argv)
    return _bounded(tdriver.run_job, cfg, devices=[CPU] * n_dev, **kw)


@pytest.mark.parametrize("n_frames,n_dev,backend", [
    (3, 1, "xla"), (5, 8, "auto"), (5, 3, "pallas"), (6, 2, "pallas"),
    (4, 4, "xla"), (7, 2, "pallas"),
])
def test_frames_batch_axis_matches_jax(tmp_path, rng, n_frames, n_dev,
                                       backend):
    frames, src = _clip_file(tmp_path, rng, (n_frames, 9, 7, 3))
    args = [src, "7", "9", "3", "rgb", "--frames", str(n_frames)]
    jout, out = str(tmp_path / "j.raw"), str(tmp_path / "t.raw")
    assert jcli.main(args + ["--output", jout]) == 0
    res = _port_job(args + ["--output", out, "--backend", backend], n_dev)
    assert open(out, "rb").read() == open(jout, "rb").read()
    if backend == "pallas":
        assert res.backend == "pallas"


@pytest.mark.parametrize("filt,image_type", [("box", "grey"),
                                             ("edge", "rgb")])
def test_frames_batch_axis_filters(tmp_path, rng, filt, image_type):
    ch = 1 if image_type == "grey" else 3
    shape = (5, 10, 8) + ((ch,) if ch == 3 else ())
    frames, src = _clip_file(tmp_path, rng, shape)
    args = [src, "8", "10", "4", image_type, "--frames", "5", "--filter",
            filt]
    jout, out = str(tmp_path / "j.raw"), str(tmp_path / "t.raw")
    assert jcli.main(args + ["--output", jout, "--mesh", "1x1"]) == 0
    _port_job(args + ["--output", out, "--backend", "pallas"], 2)
    assert open(out, "rb").read() == open(jout, "rb").read()


def test_frames_batch_axis_equals_one_device(tmp_path, rng):
    frames, src = _clip_file(tmp_path, rng, (5, 12, 10, 3))
    args = [src, "10", "12", "9", "rgb", "--frames", "5", "--backend",
            "pallas"]
    one, many = str(tmp_path / "one.raw"), str(tmp_path / "many.raw")
    _port_job(args + ["--output", one, "--mesh", "1x1"], 4)
    res = _port_job(args + ["--output", many], 4)
    assert open(one, "rb").read() == open(many, "rb").read()
    assert res.mesh_shape is None


def test_frames_mesh_selects_batch_devices(tmp_path, rng):
    frames, src = _clip_file(tmp_path, rng, (4, 6, 6))
    args = [src, "6", "6", "2", "grey", "--frames", "4", "--mesh", "1x2"]
    jout, out = str(tmp_path / "j.raw"), str(tmp_path / "t.raw")
    assert jcli.main(args + ["--output", jout]) == 0
    _port_job(args + ["--output", out], 4)
    assert open(out, "rb").read() == open(jout, "rb").read()
    with pytest.raises(ValueError, match="--mesh asks for 4 devices"):
        _port_job([src, "6", "6", "2", "grey", "--frames", "4", "--mesh",
                   "2x2", "--output", out], 2)


def test_frames_batch_axis_resume_round_trip(tmp_path, rng):
    frames, src = _clip_file(tmp_path, rng, (3, 6, 6))
    out = str(tmp_path / "t.raw")
    args = [src, "6", "6", "4", "grey", "--frames", "3", "--output", out,
            "--backend", "pallas"]
    jout = str(tmp_path / "j.raw")
    assert jcli.main([src, "6", "6", "4", "grey", "--frames", "3",
                      "--output", jout]) == 0
    tfaults.configure("compute:rep=3")
    from tpu_stencil_torch.resilience.errors import InjectedFault

    with pytest.raises(InjectedFault):
        _port_job(args, 2, checkpoint_every=2)
    tfaults.clear()
    assert os.path.exists(out + ".ckpt.json")
    _port_job(args, 2, checkpoint_every=2, resume=True)
    assert open(out, "rb").read() == open(jout, "rb").read()
    assert not os.path.exists(out + ".ckpt.json")


def test_frames_batch_axis_through_the_cli(tmp_path, rng, capsys,
                                           monkeypatch):
    frames, src = _clip_file(tmp_path, rng, (6, 24, 16, 3))
    monkeypatch.setattr(tcli, "resolve_devices",
                        lambda platform=None: [CPU] * 2)
    args = [src, "16", "24", "5", "rgb", "--frames", "6"]
    jout, out = str(tmp_path / "j.raw"), str(tmp_path / "t.raw")
    assert jcli.main(args + ["--output", jout, "--mesh", "1x2",
                             "--backend", "pallas"]) == 0
    capsys.readouterr()
    assert tcli.main(args + ["--output", out, "--backend", "pallas",
                             "--platform", "cpu", "--time"]) == 0
    assert "backend=pallas" in capsys.readouterr().out
    assert open(out, "rb").read() == open(jout, "rb").read()


def test_frames_batch_axis_warms_every_device(tmp_path, rng, monkeypatch):
    # The warm-up runs each device's share once on a scratch copy (3 reps
    # at fuse 8 launch single reps: the warm-up's depth is 1); the window
    # then runs every share.
    seen = []
    from tpu_stencil_torch.models.blur import IteratedConv2D

    real = IteratedConv2D.batch_on

    def spy(self, x, n):
        seen.append((tuple(x.shape), n))
        return real(self, x, n)

    monkeypatch.setattr(IteratedConv2D, "batch_on", spy)
    frames, src = _clip_file(tmp_path, rng, (5, 8, 6, 3))
    _port_job([src, "6", "8", "3", "rgb", "--frames", "5", "--output",
               str(tmp_path / "t.raw"), "--backend", "pallas"], 2)
    assert seen == [((3, 8, 6, 3), 1)] * 2 + [((3, 8, 6, 3), 3)] * 2


def test_two_processes_batch_their_frames_over_two_devices(tmp_path, rng):
    # Two gloo processes, two devices each: every rank batches its frame
    # range over its devices; the file equals one process's bytes.
    import test_torch_multiprocess as mp

    frames, src = _clip_file(tmp_path, rng, (7, 10, 8, 3))
    dst = str(tmp_path / "out.raw")
    res = mp._launch("job", mp._spec(src, dst, 8, 10, reps=3, frames=7,
                                     tiles=2, backend="pallas"))
    assert all(r["backend"] == "pallas" for r in res)
    one = str(tmp_path / "one.raw")
    _port_job([src, "8", "10", "3", "rgb", "--frames", "7", "--output", one,
               "--backend", "pallas", "--mesh", "1x1"], 1)
    assert open(dst, "rb").read() == open(one, "rb").read()
    jout = str(tmp_path / "j.raw")
    assert jcli.main([src, "8", "10", "3", "rgb", "--frames", "7",
                      "--output", jout]) == 0
    assert open(dst, "rb").read() == open(jout, "rb").read()
