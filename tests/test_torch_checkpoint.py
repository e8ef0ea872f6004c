"""Checkpoint and resume of the port against the JAX package's.

Both packages write one on-disk format (raw frame or versioned sharded
data file, CRC-stamped JSON sidecar with the job's fingerprint), so a
checkpoint written by either resumes in the other: the JAX job is killed
by an injected fault after its first checkpoint and the port resumes it,
and the reverse, on one device and on a 2x2 mesh (the JAX one on 4 fake
CPU devices, the port's on ``[cpu] * 4``). Each resumed run must write the
bytes of an uninterrupted run. Corrupt and foreign sidecars are refused as
in JAX. Tolerance: exact bytes.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil.resilience import errors as jerrors
from tpu_stencil.resilience import faults as jfaults
from tpu_stencil.runtime import checkpoint as jckpt
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.parallel.sharded import ShardedRunner
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.resilience import errors as terrors
from tpu_stencil_torch.resilience import faults as tfaults
from tpu_stencil_torch.runtime import checkpoint as tckpt

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H, REPS, EVERY = 48, 64, 7, 3


@pytest.fixture(autouse=True)
def _clean():
    for m in (tfaults, jfaults):
        m.clear()
    obs.reset()
    yield
    for m in (tfaults, jfaults):
        m.reset()
    obs.reset()


def _src(tmp_path, channels=3, seed=31):
    shape = (H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    path = tmp_path / f"in{channels}.raw"
    img.tofile(path)
    return str(path), img


def _argv(src, channels=3, extra=()):
    return [src, str(W), str(H), str(REPS),
            "rgb" if channels == 3 else "grey", *extra]


def _port(argv, out, mesh, **kw):
    cfg, _ = tconfig.parse_args(argv + ["--output", str(out)])
    return tdriver.run_job(cfg, devices=[CPU] * (4 if mesh else 1), **kw)


def _jax(argv, out, mesh, **kw):
    cfg, _ = jconfig.parse_args(argv + ["--output", str(out)])
    devs = jax.devices()[:4] if mesh else jax.devices("cpu")[:1]
    return jdriver.run_job(cfg, devices=devs, **kw)


def _extra(mesh):
    return ["--backend", "pallas"] + (["--mesh", "2x2"] if mesh else [])


def test_save_restore_round_trip_and_format_is_jax_readable(tmp_path):
    src, img = _src(tmp_path)
    cfg, _ = tconfig.parse_args(_argv(src) + ["--output",
                                              str(tmp_path / "o.raw")])
    jcfg, _ = jconfig.parse_args(_argv(src) + ["--output",
                                               str(tmp_path / "o.raw")])
    frame = np.random.default_rng(2).integers(0, 256, img.shape, np.uint8)
    tckpt.save(cfg, 4, frame)
    rep, got = jckpt.restore(jcfg)
    assert rep == 4 and np.array_equal(got, frame)
    jckpt.save(jcfg, 5, img)
    rep, got = tckpt.restore(cfg)
    assert rep == 5 and np.array_equal(got, img)
    tckpt.clear(cfg)
    assert tckpt.restore(cfg) is None and jckpt.restore(jcfg) is None


def test_sharded_save_restore_round_trip(tmp_path):
    src, img = _src(tmp_path)
    cfg, _ = tconfig.parse_args(_argv(src) + ["--output",
                                              str(tmp_path / "o.raw")])
    model = IteratedConv2D("gaussian", backend="pallas", device=CPU)
    runner = ShardedRunner(model, (H, W), 3, mesh_shape=(2, 2),
                           devices=[CPU] * 4)
    tckpt.save_sharded(cfg, 3, runner.put(img))
    meta = json.load(open(str(tmp_path / "o.raw.ckpt.json")))
    assert meta["data"] == "o.raw.ckpt.r3" and meta["rep"] == 3
    tckpt.save_sharded(cfg, 6, runner.put(img))
    # The older version is swept once the newer one is committed.
    assert not os.path.exists(tmp_path / "o.raw.ckpt.r3")
    rep, tiles = tckpt.restore_sharded(cfg, runner)
    assert rep == 6 and np.array_equal(runner.fetch(tiles), img)


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(tmp_path, writer, mesh):
    src, _ = _src(tmp_path)
    argv = _argv(src, extra=_extra(mesh))
    out = tmp_path / "out.raw"
    _jax(argv, tmp_path / "ref_j.raw", mesh)
    _port(argv, tmp_path / "ref_t.raw", mesh)
    ref = (tmp_path / "ref_j.raw").read_bytes()
    assert (tmp_path / "ref_t.raw").read_bytes() == ref
    # The writer checkpoints every 3 reps and dies at rep 4: its last
    # committed checkpoint holds 3 reps.
    if writer == "jax":
        jfaults.configure("compute:rep=4")
        with pytest.raises(jerrors.InjectedFault):
            _jax(argv, out, mesh, checkpoint_every=EVERY)
    else:
        tfaults.configure("compute:rep=4")
        with pytest.raises(terrors.InjectedFault):
            _port(argv, out, mesh, checkpoint_every=EVERY)
    meta = json.load(open(str(out) + ".ckpt.json"))
    assert meta["rep"] == 3 and ("data" in meta) == mesh
    if writer == "jax":
        _port(argv, out, mesh, checkpoint_every=EVERY, resume=True)
    else:
        _jax(argv, out, mesh, checkpoint_every=EVERY, resume=True)
    assert out.read_bytes() == ref
    assert not os.path.exists(str(out) + ".ckpt.json")


@pytest.mark.parametrize("mesh", [False, True])
def test_resume_window_launches_cover_only_the_remaining_reps(
        tmp_path, monkeypatch, mesh):
    kernel = "stencil_valid" if mesh else "stencil_fused"
    real = getattr(cs, kernel)

    def spy(*a, **k):
        spy.launches += 1
        return real(*a, **k)

    spy.launches = 0
    monkeypatch.setattr(cs, kernel, spy)
    src, _ = _src(tmp_path, channels=1)
    argv = _argv(src, channels=1, extra=_extra(mesh))
    out = tmp_path / "out.raw"
    tfaults.configure("compute:rep=4")
    with pytest.raises(terrors.InjectedFault):
        _port(argv, out, mesh, checkpoint_every=EVERY)
    res = _port(argv, out, mesh, checkpoint_every=EVERY, resume=True)
    # 4 reps remain: a chunk of 3 and one of 1, each below the fuse of 8,
    # so one launch per rep (per tile on the mesh).
    assert res.launches[kernel] == 4 * (4 if mesh else 1)
    _jax(argv, tmp_path / "ref.raw", mesh)
    assert out.read_bytes() == (tmp_path / "ref.raw").read_bytes()


@pytest.mark.parametrize("mesh", [False, True])
def test_checkpointed_run_matches_plain_and_clears(tmp_path, mesh):
    src, _ = _src(tmp_path)
    argv = _argv(src, extra=_extra(mesh))
    _port(argv, tmp_path / "a.raw", mesh, checkpoint_every=EVERY)
    _port(argv, tmp_path / "b.raw", mesh)
    assert (tmp_path / "a.raw").read_bytes() == (tmp_path / "b.raw").read_bytes()
    assert [n for n in os.listdir(tmp_path) if ".ckpt" in n] == []


def test_resume_only_run_clears_and_missing_checkpoint_starts_over(tmp_path):
    src, _ = _src(tmp_path)
    argv = _argv(src, extra=["--backend", "xla"])
    res = _port(argv, tmp_path / "a.raw", False, resume=True)
    _jax(argv, tmp_path / "b.raw", False)
    assert (tmp_path / "a.raw").read_bytes() == (tmp_path / "b.raw").read_bytes()
    assert res.compute_seconds >= 0


def _sidecar(tmp_path, writer):
    src, img = _src(tmp_path)
    out = str(tmp_path / "o.raw")
    cfgs = (tconfig.parse_args(_argv(src) + ["--output", out])[0],
            jconfig.parse_args(_argv(src) + ["--output", out])[0])
    (tckpt if writer == "port" else jckpt).save(
        cfgs[0] if writer == "port" else cfgs[1], 3, img)
    return cfgs, out + ".ckpt.json"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corrupt_sidecar_refused_as_in_jax(tmp_path, writer):
    (tcfg, jcfg), meta_path = _sidecar(tmp_path, writer)
    raw = open(meta_path).read()
    open(meta_path, "w").write(raw.replace('"rep": 3', '"rep": 4'))
    with pytest.raises(jckpt.CorruptCheckpoint) as jerr:
        jckpt.restore(jcfg)
    with pytest.raises(tckpt.CorruptCheckpoint) as terr:
        tckpt.restore(tcfg)
    assert str(terr.value) == str(jerr.value) and terr.value.path == meta_path
    open(meta_path, "w").write("{not json")
    with pytest.raises(tckpt.CorruptCheckpoint, match="unparseable"):
        tckpt.restore(tcfg)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_foreign_sidecar_refused_as_in_jax(tmp_path, writer):
    (tcfg, jcfg), _ = _sidecar(tmp_path, writer)
    src = tcfg.image
    other = ["--filter", "box", "--output", str(tmp_path / "o.raw")]
    tother, _ = tconfig.parse_args(_argv(src) + other)
    jother, _ = jconfig.parse_args(_argv(src) + other)
    with pytest.raises(ValueError, match="different job") as jerr:
        jckpt.restore(jother)
    with pytest.raises(ValueError, match="different job") as terr:
        tckpt.restore(tother)
    assert str(terr.value) == str(jerr.value)


def test_negative_checkpoint_every_rejected(tmp_path, capsys):
    src, _ = _src(tmp_path)
    with pytest.raises(SystemExit):
        tconfig.parse_args(_argv(src) + ["--checkpoint-every", "-1"])
    assert "--checkpoint-every must be >= 0" in capsys.readouterr().err
    cfg, _ = tconfig.parse_args(_argv(src))
    with pytest.raises(ValueError):
        tdriver.run_job(cfg, devices=[CPU], checkpoint_every=-2)


def test_stale_version_sweep_is_rep_ordered(tmp_path):
    base = str(tmp_path / "x.raw.ckpt")
    for r in (3, 10, 20):
        open(f"{base}.r{r}", "w").close()
    open(f"{base}.rbogus", "w").close()
    got = sorted(os.path.basename(p)
                 for p in tckpt._stale_versions(base, before_rep=10))
    want = sorted(os.path.basename(p)
                  for p in jckpt._stale_versions(base, before_rep=10))
    assert got == want == ["x.raw.ckpt.r3"]
