"""The port's spatial sharding against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages: the partitioner,
the halo exchange (the JAX one under ``shard_map`` on the 8 fake CPU
devices of ``conftest.py``, the port's over a grid of tiles on
``[cpu] * n``), the sharded runner on both backends (K3's plain version
for ``pallas`` on the CPU, torch ops for ``xla``), the sharded file I/O,
and the ``--mesh`` job end to end. Tolerance: exact byte equality — every
plan here is integer, and the one float32 divide is correctly rounded in
both packages.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil.models.blur import IteratedConv2D as JaxModel
from tpu_stencil.parallel import halo as jhalo
from tpu_stencil.parallel import mesh as jmesh
from tpu_stencil.parallel import partition as jpartition
from tpu_stencil.parallel.sharded import ShardedRunner as JaxRunner
from tpu_stencil.parallel.sharded import shard_map
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch.io import native, raw
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.parallel import distributed, halo, mesh, partition
from tpu_stencil_torch.parallel.sharded import ShardedRunner
from tpu_stencil_torch.utils.timing import Timer

# The tensors here are tiny: one thread each, and the cores stay with the
# other test workers (their wall-clock assertions starve otherwise).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FIELDS = ("mesh_shape", "tile", "padded_shape", "needs_mask", "backend",
          "fuse")


def _img(shape, seed=61):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# -- partition and mesh ----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("hw", [(32, 40), (2520, 1920), (7, 300), (33, 41)],
                         ids=str)
def test_partition_matches_jax(n, hw):
    h, w = hw
    grid = partition.grid_shape(n, h, w)
    assert grid == jpartition.grid_shape(n, h, w)
    for cols_div in (2, 4):
        assert (partition.grid_shape(n, h, w, cols_must_divide=cols_div)
                == jpartition.grid_shape(n, h, w, cols_must_divide=cols_div))
    assert partition.pad_amounts(h, w, grid) == jpartition.pad_amounts(
        h, w, grid)
    assert partition.tile_shape(h, w, grid) == jpartition.tile_shape(
        h, w, grid)


def test_partition_rejects_no_devices():
    for grid_shape in (partition.grid_shape, jpartition.grid_shape):
        with pytest.raises(ValueError, match="n_devices must be >= 1"):
            grid_shape(0, 8, 8)


@pytest.mark.parametrize("n,image", [(8, (32, 40)), (8, (400, 16)),
                                     (4, None), (6, (30, 90))])
def test_mesh_shape_matches_jax(n, image):
    m = mesh.make_mesh(None, [CPU] * n, image_shape=image)
    jm = jmesh.make_mesh(None, jax.devices()[:n], image_shape=image)
    assert m.grid == (jm.shape[jmesh.ROWS_AXIS], jm.shape[jmesh.COLS_AXIS])
    assert m.shape == {mesh.ROWS_AXIS: m.grid[0], mesh.COLS_AXIS: m.grid[1]}
    assert m.flat() == [CPU] * n


def test_mesh_keeps_device_order_and_rejects_a_wrong_count():
    devs = [torch.device("cpu", i) for i in range(6)]
    m = mesh.make_mesh((2, 3), devs)
    assert m.devices[1][0] == devs[3] and m.flat() == devs
    for make, d in ((mesh.make_mesh, [CPU] * 3),
                    (jmesh.make_mesh, jax.devices()[:3])):
        with pytest.raises(ValueError, match="mesh shape 2x2 != 3 devices"):
            make((2, 2), d)


# -- halo exchange ----------------------------------------------------------


def _jax_exchange(img, grid, h, boundary):
    r, c = grid
    jm = jmesh.make_mesh(grid, jax.devices()[:r * c])
    axes = ((jmesh.ROWS_AXIS, r, 0), (jmesh.COLS_AXIS, c, 1))
    spec = (P(jmesh.ROWS_AXIS, jmesh.COLS_AXIS) if img.ndim == 2
            else P(jmesh.ROWS_AXIS, jmesh.COLS_AXIS, None))
    fn = shard_map(lambda x: jhalo.halo_exchange(x, h, axes, boundary),
                   mesh=jm, in_specs=(spec,), out_specs=spec)
    return np.asarray(jax.jit(fn)(jnp.asarray(img)))


def _tiles(img, grid):
    r, c = grid
    th, tw = img.shape[0] // r, img.shape[1] // c
    return [[torch.from_numpy(np.ascontiguousarray(
        img[i * th:(i + 1) * th, j * tw:(j + 1) * tw])) for j in range(c)]
        for i in range(r)]


def _stitch(tiles):
    return np.concatenate([np.concatenate([t.numpy() for t in row], 1)
                           for row in tiles], 0)


@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("grid", [(2, 2), (2, 4)], ids=str)
def test_halo_exchange_matches_jax(grid, boundary, h):
    img = _img((16, 24, 3) if h == 2 else (16, 24), seed=62 + h)
    want = _jax_exchange(img, grid, h, boundary)
    tiles = _tiles(img, grid)
    got = halo.halo_exchange(tiles, h, (0, 1), boundary)
    np.testing.assert_array_equal(_stitch(got), want)
    # The exchange builds fresh tiles: the input tiles are unchanged.
    np.testing.assert_array_equal(_stitch(tiles), img)


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_halo_exchange_axis_of_one_tile(boundary):
    img = _img((8, 6))
    got = halo.halo_exchange([[torch.from_numpy(img)]], 2, (0, 1), boundary)
    np.testing.assert_array_equal(
        got[0][0].numpy(),
        np.pad(img, 2, mode="constant" if boundary == "zero" else "wrap"))
    assert halo.halo_exchange([[torch.from_numpy(img)]], 0)[0][0].shape == (
        8, 6)
    with pytest.raises(ValueError, match="unknown boundary"):
        halo.halo_exchange([[torch.from_numpy(img)]], 1, (0,), "mirror")


# -- the sharded runner -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_runner(grid, shape, backend, name, boundary):
    n = grid[0] * grid[1]
    ch = shape[2] if len(shape) == 3 else 1
    return JaxRunner(JaxModel(name, backend=backend, boundary=boundary),
                     shape[:2], ch, mesh_shape=grid,
                     devices=jax.devices()[:n])


def _port_runner(grid, shape, backend, name, boundary="zero", **kw):
    ch = shape[2] if len(shape) == 3 else 1
    model = IteratedConv2D(name, backend=backend, boundary=boundary,
                           device="cpu", **kw)
    return ShardedRunner(model, shape[:2], ch, mesh_shape=grid,
                         devices=[CPU] * (grid[0] * grid[1]))


def _check_runner(grid, shape, backend, name, reps, boundary="zero"):
    img = _img(shape, seed=63)
    jr = _jax_runner(grid, shape, backend, name, boundary)
    tr = _port_runner(grid, shape, backend, name, boundary)
    for f in FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    want_sched = (cs.effective_schedule(jr.schedule)
                  if jr.backend == "pallas" else None)
    assert tr.schedule == want_sched
    want = jr.fetch(jr.run(jr.put(img), reps))
    got = tr.fetch(tr.run(tr.put(img), reps))
    np.testing.assert_array_equal(got, want)
    return tr


@pytest.mark.parametrize("reps", [0, 1, 7, 8, 9, 11])
@pytest.mark.parametrize("shape", [(32, 40), (24, 16, 3), (33, 41)], ids=str)
@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (8, 1), (1, 8), (2, 2)],
                         ids=str)
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_runner_matches_jax(backend, grid, shape, reps):
    tr = _check_runner(grid, shape, backend, "gaussian", reps)
    if tr.needs_mask:
        assert tr.fuse == 1  # the pad re-zero runs after every rep


@pytest.mark.parametrize("name,grid,shape", [
    ("gaussian5", (2, 2), (32, 40, 3)),
    ("gaussian5", (1, 8), (24, 16, 3)),   # tile 24x2: fuse clamped to 1
    ("gaussian7", (2, 2), (32, 40)),      # tile 16x20: fuse clamped to 5
    ("gaussian7", (8, 1), (32, 40)),      # tile 4x40: fuse clamped to 1
    ("gaussian5", (2, 4), (33, 41, 3)),   # wide halo under the pad mask
    ("box", (2, 2), (32, 40, 3)),
    ("edge", (4, 2), (32, 40, 3)),
])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_runner_wide_halos_and_other_plans_match_jax(backend, name, grid,
                                                     shape):
    tr = _check_runner(grid, shape, backend, name, 9)
    if backend == "pallas" and not tr.needs_mask:
        th, tw = tr.tile
        assert tr.fuse == min(cs.DEFAULT_FUSE, min(th, tw) // tr.model.plan.halo)


@pytest.mark.parametrize("reps", [0, 1, 9])
@pytest.mark.parametrize("shape", [(32, 40), (24, 16, 3)], ids=str)
@pytest.mark.parametrize("grid", [(2, 2), (2, 4), (1, 8)], ids=str)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_periodic_runner_matches_jax(backend, grid, shape, reps):
    # Periodic runs torch ops on both backends (K3 is zero-boundary).
    tr = _check_runner(grid, shape, backend, "gaussian", reps, "periodic")
    assert tr.backend == "xla" and tr.fuse == 1


@pytest.mark.parametrize("schedule,fuse,block_h", [
    ("deep", None, None), (None, 3, None), (None, None, 16)])
def test_forced_geometry_and_deep(schedule, fuse, block_h):
    img = _img((64, 48, 3), seed=64)
    tr = _port_runner((2, 2), img.shape, "pallas", "gaussian",
                      schedule=schedule, fuse=fuse, block_h=block_h)
    assert tr.geo_applied and tr.schedule == "fused"
    if schedule == "deep":
        assert tr.fuse == min(cs.deep_fuse_for(tr.model.plan, 32, 3), 24)
    if fuse is not None:
        assert tr.fuse == fuse
    if block_h is not None:
        assert tr.block_h_eff == block_h
    want = cs.iterate(torch.from_numpy(img), 11, tr.model.plan).numpy()
    np.testing.assert_array_equal(tr.fetch(tr.run(tr.put(img), 11)), want)


def test_runner_launches_and_reports(monkeypatch):
    # One K3 launch per tile per chunk: reps // fuse chunks, then singles.
    calls = []
    orig = cs.valid_fused
    monkeypatch.setattr(cs, "valid_fused",
                        lambda *a, **k: calls.append(a[2]) or orig(*a, **k))
    tr = _port_runner((2, 2), (32, 40, 3), "pallas", "gaussian")
    assert tr.fuse == 8 and tr.devices == [CPU] * 4
    tr.prepare()  # no card: nothing to build
    img = _img((32, 40, 3))
    out = tr.run(tr.put(img), 11)
    assert calls == [8] * 4 + [1] * 12
    assert all(t.shape == (16, 20, 3) for row in out for t in row)


def test_runner_rejections():
    # A tile smaller than the halo: both packages refuse.
    with pytest.raises(ValueError, match="halo"):
        _port_runner((8, 1), (16, 40), "xla", "gaussian7")
    with pytest.raises(ValueError, match="halo"):
        _jax_runner((8, 1), (16, 40), "xla", "gaussian7", "zero")
    # Periodic with padding would wrap the pad into the image.
    with pytest.raises(NotImplementedError, match="periodic"):
        _port_runner((2, 2), (33, 41), "xla", "gaussian", "periodic")
    with pytest.raises(NotImplementedError, match="periodic"):
        _jax_runner((2, 2), (33, 41), "xla", "gaussian", "periodic")
    # A mesh larger than the device list.
    model = IteratedConv2D(device="cpu")
    with pytest.raises(ValueError, match="mesh shape 2x4 != 4 devices"):
        ShardedRunner(model, (32, 40), 1, mesh_shape=(2, 4), devices=[CPU] * 4)
    tr = _port_runner((2, 2), (32, 40), "xla", "gaussian")
    with pytest.raises(ValueError, match="image shape"):
        tr.put(_img((31, 40)))


# -- sharded I/O ------------------------------------------------------------


@pytest.mark.parametrize("shape,grid", [((33, 41, 3), (2, 4)),
                                        ((32, 40), (4, 2))])
def test_read_and_write_sharded_round_trip(tmp_path, shape, grid):
    img = _img(shape, seed=65)
    ch = shape[2] if len(shape) == 3 else 1
    src = tmp_path / "in.raw"
    img.tofile(src)
    tr = _port_runner(grid, shape, "xla", "gaussian")
    tiles = distributed.read_sharded(str(src), shape[0], shape[1], ch, tr.mesh)
    np.testing.assert_array_equal(_stitch(tiles), _stitch(tr.put(img)))
    dst = tmp_path / "out.raw"
    dst.write_bytes(b"\xff" * (img.size + 100))  # a stale larger file
    distributed.write_sharded(str(dst), tiles, shape[0], shape[1], ch)
    assert dst.read_bytes() == img.tobytes()


def test_device_row_ranges():
    got = distributed.device_row_ranges(34, 44, (2, 4))
    assert got[(1, 2)] == (distributed.RowRange(17, 34), 22, 11)
    assert len(got) == 8


def test_raw_block_writes_touch_only_their_columns(tmp_path):
    path = str(tmp_path / "o.raw")
    native.set_size(path, 4 * 5 * 3)
    assert os.path.getsize(path) == 60
    block = _img((2, 3, 3))
    raw.write_raw_block(path, 1, 2, block, 5, 3, 4)
    got = np.fromfile(path, np.uint8).reshape(4, 5, 3)
    np.testing.assert_array_equal(got[1:3, 2:5], block)
    got[1:3, 2:5] = 0
    assert not got.any()
    rows = _img((1, 5, 3))
    raw.write_raw_rows(path, 3, rows, 5, 3, 4)
    np.testing.assert_array_equal(
        np.fromfile(path, np.uint8).reshape(4, 5, 3)[3:], rows)
    with pytest.raises(ValueError, match="outside image"):
        raw.write_raw_block(path, 3, 4, block, 5, 3, 4)
    native.ensure_size(path, 30)   # never shrinks
    assert os.path.getsize(path) == 60
    native.set_size(path, 30)      # set_size does
    assert os.path.getsize(path) == 30


def test_sharded_read_refuses_a_pipe(tmp_path):
    fifo = tmp_path / "p"
    os.mkfifo(fifo)
    with pytest.raises(ValueError, match="not a regular file"):
        distributed.read_sharded(str(fifo), 4, 4, 1, mesh.make_mesh(
            (1, 1), [CPU]))


def test_timer_fences_a_mesh():
    with Timer("iterate", device=[CPU, CPU, "cpu"]) as t:
        pass
    assert t.elapsed >= 0.0


# -- the --mesh job end to end ----------------------------------------------


W, H = 23, 19


def _raw(tmp_path, channels, seed=66, size=(H, W)):
    shape = size + ((3,) if channels == 3 else ())
    path = tmp_path / f"in_{channels}.raw"
    _img(shape, seed).tofile(path)
    return str(path)


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


@pytest.mark.parametrize("image_type", ["grey", "rgb"])
def test_python_m_mesh_1x1_matches_jax(tmp_path, image_type):
    src = _raw(tmp_path, 3 if image_type == "rgb" else 1)
    outs = {}
    for pkg in ("tpu_stencil", "tpu_stencil_torch"):
        out = str(tmp_path / f"{pkg}.raw")
        r = subprocess.run(
            [sys.executable, "-m", pkg, src, str(W), str(H), "9", image_type,
             "--mesh", "1x1", "--platform", "cpu", "--backend", "pallas",
             "--time", "--output", out],
            capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
        )
        assert r.returncode == 0, r.stderr
        assert "mesh=(1, 1)" in r.stdout, r.stdout
        outs[pkg] = open(out, "rb").read()
    assert outs["tpu_stencil_torch"] == outs["tpu_stencil"]


@pytest.mark.parametrize("extra", [[], ["--backend", "pallas"],
                                   ["--filter", "gaussian5"],
                                   ["--boundary", "periodic", "--backend",
                                    "xla"]])
@pytest.mark.parametrize("image_type", ["grey", "rgb"])
def test_run_job_mesh_2x2_matches_jax_cli(tmp_path, image_type, extra):
    ch = 3 if image_type == "rgb" else 1
    periodic = "--boundary" in extra
    w, h = (24, 20) if periodic else (W, H)  # periodic needs a divisible grid
    src = _raw(tmp_path, ch, size=(h, w))
    argv = [src, str(w), str(h), "9", image_type, "--mesh", "2x2"] + extra
    jcfg, _ = jconfig.parse_args(argv + ["--output", str(tmp_path / "j.raw")])
    jres = jdriver.run_job(jcfg, devices=jax.devices()[:4])
    tcfg, _ = tconfig.parse_args(argv + ["--output", str(tmp_path / "t.raw")])
    assert tcfg.mesh_shape == jcfg.mesh_shape == (2, 2)
    tres = tdriver.run_job(tcfg, devices=[CPU] * 4)
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()
    assert tres.mesh_shape == jres.mesh_shape == (2, 2)
    assert tres.backend == jres.backend
    assert tres.launches == {"stencil_fused": 0, "stencil_resident": 0,
                             "stencil_valid": 0}  # plain versions on the CPU


def test_run_job_routes_like_jax(tmp_path):
    src = _raw(tmp_path, 3)
    cfg = tconfig.JobConfig(src, W, H, 3, tconfig.ImageType.RGB,
                            output=str(tmp_path / "o.raw"))
    # More than one device: sharded over the perimeter-minimizing grid.
    assert tdriver.run_job(cfg, devices=[CPU] * 2).mesh_shape == (1, 2)
    assert jpartition.grid_shape(2, H, W) == (1, 2)
    # One device and no --mesh: the single-device path.
    assert tdriver.run_job(cfg, devices=[CPU]).mesh_shape is None
    # Periodic without --mesh on several devices runs on one tile.
    per = tconfig.JobConfig(src, W, H, 3, tconfig.ImageType.RGB,
                            boundary="periodic", output=str(tmp_path / "p.raw"))
    assert tdriver.run_job(per, devices=[CPU] * 4).mesh_shape == (1, 1)
    # --mesh RxC takes the first R*C devices, and needs that many.
    m = tconfig.JobConfig(src, W, H, 3, tconfig.ImageType.RGB,
                          mesh_shape=(1, 2), output=str(tmp_path / "m.raw"))
    assert tdriver.run_job(m, devices=[CPU] * 8).mesh_shape == (1, 2)
    with pytest.raises(ValueError, match="mesh shape 1x2 != 1 devices"):
        tdriver.run_job(m, devices=[CPU])


def test_forced_geometry_is_reported(tmp_path):
    src = _raw(tmp_path, 3, size=(40, 32))
    cfg = tconfig.JobConfig(src, 32, 40, 9, tconfig.ImageType.RGB,
                            backend="pallas", mesh_shape=(2, 2), fuse=3,
                            output=str(tmp_path / "o.raw"))
    res = tdriver.run_job(cfg, devices=[CPU] * 4)
    assert (res.backend, res.schedule, res.block_h, res.fuse) == (
        "pallas", "fused", 24, 3)
    jcfg, _ = jconfig.parse_args([src, "32", "40", "9", "rgb", "--mesh", "2x2",
                                  "--backend", "pallas", "--fuse", "3",
                                  "--output", str(tmp_path / "j.raw")])
    jdriver.run_job(jcfg, devices=jax.devices()[:4])
    assert (tmp_path / "o.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()


def test_frames_over_several_devices_is_not_ported(tmp_path):
    # The name is the test's history: since the streaming slice a clip
    # over several devices runs on the batch axis (a contiguous share per
    # device) and writes the bytes of one device.
    src = str(tmp_path / "clip.raw")
    _img((3 * H, W, 3)).tofile(src)
    base = dict(image=src, width=W, height=H, repetitions=2,
                image_type=tconfig.ImageType.RGB, frames=3,
                output=str(tmp_path / "o.raw"))
    res = tdriver.run_job(tconfig.JobConfig(**base), devices=[CPU] * 2)
    assert res.mesh_shape is None
    many = (tmp_path / "o.raw").read_bytes()
    tdriver.run_job(tconfig.JobConfig(**base), devices=[CPU])
    assert (tmp_path / "o.raw").read_bytes() == many
    with pytest.raises(ValueError, match="--mesh asks for 4 devices, have 1"):
        tdriver.run_job(tconfig.JobConfig(**base, mesh_shape=(2, 2)),
                        devices=[CPU])
    # --mesh 1x1 keeps the clip on one device.
    res = tdriver.run_job(tconfig.JobConfig(**base, mesh_shape=(1, 1)),
                          devices=[CPU] * 2)
    assert res.mesh_shape is None


@pytest.mark.parametrize("value", ["2x", "x2", "0x2", "2y2", "1x2x"])
def test_mesh_flag_errors_match_jax(value, capsys):
    argv = ["i.raw", "8", "8", "1", "grey", "--mesh", value]
    for parse in (tconfig.parse_args, jconfig.parse_args):
        with pytest.raises(SystemExit):
            parse(argv)
        assert "--mesh must be RxC with positive integers" in (
            capsys.readouterr().err)


def test_mesh_shape_validation_matches_jax():
    for pkg in (tconfig, jconfig):
        with pytest.raises(ValueError, match="mesh_shape must be two positive"):
            pkg.JobConfig("i.raw", 8, 8, 1, pkg.ImageType.GREY,
                          mesh_shape=(0, 2))


# -- the tuning path on a mesh ----------------------------------------------


def test_autotune_on_a_mesh_runs_and_reports_the_tile_verdict(
        tmp_path, monkeypatch, capsys):
    """``--backend autotune --mesh 2x2``: the runner resolves against the
    per-device tile through the injected measure (the port pretends to be
    on a card), runs the verdict's geometry in K3, ``JobResult`` and the
    ``--time`` line name it, the bytes are the JAX package's, and a second
    job makes zero probes."""
    from tpu_stencil_torch import cli as tcli
    from tpu_stencil_torch.runtime import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_on_card", lambda device: True)
    shapes = []

    def measure(plan, shape, channels, backend, reps=0, schedule=None,
                block_h=None, fuse=None, device=None):
        shapes.append(shape)
        if backend == "xla":
            return 9e-6
        if schedule != "fused":
            return 5e-6
        return 1e-6 if (block_h, fuse) == (32, 10) else 3e-6

    monkeypatch.setattr(autotune, "measure_backend", measure)
    src = _raw(tmp_path, 3, size=(40, 32))
    jcfg, _ = jconfig.parse_args([src, "32", "40", "9", "rgb", "--mesh", "2x2",
                                  "--backend", "xla",
                                  "--output", str(tmp_path / "j.raw")])
    jdriver.run_job(jcfg, devices=jax.devices()[:4])
    want = (tmp_path / "j.raw").read_bytes()
    for run in ("cold", "warm"):
        cfg = tconfig.JobConfig(src, 32, 40, 9, tconfig.ImageType.RGB,
                                backend="autotune", mesh_shape=(2, 2),
                                output=str(tmp_path / f"{run}.raw"))
        res = tdriver.run_job(cfg, devices=[CPU] * 4)
        assert (res.backend, res.schedule, res.block_h, res.fuse) == (
            "pallas", "fused", 24, 10)  # (32, 10) on a 20-row tile
        assert res.mesh_shape == (2, 2)
        assert (res.tune_probes > 0) == (run == "cold")
        assert (tmp_path / f"{run}.raw").read_bytes() == want
    assert set(shapes) == {(20, 16)}  # tuned against the tile, not the image
    # the CLI names it too (one device here, so --mesh 1x1: the whole image)
    assert tcli.main([src, "32", "40", "9", "rgb", "--mesh", "1x1",
                      "--backend", "autotune", "--platform", "cpu", "--time",
                      "--output", str(tmp_path / "c.raw")]) == 0
    line = capsys.readouterr().out.rstrip().splitlines()[1]
    assert ("backend=pallas schedule=fused block_h=32 fuse=10 overlap=off "
            "mesh=(1, 1)"
            in line), line
    assert "stencil_valid:0" in line and "tune_probes=" in line
    assert (tmp_path / "c.raw").read_bytes() == want
