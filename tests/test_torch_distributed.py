"""The port's several-process layer in one process, against the JAX
package's.

The port's mirror of ``tests/test_distributed.py``: the sharded read and
write equal whole-file I/O and the JAX package's, byte for byte; the
config broadcast is the identity with one process and its string codec is
the JAX package's; ``initialize`` is a no-op for one process. Then what a
process of several does with its own tiles only, on a mesh whose owner
ranks are given (:attr:`Mesh.owners`): it reads only its bands, writes
only its rectangles, and merges contiguous column tiles into one write.
Tolerance: exact — every plan here is integer.
"""

import os

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import filters as jfilters
from tpu_stencil.config import ImageType as JImageType
from tpu_stencil.config import JobConfig as JJobConfig
from tpu_stencil.models.blur import IteratedConv2D as JaxModel
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil.parallel import distributed as jdistributed
from tpu_stencil.parallel import sharded as jsharded
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch.io import raw as raw_io
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.parallel import distributed
from tpu_stencil_torch.parallel.mesh import Mesh
from tpu_stencil_torch.parallel.sharded import ShardedRunner

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _runner(shape, channels, mesh_shape, backend="xla"):
    return ShardedRunner(IteratedConv2D("gaussian", backend=backend,
                                        device=CPU),
                         shape, channels, mesh_shape=mesh_shape,
                         devices=[CPU] * (mesh_shape[0] * mesh_shape[1]))


def _jax_runner(shape, channels, mesh_shape):
    return jsharded.ShardedRunner(
        JaxModel("gaussian", backend="xla"), shape, channels,
        mesh_shape=mesh_shape,
        devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])


def _stitch(tiles) -> np.ndarray:
    return np.concatenate([np.concatenate([t.numpy() for t in row], axis=1)
                           for row in tiles], axis=0)


def _write(tmp_path, img, name="in.raw") -> str:
    p = str(tmp_path / name)
    img.tofile(p)
    return p


@pytest.mark.parametrize("shape,channels", [((32, 40), 1), ((24, 16), 3)])
def test_read_sharded_matches_put(tmp_path, rng, shape, channels):
    img = rng.integers(0, 256, size=shape + ((channels,) if channels > 1
                                             else ()), dtype=np.uint8)
    p = _write(tmp_path, img)
    runner = _runner(shape, channels, (2, 4))
    got = _stitch(distributed.read_sharded(p, shape[0], shape[1], channels,
                                           runner.mesh))
    np.testing.assert_array_equal(got, _stitch(runner.put(img)))
    jr = _jax_runner(shape, channels, (2, 4))
    np.testing.assert_array_equal(got, np.asarray(jdistributed.read_sharded(
        p, shape[0], shape[1], channels, jr.sharding)))


def test_read_sharded_pads_indivisible(tmp_path, rng):
    img = rng.integers(0, 256, size=(33, 41), dtype=np.uint8)
    p = _write(tmp_path, img)
    runner = _runner((33, 41), 1, (2, 4))
    got = _stitch(distributed.read_sharded(p, 33, 41, 1, runner.mesh))
    np.testing.assert_array_equal(got, _stitch(runner.put(img)))
    assert got.shape == (34, 44) and not got[33:].any()


def test_write_sharded_round_trip(tmp_path, rng):
    img = rng.integers(0, 256, size=(33, 41, 3), dtype=np.uint8)
    src, dst = _write(tmp_path, img), str(tmp_path / "out.raw")
    runner = _runner((33, 41), 3, (2, 4))
    tiles = distributed.read_sharded(src, 33, 41, 3, runner.mesh)
    distributed.write_sharded(dst, tiles, 33, 41, 3)
    np.testing.assert_array_equal(raw_io.read_raw(dst, 41, 33, 3), img)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_end_to_end_sharded_io_with_compute(tmp_path, rng, backend):
    img = rng.integers(0, 256, size=(33, 41), dtype=np.uint8)
    src, dst = _write(tmp_path, img), str(tmp_path / "out.raw")
    runner = _runner((33, 41), 1, (2, 4), backend)
    out = runner.run(distributed.read_sharded(src, 33, 41, 1, runner.mesh), 3)
    distributed.write_sharded(dst, out, 33, 41, 1)
    got = raw_io.read_raw(dst, 41, 33, 1)[..., 0]
    want = jstencil.reference_stencil_numpy(img, jfilters.get_filter(
        "gaussian"), 3)
    np.testing.assert_array_equal(got, want)


def test_broadcast_config_single_process_identity():
    cfg = tconfig.JobConfig("x.raw", 8, 8, 2, tconfig.ImageType.GREY)
    assert distributed.process_count() == 1
    assert distributed.broadcast_config(cfg) is cfg
    jcfg = JJobConfig("x.raw", 8, 8, 2, JImageType.GREY)
    assert jdistributed.broadcast_config(jcfg) is jcfg


def test_device_row_ranges():
    m = distributed.device_row_ranges(32, 40, (2, 4))
    jm = jdistributed.device_row_ranges(32, 40, (2, 4))
    assert {k: (rr.start, rr.stop, c0, nc) for k, (rr, c0, nc) in m.items()
            } == {k: (rr.start, rr.stop, c0, nc)
                  for k, (rr, c0, nc) in jm.items()}
    rr, col0, n_cols = m[(0, 0)]
    assert (rr.start, rr.stop) == (0, 16) and (col0, n_cols) == (0, 10)
    rr, col0, n_cols = m[(1, 3)]
    assert (rr.start, rr.stop) == (16, 32) and (col0, n_cols) == (30, 10)


def test_initialize_single_process_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()  # must not raise with one local process
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    distributed.initialize()
    assert distributed.process_count() == 1
    assert distributed.broadcast_strs(["a", ""]) == ["a", ""]
    assert distributed.allgather_bytes(b"xy") == [b"xy"]
    distributed.barrier()
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(num_processes=2, process_id=0)


def test_encode_decode_strs_with_empty_trailing():
    strs = ["a.raw", "gaussian", "xla", ""]
    enc = distributed._encode_strs(strs)
    assert distributed._decode_strs(enc) == strs
    # The same bytes as the JAX package's codec.
    np.testing.assert_array_equal(enc, jdistributed._encode_strs(strs))
    with pytest.raises(ValueError, match="too long"):
        distributed._encode_strs(["x" * 2000])
    with pytest.raises(ValueError, match="malformed"):
        distributed._decode_strs(np.zeros(8, np.uint8))


def test_write_sharded_truncates_stale_output(tmp_path, rng):
    dst = str(tmp_path / "out.raw")
    with open(dst, "wb") as f:
        f.write(b"\xff" * 10_000)  # stale larger file
    img = rng.integers(0, 256, size=(16, 16), dtype=np.uint8)
    src = _write(tmp_path, img)
    runner = _runner((16, 16), 1, (2, 4))
    distributed.write_sharded(
        dst, distributed.read_sharded(src, 16, 16, 1, runner.mesh), 16, 16, 1)
    assert os.path.getsize(dst) == 16 * 16
    np.testing.assert_array_equal(raw_io.read_raw(dst, 16, 16, 1)[..., 0], img)


def test_write_sharded_cols_only_mesh_round_trip(tmp_path, rng):
    # (1, 8): every tile a column tile of one row band.
    img = rng.integers(0, 256, size=(17, 43, 3), dtype=np.uint8)
    src, dst = _write(tmp_path, img), str(tmp_path / "out.raw")
    runner = _runner((17, 43), 3, (1, 8))
    tiles = distributed.read_sharded(src, 17, 43, 3, runner.mesh)
    distributed.write_sharded(dst, tiles, 17, 43, 3)
    np.testing.assert_array_equal(raw_io.read_raw(dst, 43, 17, 3), img)


def test_read_sharded_reads_each_row_range_once(tmp_path, rng, monkeypatch):
    img = rng.integers(0, 256, size=(32, 40, 3), dtype=np.uint8)
    p = _write(tmp_path, img)
    calls = []
    real = raw_io.read_raw_rows

    def counting(path, row_start, n_rows, width, channels):
        calls.append(row_start)
        return real(path, row_start, n_rows, width, channels)

    monkeypatch.setattr(distributed.raw_io, "read_raw_rows", counting)
    distributed.read_sharded(p, 32, 40, 3, _runner((32, 40), 3, (2, 4)).mesh)
    assert sorted(calls) == [0, 16]


def test_config_string_codec_carries_schedule_and_boundary():
    strs = ["img.raw", "gaussian", "auto", "", "pack", "periodic", "edge",
            "cpu", "2.5"]
    assert distributed._decode_strs(distributed._encode_strs(strs)) == strs
    assert jdistributed._decode_strs(distributed._encode_strs(strs)) == strs


# -- a process of several: its own tiles only -------------------------------


def _owned_mesh(grid, owners, rank) -> Mesh:
    r, c = grid
    return Mesh(tuple(tuple([CPU] * c) for _ in range(r)),
                tuple(tuple(row) for row in owners), rank)


@pytest.mark.parametrize("owners", [((0, 0), (1, 1)), ((0, 1), (0, 1)),
                                    ((0, 1), (1, 0))], ids=str)
def test_per_process_reads_and_writes_assemble_the_image(tmp_path, rng,
                                                         monkeypatch, owners):
    # Each "rank" reads only the bands of its tiles and writes only their
    # rectangles; together they write exactly the image, and a band is
    # read at most once per rank.
    img = rng.integers(0, 256, size=(21, 30, 3), dtype=np.uint8)
    src, dst = _write(tmp_path, img), str(tmp_path / "out.raw")
    real = raw_io.read_raw_rows
    for rank in (0, 1):
        calls = []
        monkeypatch.setattr(distributed.raw_io, "read_raw_rows",
                            lambda p, r0, n, w, c: calls.append(r0)
                            or real(p, r0, n, w, c))
        m = _owned_mesh((2, 2), owners, rank)
        tiles = distributed.read_sharded(src, 21, 30, 3, m)
        held = {(i, j) for i in range(2) for j in range(2)
                if tiles[i][j] is not None}
        assert held == {(i, j) for i in range(2) for j in range(2)
                        if owners[i][j] == rank}
        assert sorted(calls) == sorted({11 * i for i, _ in held})
        distributed.write_sharded(dst, tiles, 21, 30, 3)
    np.testing.assert_array_equal(raw_io.read_raw(dst, 30, 21, 3), img)


def test_write_sharded_merges_contiguous_column_tiles(tmp_path, rng,
                                                      monkeypatch):
    # A rank holding columns 0-1 and 3 of a (1, 4) band writes two blocks:
    # one for the contiguous run, one for the lone tile.
    img = rng.integers(0, 256, size=(5, 16), dtype=np.uint8)
    src, dst = _write(tmp_path, img), str(tmp_path / "out.raw")
    m = _owned_mesh((1, 4), ((0, 0, 1, 0),), 0)
    tiles = distributed.read_sharded(src, 5, 16, 1, m)
    blocks = []
    real = raw_io.write_raw_block
    monkeypatch.setattr(distributed.raw_io, "write_raw_block",
                        lambda p, r0, c0, b, *a: blocks.append(
                            (r0, c0, b.shape[1])) or real(p, r0, c0, b, *a))
    distributed.write_sharded(dst, tiles, 5, 16, 1)
    assert blocks == [(0, 0, 8), (0, 12, 4)]
    got = raw_io.read_raw(dst, 16, 5, 1)[..., 0]
    np.testing.assert_array_equal(got[:, :8], img[:, :8])
    np.testing.assert_array_equal(got[:, 12:], img[:, 12:])
    assert not got[:, 8:12].any()  # never touched: the other rank's bytes
