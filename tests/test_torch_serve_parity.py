"""The port's serving engine against the JAX package's serving engine and
its ``driver.run_job``, on the same requests.

The same seeded requests go through the JAX package's ``StencilServer``
(on the CPU: ``backend="xla"``, and ``pallas`` in interpret mode where
named) and through the port's, given the CPU, under ``xla`` (torch ops)
and ``pallas`` (K1's plain version, one single-rep call per rep, then the
pad mask): grey and RGB; gaussian, gaussian5, gaussian7, box and edge;
reps 0, 1, 2, 7, 8 and 9; mixed true shapes in one batch, a 1x1 image
and requests above the ladder's top edge; ``submit_group``; the sharded
route under ``off`` and ``edge`` on a CPU mesh; and the runner cache the
sharded stream shares with the server.

Tolerance: integer plans are byte-equal (max abs error 0). The
``direct_f32`` plan (``backend="reference"``) has integer taps below
2^24, exact in float32 whatever the order of the adds, and one correctly
rounded divide: it too must equal the NumPy golden byte for byte.
"""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil import filters as jfilters
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil.serve import engine as jengine
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import ImageType, ServeConfig
from tpu_stencil_torch.ops import lowering as tlowering
from tpu_stencil_torch.parallel import sharded as psharded
from tpu_stencil_torch.serve import engine as tengine

torch.set_num_threads(1)

CPU = torch.device("cpu")
EDGES = (8, 16, 32)
FILTERS = ["gaussian", "gaussian5", "gaussian7", "box", "edge"]
REPS = (0, 1, 2, 7, 8, 9)

# True shapes: three grey frames of one 8x8 bucket (1x1 among them: one
# batch of mixed shapes), two RGB frames of the 32x32 bucket, and one
# frame of each channel count above the ladder's top edge (-> 64).
SHAPES = ((1, 1), (5, 7), (8, 8), (20, 30, 3), (17, 25, 3), (40, 33),
          (33, 20, 3))


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    yield
    obs.reset()


def _images(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]


def _golden(img, reps, name):
    return jstencil.reference_stencil_numpy(img, jfilters.get_filter(name),
                                            reps)


def _run_parked(server, requests, filter_name=None):
    """Submit every request to a parked server, then start it (so the
    batches are formed alike in both packages); the results in order."""
    futs = [server.submit(img, reps, filter_name=filter_name)
            for img, reps in requests]
    server.start()
    try:
        return [f.result(timeout=300) for f in futs], server.stats()
    finally:
        server.close(timeout=60)


def _port(backend="xla", devices=None, **kw):
    return tengine.StencilServer(
        ServeConfig(backend=backend, **kw), start=False, device=CPU,
        devices=devices)


def _jax(backend="xla", **kw):
    return jengine.StencilServer(
        jconfig.ServeConfig(backend=backend, **kw), start=False)


@pytest.mark.parametrize("name", FILTERS)
def test_server_matches_the_jax_server(name):
    requests = [(img, reps) for reps in REPS
                for img in _images(SHAPES, seed=reps)]
    cfg = dict(max_queue=128, max_batch=4, bucket_edges=EDGES)
    want, jstats = _run_parked(_jax(filter_name=name, **cfg), requests)
    for backend in ("xla", "pallas"):
        got, stats = _run_parked(_port(backend, filter_name=name, **cfg),
                                 requests)
        for (img, reps), g, w in zip(requests, got, want):
            assert g.shape == img.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(
                g, w, err_msg=f"{backend} {img.shape} x{reps}")
        # The same batches, the same cache traffic, the same waste.
        for c in ("batches_total", "cache_misses_total",
                  "padded_pixels_total", "image_pixels_total",
                  "completed_total"):
            assert stats["counters"][c] == jstats["counters"][c], c
    # And the golden model on a sample (per-pixel loops: small only).
    for (img, reps), w in list(zip(requests, want))[::5]:
        np.testing.assert_array_equal(w, _golden(img, reps, name))


@pytest.mark.parametrize("name", ["gaussian", "box"])
def test_pallas_against_the_jax_pallas_server(name):
    # The JAX package's Pallas bucket program in interpret mode, as its
    # own tests run it, against the port's K1 plain version.
    requests = [(img, reps) for reps in (1, 2)
                for img in _images(((5, 7), (8, 8), (6, 4, 3)), seed=reps)]
    cfg = dict(max_queue=32, max_batch=4, bucket_edges=EDGES,
               filter_name=name)
    want, _ = _run_parked(_jax("pallas", **cfg), requests)
    got, _ = _run_parked(_port("pallas", **cfg), requests)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_direct_f32_plan_matches_the_golden():
    # backend="reference" forces every plan to direct_f32.
    requests = [(img, reps) for reps in (1, 3)
                for img in _images(((9, 7), (6, 5, 3)), seed=20 + reps)]
    cfg = dict(max_queue=32, max_batch=4, bucket_edges=EDGES,
               filter_name="box")
    model_plan = tengine.StencilServer(
        ServeConfig(backend="reference", **cfg), start=False,
        device=CPU)._model_for("box").plan
    assert model_plan.kind == "direct_f32"
    want, _ = _run_parked(_jax("reference", **cfg), requests)
    got, _ = _run_parked(_port("reference", **cfg), requests)
    for (img, reps), g, w in zip(requests, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _golden(img, reps, "box"))


@pytest.mark.parametrize("image_type,reps", [(ImageType.GREY, 7),
                                             (ImageType.RGB, 9)])
def test_server_matches_the_jax_run_job(tmp_path, image_type, reps):
    shapes = ((13, 11), (1, 1), (40, 36)) if image_type is ImageType.GREY \
        else ((13, 11, 3), (2, 3, 3), (40, 36, 3))
    imgs = _images(shapes, seed=30 + reps)
    got, _ = _run_parked(_port("pallas", max_queue=16, max_batch=4,
                               bucket_edges=EDGES),
                         [(img, reps) for img in imgs])
    for i, (img, g) in enumerate(zip(imgs, got)):
        src, dst = tmp_path / f"in{i}.raw", tmp_path / f"out{i}.raw"
        img.tofile(src)
        jdriver.run_job(jconfig.JobConfig(
            str(src), img.shape[1], img.shape[0], reps,
            jconfig.ImageType(image_type.value), backend="xla",
            output=str(dst)))
        np.testing.assert_array_equal(
            g, np.fromfile(dst, np.uint8).reshape(img.shape))


def _group_run(module, server):
    imgs = _images(((20, 30, 3), (18, 22, 3), (32, 32, 3)), seed=41)
    now = time.perf_counter()
    items = [module.GroupItem(image=i, future=concurrent.futures.Future(),
                              t_submit=now) for i in imgs]
    server.start()
    try:
        server.submit_group(items, 2)
        out = [it.future.result(timeout=300) for it in items]
        return out, server.stats()["counters"]["batches_total"]
    finally:
        server.close(timeout=60)


def test_submit_group_matches_the_jax_server():
    cfg = dict(max_queue=16, max_batch=4, bucket_edges=EDGES)
    want, jb = _group_run(jengine, _jax(**cfg))
    for backend in ("xla", "pallas"):
        got, b = _group_run(tengine, _port(backend, **cfg))
        assert b == jb == 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("overlap", ["off", "edge"])
def test_sharded_route_matches_the_jax_server(overlap):
    # The JAX server spans the conftest's 8 CPU devices; the port's the
    # CPU offered 4 times (a 2x2 mesh). Under "off" both take the bucket
    # route; under "edge" every request at or above the threshold runs
    # the sharded runner.
    psharded.clear_runner_cache()
    imgs = _images(((40, 36, 3), (33, 47), (36, 40, 3)), seed=51)
    requests = list(zip(imgs, (3, 2, 0)))
    cfg = dict(overlap=overlap, shard_min_pixels=900, max_batch=4)
    want, jstats = _run_parked(_jax(**cfg), requests)
    for backend in ("xla", "pallas"):
        got, stats = _run_parked(_port(backend, devices=[CPU] * 4, **cfg),
                                 requests)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (stats["counters"]["sharded_requests_total"]
                == jstats["counters"]["sharded_requests_total"]
                == (3 if overlap == "edge" else 0))


def test_stream_and_serve_share_one_runner_cache(tmp_path):
    # The serve half of tests/test_shardstream.py's cache test: a mesh
    # runner the sharded stream built is a hit for the server.
    from tpu_stencil_torch.config import StreamConfig
    from tpu_stencil_torch.stream import engine as stream_engine

    psharded.clear_runner_cache()
    h, w, reps, n = 18, 14, 2, 2
    clip = np.random.default_rng(3).integers(0, 256, (n, h, w), np.uint8)
    path = tmp_path / "clip.raw"
    clip.tofile(path)
    mesh = [CPU] * 4
    stream_engine.run_stream(StreamConfig(
        input=str(path), width=w, height=h, repetitions=reps,
        image_type=ImageType.GREY, output="null", frames=n,
        shard_frames=(2, 2), overlap="edge", shard_min_pixels=1),
        devices=mesh)
    assert psharded.runner_cache_len() == 1
    server = tengine.StencilServer(
        ServeConfig(overlap="edge", shard_min_pixels=1), device=CPU,
        devices=mesh)
    with server:
        got = server.submit(clip[0], reps).result(timeout=300)
        stats = server.stats()
    assert stats["counters"]["sharded_runner_hits_total"] == 1
    assert "sharded_runner_misses_total" not in stats["counters"]
    assert psharded.runner_cache_len() == 1
    np.testing.assert_array_equal(got, _golden(clip[0], reps, "gaussian"))


def test_bucket_program_is_one_step_per_rep_then_the_mask():
    # The bucket program's function, written out: per rep one
    # zero-boundary padded_step of each frame, then the pad re-zeroed.
    prog = tengine.BucketProgram(
        tlowering.plan_filter(tfilters.get_filter("box")), "pallas", 3, 2,
        (8, 16), 3)
    assert (prog.stride, prog.rows, prog.wc) == (9, 18, 48)
    imgs = _images(((5, 9, 3), (8, 16, 3)), seed=61)
    canvas = np.zeros((2, 9, 16, 3), np.uint8)
    valid = torch.tensor([[5, 8], [9, 16]], dtype=torch.int32)
    for i, img in enumerate(imgs):
        canvas[i, :img.shape[0], :img.shape[1]] = img
    x2 = torch.from_numpy(canvas.reshape(18, 48))
    mask = tengine.pad_mask(valid, 9, 16, 3)
    out = prog.run(x2, mask).numpy().reshape(2, 9, 16, 3)
    assert np.array_equal(x2.numpy(), canvas.reshape(18, 48))  # not written
    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        np.testing.assert_array_equal(out[i, :h, :w], _golden(img, 3, "box"))
        assert not out[i, h:].any() and not out[i, :, w:].any()
