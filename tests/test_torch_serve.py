"""The port's serving engine against the JAX package's, on the CPU.

Mirrors ``tests/test_serve.py`` test for test (bucket policy, metrics,
exactness, program cache, backpressure, loadgen, CLI, canvas arena,
``submit_group``), plus the serve cases of ``tests/test_integrity.py``
(witness, loadgen ``--verify golden``), ``tests/test_fanout.py`` (the
sharded route), ``tests/test_obs.py`` (the self-test trace, the
exposition round trip, the versioned ``--stats-json``, the metrics text),
``tests/test_tracectx.py`` (the witness-mismatch flight dump) and
``tests/test_resilience.py`` (the classifier names). Every server here is
given the CPU (``device="cpu"``), where the kernels' plain versions run;
the sharded route's mesh is the CPU offered several times. Inputs are
seeded numpy arrays; every plan here is an integer plan, so each output
must be byte-equal to the JAX package's golden model (and, where the JAX
package is run, to its output).
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_stencil import filters as jfilters
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil.serve import bucketing as jbucketing
from tpu_stencil.serve import loadgen as jloadgen
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import ServeConfig
from tpu_stencil_torch.integrity import witness
from tpu_stencil_torch.integrity.checksum import WitnessMismatch
from tpu_stencil_torch.obs import context as octx
from tpu_stencil_torch.obs import exposition
from tpu_stencil_torch.obs import flight as oflight
from tpu_stencil_torch.parallel import sharded as psharded
from tpu_stencil_torch.resilience import faults, retry
from tpu_stencil_torch.serve import bucketing, loadgen
from tpu_stencil_torch.serve.engine import (
    GroupItem,
    QueueFull,
    ServerClosed,
    StencilServer,
    _CanvasArena,
    _resolve,
    _Slot,
)
from tpu_stencil_torch.serve.metrics import Histogram, Registry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
EDGES = (8, 16, 32)


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    obs.reset()
    yield
    faults.reset()
    obs.reset()


def _golden(img, reps, name="gaussian"):
    return jstencil.reference_stencil_numpy(img, jfilters.get_filter(name),
                                            reps)


def _serve(start=True, devices=None, **kw):
    return StencilServer(ServeConfig(**kw), start=start, device=CPU,
                         devices=devices)


def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- bucket policy (pure), held to the JAX package's ------------------


def test_bucket_dim_ladder_and_edges():
    edges = (8, 16, 32)
    for n, want in ((1, 8), (8, 8), (9, 16), (32, 32)):
        assert bucketing.bucket_dim(n, edges) == want
        assert jbucketing.bucket_dim(n, edges) == want
    with pytest.raises(ValueError):
        bucketing.bucket_dim(0, edges)
    assert bucketing.DEFAULT_EDGES == jbucketing.DEFAULT_EDGES


def test_bucket_dim_above_top_edge_pads_to_multiple():
    edges = (8, 16, 32)
    for n, want in ((33, 64), (64, 64), (65, 96)):
        assert bucketing.bucket_dim(n, edges) == want
        assert jbucketing.bucket_dim(n, edges) == want
    for n in (1, 7, 2519, 2520, 3072, 3073, 7000):
        assert bucketing.bucket_dim(n) == jbucketing.bucket_dim(n)


def test_batch_bucket_pow2_capped():
    for n, cap, want in ((1, 8, 1), (3, 8, 4), (5, 8, 8), (7, 4, 4)):
        assert bucketing.batch_bucket(n, cap) == want
        assert jbucketing.batch_bucket(n, cap) == want
    with pytest.raises(ValueError):
        bucketing.batch_bucket(0, 8)


def test_waste_pixels_accounting():
    args = ([(10, 10), (10, 10)], (16, 16), 4)
    assert bucketing.waste_pixels(*args) == 824
    assert jbucketing.waste_pixels(*args) == 824


# -- metrics (pure) ---------------------------------------------------


def test_histogram_percentiles_and_bounds():
    h = Histogram(cap=64)
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100
    assert h.sum == pytest.approx(5050.0)
    snap = h.snapshot()
    assert snap["max"] == 100.0
    assert 30.0 <= snap["p50"] <= 70.0
    assert snap["p99"] >= snap["p50"]
    assert len(h._values) == 64


def test_histogram_empty_percentile_is_zero():
    h = Histogram(cap=8)
    assert h.percentile(50) == 0.0 and h.percentile(99) == 0.0
    snap = h.snapshot()
    buckets = snap.pop("buckets")
    assert buckets["+Inf"] == 0 and all(v == 0 for v in buckets.values())
    assert snap == {"count": 0, "sum": 0.0, "mean": 0.0, "p50": 0.0,
                    "p99": 0.0, "max": 0.0}


def test_histogram_single_sample_is_every_percentile():
    h = Histogram(cap=8)
    h.observe(3.25)
    for p in (0, 1, 50, 99, 100):
        assert h.percentile(p) == 3.25
    snap = h.snapshot()
    assert snap["count"] == 1 and snap["sum"] == 3.25
    assert snap["mean"] == 3.25 and snap["max"] == 3.25


def test_histogram_cap_reservoir_boundary():
    from tpu_stencil.serve.metrics import Histogram as JHistogram

    cap = 16
    h, j = Histogram(cap=cap), JHistogram(cap=cap)
    for v in range(cap):
        h.observe(float(v))
        j.observe(float(v))
    assert len(h._values) == cap
    assert h.percentile(0) == 0.0 and h.percentile(100) == float(cap - 1)
    h.observe(1000.0)
    j.observe(1000.0)
    assert h.count == cap + 1 and len(h._values) == cap
    assert h.snapshot()["max"] == 1000.0
    # The same seeded reservoir as the JAX package's.
    assert h.snapshot() == j.snapshot()


def test_histogram_snapshot_through_text_exposition():
    r = Registry()
    r.histogram("probe_seconds").observe(0.5)
    r.histogram("probe_seconds").observe(1.5)
    snap = r.snapshot()
    text = exposition.render_text(snap, prefix="t")
    assert 't_probe_seconds{quantile="0.5"}' in text
    assert exposition.parse_text(text, prefix="t") == snap


def test_registry_snapshot_schema():
    r = Registry()
    r.counter("a").inc(3)
    r.gauge("g").set(5)
    r.gauge("g").set(2)
    r.histogram("h").observe(1.5)
    snap = r.snapshot()
    assert snap["counters"]["a"] == 3
    assert snap["gauges"]["g"] == {"value": 2, "peak": 5}
    assert snap["histograms"]["h"]["count"] == 1


# -- engine exactness -------------------------------------------------


@pytest.fixture(scope="module")
def server():
    with StencilServer(ServeConfig(max_queue=64, max_batch=4,
                                   bucket_edges=EDGES), device=CPU) as s:
        yield s


def test_serve_matches_golden_rgb(server, rng):
    img = rng.integers(0, 256, (24, 18, 3), dtype=np.uint8)
    got = server.submit(img, 3).result(timeout=300)
    np.testing.assert_array_equal(got, _golden(img, 3))
    assert got.dtype == np.uint8 and got.shape == img.shape


def test_serve_one_pixel_image(server, rng):
    img = rng.integers(0, 256, (1, 1), dtype=np.uint8)
    np.testing.assert_array_equal(server.submit(img, 2).result(timeout=300),
                                  _golden(img, 2))


def test_serve_oversized_request(server, rng):
    img = rng.integers(0, 256, (40, 40), dtype=np.uint8)
    assert bucketing.bucket_shape(40, 40, EDGES) == (64, 64)
    np.testing.assert_array_equal(server.submit(img, 2).result(timeout=300),
                                  _golden(img, 2))


def test_serve_zero_reps_identity(server, rng):
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(server.submit(img, 0).result(timeout=300),
                                  img)


def test_mixed_grey_rgb_one_queue(server, rng):
    cases = []
    for i in range(8):
        ch = 1 if i % 2 == 0 else 3
        h, w = (11 + i, 17 - i)
        shape = (h, w) if ch == 1 else (h, w, ch)
        cases.append((rng.integers(0, 256, shape, dtype=np.uint8), 2))
    futs = [server.submit(img, reps) for img, reps in cases]
    for (img, reps), fut in zip(cases, futs):
        np.testing.assert_array_equal(fut.result(timeout=300),
                                      _golden(img, reps),
                                      err_msg=f"shape={img.shape}")


def test_serve_per_request_filter(server, rng):
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    got = server.submit(img, 2, filter_name="box").result(timeout=300)
    np.testing.assert_array_equal(got, _golden(img, 2, "box"))


def test_submit_validation(server):
    with pytest.raises(ValueError):
        server.submit(np.zeros((4, 4), np.float32), 1)
    with pytest.raises(ValueError):
        server.submit(np.zeros(4, np.uint8), 1)
    with pytest.raises(ValueError):
        server.submit(np.zeros((4, 4), np.uint8), -1)


# -- program cache ----------------------------------------------------


def test_executable_cache_hit_on_same_bucket(rng):
    with _serve(max_queue=16, max_batch=2, bucket_edges=(8, 16)) as s:
        a = rng.integers(0, 256, (10, 10), dtype=np.uint8)
        b = rng.integers(0, 256, (12, 9), dtype=np.uint8)
        s.submit(a, 2).result(timeout=300)
        s.submit(b, 2).result(timeout=300)
        snap = s.stats()
    assert snap["counters"]["cache_misses_total"] == 1
    assert snap["counters"]["cache_hits_total"] == 1
    assert snap["executables_cached"] == 1


def test_executable_cache_lru_bound(rng):
    with _serve(max_queue=16, max_batch=1, max_executables=2,
                bucket_edges=(8,)) as s:
        img = rng.integers(0, 256, (6, 6), dtype=np.uint8)
        for reps in (1, 2, 3, 4):
            s.submit(img, reps).result(timeout=300)
        snap = s.stats()
    assert snap["executables_cached"] <= 2
    assert snap["counters"]["cache_evictions_total"] == 2
    assert snap["counters"]["cache_misses_total"] == 4


def test_submit_copies_caller_buffer(rng):
    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    snapshot = img.copy()
    s = _serve(start=False, max_queue=4, bucket_edges=(8, 16))
    fut = s.submit(img, 2)
    img[:] = 0
    s.start()
    np.testing.assert_array_equal(fut.result(timeout=300),
                                  _golden(snapshot, 2))
    s.close()


def test_executable_cache_miss_on_different_reps(rng):
    with _serve(max_queue=16, max_batch=2, bucket_edges=(8, 16)) as s:
        img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
        s.submit(img, 1).result(timeout=300)
        s.submit(img, 2).result(timeout=300)
        snap = s.stats()
    assert snap["counters"]["cache_misses_total"] == 2
    assert snap["executables_cached"] == 2


# -- backpressure -----------------------------------------------------


def test_backpressure_rejects_when_full(rng):
    s = _serve(start=False, max_queue=3, max_batch=2, bucket_edges=(8,))
    img = rng.integers(0, 256, (6, 6), dtype=np.uint8)
    futs = [s.submit(img, 1) for _ in range(3)]
    for _ in range(5):
        with pytest.raises(QueueFull):
            s.submit(img, 1)
    snap = s.stats()
    assert snap["counters"]["rejected_total"] == 5
    assert snap["counters"]["requests_total"] == 3
    assert snap["gauges"]["queue_depth"]["peak"] == 3
    s.start()
    for f in futs:
        np.testing.assert_array_equal(f.result(timeout=300), _golden(img, 1))
    s.close()


def test_submit_after_close_raises(rng):
    s = _serve(max_queue=4)
    s.close()
    with pytest.raises(ServerClosed):
        s.submit(rng.integers(0, 256, (6, 6), np.uint8), 1)


def test_close_unstarted_server_fails_pending_futures(rng):
    s = _serve(start=False, max_queue=4)
    fut = s.submit(rng.integers(0, 256, (6, 6), np.uint8), 1)
    s.close()
    with pytest.raises(ServerClosed):
        fut.result(timeout=30)


def test_cancelled_future_does_not_poison_batch_mates(rng):
    s = _serve(start=False, max_queue=8, max_batch=4, bucket_edges=(8,))
    img_a = rng.integers(0, 256, (6, 6), dtype=np.uint8)
    img_b = rng.integers(0, 256, (7, 5), dtype=np.uint8)
    fa = s.submit(img_a, 2)
    fb = s.submit(img_b, 2)
    assert fa.cancel()
    s.start()
    np.testing.assert_array_equal(fb.result(timeout=300), _golden(img_b, 2))
    s.close()


def test_periodic_boundary_refused():
    with pytest.raises(NotImplementedError):
        _serve(start=False, boundary="periodic")


# -- loadgen ----------------------------------------------------------


def test_loadgen_closed_loop_reports_from_registry(rng):
    with _serve(max_queue=32, max_batch=4, bucket_edges=EDGES) as s:
        report = loadgen.run(
            s, mode="closed", requests=16, concurrency=3, reps=2,
            shapes=((12, 10), (10, 12)), channels=(3,), seed=1,
        )
    assert report["completed"] == 16
    assert report["throughput_rps"] > 0
    assert report["p99_s"] >= report["p50_s"] > 0
    assert report["rejected"] == 0
    c = report["stats"]["counters"]
    assert c["completed_total"] == 16
    assert c["cache_hits_total"] > 0
    assert c["batches_total"] <= 16
    assert report["stats"]["histograms"]["queue_wait_seconds"]["count"] == 16


def test_loadgen_fixed_frame_rate_reports_achieved_vs_requested(rng):
    with _serve(max_queue=32, max_batch=4, bucket_edges=EDGES) as s:
        report = loadgen.run(
            s, mode="closed", requests=8, reps=1, rate_fps=400.0,
            shapes=((10, 12),), channels=(3,), seed=4,
        )
    assert report["mode"] == "open"
    assert report["requested_fps"] == 400.0
    assert report["offered_fps"] > 0 and report["achieved_fps"] > 0
    assert report["completed"] == 8
    assert report["achieved_fps"] == pytest.approx(
        report["completed"] / report["wall_seconds"])
    with pytest.raises(ValueError, match="rate_fps"):
        loadgen.run(_serve(start=False), rate_fps=0.0)


def test_loadgen_open_loop_sheds_under_overload(rng):
    with _serve(max_queue=2, max_batch=2, bucket_edges=EDGES) as s:
        report = loadgen.run(
            s, mode="open", requests=30, rate=1e6, reps=40,
            shapes=((24, 24),), channels=(3,), seed=2,
        )
    assert report["rejected"] > 0
    assert report["completed"] + report["rejected"] == 30
    assert report["stats"]["gauges"]["queue_depth"]["peak"] <= 2


@pytest.mark.slow
def test_loadgen_soak(rng):
    with _serve(max_queue=64, max_batch=8) as s:
        report = loadgen.run(
            s, mode="open", requests=2000, rate=500.0, reps=3,
            shapes=((48, 36), (64, 48), (30, 50)), channels=(1, 3), seed=3,
        )
    assert report["completed"] + report["rejected"] == 2000
    assert report["stats"]["gauges"]["queue_depth"]["peak"] <= 64


@pytest.mark.parametrize("group", [1, 4])
def test_synth_requests_match_the_jax_loadgen(group):
    # The same seeded request stream as the JAX package's loadgen.
    a = loadgen.synth_requests(9, ((16, 12), (20, 18)), (1, 3), seed=3,
                               group=group)
    b = jloadgen.synth_requests(9, ((16, 12), (20, 18)), (1, 3), seed=3,
                                group=group)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_zipf_requests_match_the_jax_loadgen():
    a, ia = loadgen.zipf_requests(40, ((8, 8),), (3,), seed=5, s=1.1,
                                  keys=6)
    b, ib = jloadgen.zipf_requests(40, ((8, 8),), (3,), seed=5, s=1.1,
                                   keys=6)
    assert ia == ib
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- module-level stats + CLI ----------------------------------------


def test_module_stats_points_at_last_server(rng):
    import tpu_stencil_torch.serve as serve_mod

    with _serve(max_queue=4) as s:
        img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        s.submit(img, 1).result(timeout=300)
        assert serve_mod.stats()["counters"]["completed_total"] == 1


def test_resolve_tolerates_cancel_race():
    fut = concurrent.futures.Future()
    assert _resolve(fut, 42) and fut.result() == 42
    cancelled = concurrent.futures.Future()
    cancelled.cancel()
    assert not _resolve(cancelled, 42)
    assert not _resolve(cancelled, exc=RuntimeError("x"))


def test_cli_serve_rejects_zero_shape():
    from tpu_stencil_torch.serve import cli as serve_cli

    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--shapes", "0x30", "--platform", "cpu"])
    assert exc.value.code == 2


def test_cli_serve_self_test_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", "serve", "--self-test",
         "--platform", "cpu"],
        capture_output=True, text=True, timeout=580, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "serve self-test OK" in proc.stdout


def test_cli_serve_without_a_card_exits_2():
    # No --platform cpu and no CUDA device: rc 2, never the CPU.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpu_stencil_torch.serve import cli as serve_cli

    assert serve_cli.main(["--self-test"]) == 2


def test_serve_overlap_config_plumbed():
    with pytest.raises(ValueError, match="overlap"):
        ServeConfig(overlap="diagonal")
    srv = _serve(start=False, overlap="split")
    try:
        assert srv.stats()["gauges"]["overlap_mode"]["value"] == 1
    finally:
        srv.close(timeout=5)


@pytest.mark.parametrize("kw", [
    dict(backend="nope"), dict(max_queue=0), dict(max_batch=0),
    dict(pipeline_depth=0), dict(max_executables=0),
    dict(shard_min_pixels=0), dict(mem_sample_interval_s=-1),
    dict(request_timeout_s=-1), dict(witness_rate=1.5),
    dict(device_index=-1), dict(boundary="mirror"),
    dict(bucket_edges=(16, 8)), dict(bucket_edges=()),
])
def test_serve_config_refuses_as_the_jax_package_does(kw):
    from tpu_stencil.config import ServeConfig as JServeConfig

    with pytest.raises(ValueError) as mine:
        ServeConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JServeConfig(**kw)
    assert str(mine.value) == str(theirs.value)


def test_serve_config_defaults_equal_the_jax_package():
    import dataclasses

    from tpu_stencil.config import ServeConfig as JServeConfig

    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(
        JServeConfig())
    assert ServeConfig(bucket_edges=[8, 16]).bucket_edges == (8, 16)


# -- canvas arena + group submit + bursty loadgen -----------------------


def _mk_imgs(n, shape=(20, 30, 3), seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def test_steady_state_zero_host_canvas_allocations():
    cfg = ServeConfig(max_queue=64, max_batch=4, bucket_edges=EDGES)
    with StencilServer(cfg, device=CPU) as server:
        img = _mk_imgs(1)[0]
        for _ in range(cfg.pipeline_depth + 2):
            server.submit(img, 2).result(timeout=300)
        c0 = server.stats()["counters"]
        for _ in range(6):
            server.submit(img, 2).result(timeout=300)
        c1 = server.stats()["counters"]
    assert c1["arena_canvas_alloc_total"] == c0["arena_canvas_alloc_total"]
    assert c1["arena_canvas_reuse_total"] > c0["arena_canvas_reuse_total"]


def test_canvas_arena_reuse_is_bit_exact_across_dirty_buffers():
    with _serve(max_queue=64, max_batch=4, bucket_edges=EDGES) as server:
        for seed in range(5):
            imgs = _mk_imgs(3, seed=seed)  # 3 < max_batch: a pad slot
            futs = [server.submit(i, 3) for i in imgs]
            for img, fut in zip(imgs, futs):
                np.testing.assert_array_equal(fut.result(timeout=300),
                                              _golden(img, 3))


def test_canvas_arena_byte_cap_evicts_least_recent_keys():
    reg = Registry()
    shape = (1, 16, 16)
    size = _Slot.size(shape)
    arena = _CanvasArena(reg, ring=2, cuda=False, byte_cap=3 * size)
    a1 = arena.acquire("a", shape)
    a2 = arena.acquire("a", shape)
    arena.acquire("b", shape)
    assert arena.bytes == 3 * size
    assert reg.counter("arena_canvas_evictions_total").value == 0
    # A fourth slot would pass the cap: "a", the least recent key, goes.
    arena.acquire("b", shape)
    assert reg.counter("arena_canvas_evictions_total").value == 1
    assert arena.bytes == 2 * size <= arena.byte_cap
    # "a" comes back as fresh slots, not its evicted ones; its second
    # slot would pass the cap, so "b" goes.
    a3 = arena.acquire("a", shape)
    assert a3 is not a1 and a3 is not a2
    assert arena.bytes == 3 * size
    a4 = arena.acquire("a", shape)
    assert a4 is not a3
    assert reg.counter("arena_canvas_alloc_total").value == 6
    assert reg.counter("arena_canvas_evictions_total").value == 2
    assert arena.bytes == 2 * size


def test_canvas_arena_serves_a_key_larger_than_its_byte_cap():
    reg = Registry()
    small, large = (1, 8, 8), (2, 32, 32)
    arena = _CanvasArena(reg, ring=2, cuda=False,
                         byte_cap=_Slot.size(large))
    arena.acquire("small", small)
    s1 = arena.acquire("large", large)
    s2 = arena.acquire("large", large)
    # The ring of "large" alone passes the cap: the other key went, and
    # the key keeps cycling its own two slots.
    assert reg.counter("arena_canvas_evictions_total").value == 1
    assert arena.bytes == 2 * _Slot.size(large)
    assert arena.acquire("large", large) is s1
    assert arena.acquire("large", large) is s2
    assert reg.counter("arena_canvas_reuse_total").value == 2


def test_outputs_stay_exact_when_the_arena_evicts_by_bytes(monkeypatch):
    # A cap below two slots of the smallest key here: every new key of
    # the mixed stream evicts, every output still equals the golden.
    from tpu_stencil_torch.serve import engine

    monkeypatch.setattr(engine, "_host_ram_bytes",
                        lambda: _CanvasArena._RAM_SHARE * 4096)
    shapes = [(20, 30, 3), (6, 5), (30, 14, 3), (20, 30, 3), (3, 9)]
    with _serve(max_queue=64, max_batch=4, bucket_edges=EDGES) as server:
        assert server._arena.byte_cap == 4096
        for k, shape in enumerate(shapes * 2):
            img = _mk_imgs(1, shape, seed=k)[0]
            np.testing.assert_array_equal(
                server.submit(img, 3).result(timeout=300), _golden(img, 3))
        c = server.stats()["counters"]
    assert c["arena_canvas_evictions_total"] >= len(shapes)


def test_submit_owned_skips_copy_and_fires_on_consumed():
    consumed = []
    with _serve(max_queue=8, bucket_edges=EDGES) as server:
        img = _mk_imgs(1)[0]
        fut = server.submit(img, 1, owned=True,
                            on_consumed=lambda: consumed.append(True))
        out = fut.result(timeout=300)
        assert consumed == [True]
        np.testing.assert_array_equal(out, _golden(img, 1))
        consumed.clear()
        fut = server.submit(img, 1,
                            on_consumed=lambda: consumed.append(True))
        assert consumed == [True]
        fut.result(timeout=300)


def test_submit_group_one_stacked_batch_bit_exact():
    with _serve(max_queue=16, max_batch=4, bucket_edges=EDGES) as server:
        server.submit(_mk_imgs(1)[0], 2).result(timeout=300)
        b0 = server.stats()["counters"]["batches_total"]
        imgs = _mk_imgs(3, seed=7)
        now = time.perf_counter()
        items = [GroupItem(image=i, future=concurrent.futures.Future(),
                           t_submit=now) for i in imgs]
        server.submit_group(items, 2)
        for img, it in zip(imgs, items):
            np.testing.assert_array_equal(it.future.result(timeout=300),
                                          _golden(img, 2))
        assert server.stats()["counters"]["batches_total"] == b0 + 1


def test_submit_group_all_or_nothing_backpressure():
    server = _serve(start=False, max_queue=2, max_batch=4,
                    bucket_edges=EDGES)
    try:
        now = time.perf_counter()
        items = [GroupItem(image=i, future=concurrent.futures.Future(),
                           t_submit=now) for i in _mk_imgs(3)]
        with pytest.raises(QueueFull):
            server.submit_group(items, 1)
        assert server.stats()["gauges"]["queue_depth"]["value"] == 0
        assert all(not it.future.done() for it in items)
    finally:
        server.close(timeout=5)


def test_loadgen_burst_mode_report_and_validation():
    with _serve(max_queue=64, max_batch=8, bucket_edges=EDGES) as server:
        report = loadgen.run(
            server, mode="open", requests=12, rate=10_000.0, burst=4,
            reps=1, shapes=((16, 12), (20, 18)), channels=(1, 3),
            seed=5, timeout=300,
        )
        assert report["burst"] == 4 and report["completed"] == 12
        assert report["p99_s"] >= report["p50_s"] >= 0.0
        with pytest.raises(ValueError, match="burst"):
            loadgen.run(server, mode="open", requests=2, burst=0)
        with pytest.raises(ValueError, match="open-loop"):
            loadgen.run(server, mode="closed", requests=2, burst=2)


def test_loadgen_burst_ticks_share_shapes():
    imgs = loadgen.synth_requests(8, ((16, 12), (20, 18)), (1, 3),
                                  seed=0, group=4)
    assert all(i.shape == (16, 12) for i in imgs[:4])
    assert all(i.shape == (20, 18, 3) for i in imgs[4:])
    assert not np.array_equal(imgs[0], imgs[1])
    a = loadgen.synth_requests(6, ((16, 12), (20, 18)), (1, 3), seed=0)
    b = loadgen.synth_requests(6, ((16, 12), (20, 18)), (1, 3), seed=0,
                               group=1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_serve_cli_burst_flag():
    from tpu_stencil_torch.serve import cli as serve_cli

    assert serve_cli.build_parser().parse_args(["--burst", "4"]).burst == 4
    with pytest.raises(SystemExit):
        serve_cli.main(["--burst", "2", "--mode", "closed",
                        "--requests", "1", "--platform", "cpu"])


def test_serve_cli_flags_are_the_jax_package_flags():
    # Every flag of the JAX package's serve CLI, with the same defaults
    # (--platform takes cpu|gpu; --backend also takes the port's
    # aliases).
    from tpu_stencil.serve import cli as jserve_cli
    from tpu_stencil_torch.serve import cli as serve_cli

    mine = {a.dest: a for a in serve_cli.build_parser()._actions}
    theirs = {a.dest: a for a in jserve_cli.build_parser()._actions}
    assert set(mine) == set(theirs)
    for dest, a in theirs.items():
        assert mine[dest].default == a.default, dest
        assert mine[dest].option_strings == a.option_strings, dest


# -- the witness (tests/test_integrity.py) ----------------------------


def _img(shape=(12, 10, 3), seed=5):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_serve_witness_clean_verdict():
    verdicts = []
    with _serve(max_queue=16, max_batch=4, bucket_edges=EDGES,
                witness_rate=1.0) as s:
        s.on_witness = verdicts.append
        img = _img()
        assert np.array_equal(s.submit(img, 2).result(timeout=300),
                              _golden(img, 2))
        assert _wait_for(lambda: len(verdicts) == 1)
        stats = s.stats()
    assert verdicts == [True]
    assert stats["counters"]["integrity_witness_total"] == 1
    assert stats["counters"]["integrity_witness_mismatch_total"] == 0
    assert stats["counters"]["witness_device_seconds_total"] > 0


@pytest.mark.chaos
def test_serve_corrupt_result_caught_by_witness():
    faults.configure("integrity.corrupt_result")
    verdicts = []
    with _serve(max_queue=16, max_batch=4, bucket_edges=EDGES,
                witness_rate=1.0) as s:
        s.on_witness = verdicts.append
        img = _img()
        out = s.submit(img, 2).result(timeout=300)
        assert not np.array_equal(out, _golden(img, 2))
        assert _wait_for(lambda: len(verdicts) == 1)
        stats = s.stats()
    assert verdicts == [False]
    assert stats["counters"]["integrity_witness_mismatch_total"] == 1


def test_serve_witness_sampling_deterministic():
    from tpu_stencil.integrity import witness as jwitness

    def picked(mod, n):
        s = mod.WitnessSampler(0.5, seed=0)
        return [i for i in range(n) if s.pick()]

    assert picked(witness, 64) == picked(jwitness, 64)
    with _serve(witness_rate=0.5, witness_seed=0, max_batch=1,
                bucket_edges=EDGES) as s:
        img = _img(shape=(8, 8))
        for _ in range(16):
            s.submit(img, 1).result(timeout=300)
        want = len(picked(witness, 16))
        assert _wait_for(
            lambda: s.stats()["counters"]["integrity_witness_total"] == want
        ), (s.stats()["counters"], want)


def test_serve_witness_skips_huge_rep_counts():
    with _serve(witness_rate=1.0, bucket_edges=EDGES) as s:
        s.submit(_img(shape=(8, 8)),
                 witness.WITNESS_MAX_REPS + 1).result(timeout=300)
        time.sleep(0.2)
        assert s.stats()["counters"]["integrity_witness_total"] == 0


def test_loadgen_verify_golden_in_process():
    with _serve(max_queue=64) as s:
        report = loadgen.run(s, requests=6, concurrency=2, reps=2,
                             verify="golden")
    assert report["verify"] == "golden"
    assert report["verify_failures_total"] == 0
    assert report["completed"] == 6


@pytest.mark.chaos
def test_loadgen_verify_golden_catches_corrupt_results():
    faults.configure("integrity.corrupt_result:times=0:p=1.0")
    with _serve(max_queue=64) as s:
        with pytest.raises(WitnessMismatch):
            loadgen.run(s, requests=6, concurrency=2, reps=2,
                        verify="golden")
    snap = obs.registry().snapshot()
    assert snap["counters"]["integrity_verify_failures_total"] >= 1


# -- the sharded route (tests/test_fanout.py) --------------------------


def _serve_case(h, w, ch, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w) if ch == 1 else (h, w, ch)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


MESH8 = [CPU] * 8


@pytest.mark.parametrize("overlap", ["split", "edge"])
def test_serve_sharded_route_matches_bucket_path(overlap):
    cases = [(_serve_case(40, 36, 3, 1), 3), (_serve_case(33, 47, 1, 2), 2),
             (_serve_case(36, 40, 3, 3), 0)]
    with _serve(devices=MESH8, overlap=overlap, shard_min_pixels=900,
                max_batch=4) as server:
        futs = [server.submit(img, reps) for img, reps in cases]
        got_sharded = [fu.result(timeout=300) for fu in futs]
        stats = server.stats()
    assert stats["counters"]["sharded_requests_total"] == len(cases)
    assert stats["sharded_runners_cached"] >= 1
    with _serve(overlap="off") as server:
        got_bucket = [server.submit(img, reps).result(timeout=300)
                      for img, reps in cases]
    for (img, reps), a, b in zip(cases, got_sharded, got_bucket):
        assert np.array_equal(a, _golden(img, reps)), (img.shape, reps)
        assert np.array_equal(a, b), (img.shape, reps, "vs bucket")
        assert a.shape == img.shape and a.dtype == np.uint8


def test_serve_small_requests_stay_on_bucket_path():
    small = _serve_case(10, 12, 3, 4)
    with _serve(devices=MESH8, overlap="split",
                shard_min_pixels=10_000) as server:
        got = server.submit(small, 2).result(timeout=300)
        stats = server.stats()
    assert stats["counters"]["sharded_requests_total"] == 0
    assert stats["counters"]["batches_total"] == 1
    assert stats["counters"]["device_requests_total_dev0"] == 1
    assert "device_requests_total_dev1" not in stats["counters"]
    assert np.array_equal(got, _golden(small, 2))


def test_serve_sharded_and_small_never_share_a_batch():
    big = _serve_case(40, 40, 1, 5)
    small = _serve_case(40, 40, 1, 6)
    with _serve(start=False, devices=MESH8, overlap="split",
                shard_min_pixels=1600, max_batch=8) as server:
        f1 = server.submit(big, 2)
        f2 = server.submit(small[:10, :10], 2)
        server.start()
        a, b = f1.result(timeout=300), f2.result(timeout=300)
        stats = server.stats()
    assert stats["counters"]["sharded_requests_total"] == 1
    assert stats["counters"]["batches_total"] == 2
    assert np.array_equal(a, _golden(big, 2))
    assert np.array_equal(b, _golden(small[:10, :10], 2))


def test_serve_sharded_runner_cache_reuse_and_device_accounting():
    psharded.clear_runner_cache()
    img = _serve_case(40, 36, 3, 7)
    with _serve(devices=MESH8, overlap="split", shard_min_pixels=1,
                max_batch=1) as server:
        a = server.submit(img, 2).result(timeout=300)
        b = server.submit(img, 5).result(timeout=300)
        stats = server.stats()
    c = stats["counters"]
    assert c["sharded_runner_misses_total"] == 1
    assert c["sharded_runner_hits_total"] == 1
    assert stats["sharded_runners_cached"] == 1
    for i in range(len(MESH8)):
        assert c[f"device_requests_total_dev{i}"] == 2
        assert c[f"device_bytes_dispatched_total_dev{i}"] > 0
    assert np.array_equal(a, _golden(img, 2))
    assert np.array_equal(b, _golden(img, 5))


def test_serve_unservable_geometry_falls_back_to_bucket_path():
    psharded.clear_runner_cache()
    img = _serve_case(2, 300, 1, 8)
    with _serve(devices=MESH8, filter_name="gaussian7", overlap="split",
                shard_min_pixels=500) as server:
        a = server.submit(img, 2).result(timeout=300)
        b = server.submit(img, 2).result(timeout=300)
        stats = server.stats()
    c = stats["counters"]
    assert c["sharded_fallbacks_total"] == 1
    assert c["sharded_runner_misses_total"] == 1
    assert c["sharded_runner_hits_total"] == 1
    want = _golden(img, 2, "gaussian7")
    assert np.array_equal(a, want) and np.array_equal(b, want)


@pytest.mark.chaos
def test_serve_compile_fault_covers_the_mesh_build():
    # The compile fault site fires inside the runner build (through
    # shared_runner's build_wrapper): the request fails typed, the
    # failure is not cached as unservable, and the server lives on.
    from tpu_stencil_torch.resilience.errors import InjectedFault

    psharded.clear_runner_cache()
    faults.configure("compile:times=1")
    img = _serve_case(20, 20, 1, 9)
    with _serve(devices=[CPU] * 4, overlap="edge", shard_min_pixels=1,
                max_batch=1) as server:
        with pytest.raises(InjectedFault):
            server.submit(img, 2).result(timeout=300)
        assert np.array_equal(server.submit(img, 2).result(timeout=300),
                              _golden(img, 2))
        c = server.stats()["counters"]
    assert c["sharded_runner_misses_total"] == 2
    assert "sharded_fallbacks_total" not in c


# -- obs (tests/test_obs.py) -------------------------------------------


def _x_events(path):
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def test_serve_self_test_trace(tmp_path):
    from tpu_stencil_torch.serve import cli as serve_cli

    trace = str(tmp_path / "serve.json")
    assert serve_cli.main(["--self-test", "--platform", "cpu",
                           "--trace", trace]) == 0
    evs = _x_events(trace)
    names = [e["name"] for e in evs]
    assert {"serve.enqueue", "serve.batch_form", "serve.execute",
            "serve.drain", "serve.cache_miss",
            "serve.cache_hit"} <= set(names)
    tid_of = {e["name"]: e["tid"] for e in evs}
    assert tid_of["serve.enqueue"] != tid_of["serve.execute"]
    assert not obs.enabled()


def test_exposition_roundtrips_serve_stats():
    rng = np.random.default_rng(5)
    with _serve(max_queue=16, max_batch=4, bucket_edges=EDGES) as server:
        for shape in ((10, 8, 3), (17, 23), (10, 8, 3)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            server.submit(img, 2).result(timeout=300)
        stats = server.stats()
    text = exposition.render_text(stats, prefix="tpu_stencil_serve")
    assert exposition.parse_text(text, prefix="tpu_stencil_serve") == stats
    for section in ("counters", "gauges", "histograms"):
        for name in stats[section]:
            assert f"tpu_stencil_serve_{name}" in text
    assert "tpu_stencil_serve_executables_cached" in text


def test_serve_stats_json_versioned(capsys):
    from tpu_stencil_torch.serve import cli as serve_cli

    rc = serve_cli.main(["--requests", "4", "--reps", "1",
                         "--concurrency", "2", "--shapes", "10x8",
                         "--platform", "cpu", "--stats-json", "-"])
    assert rc == 0
    out = capsys.readouterr().out
    payload = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert payload["schema_version"] == 1
    assert isinstance(payload["ts"], float)
    assert payload["stats"]["counters"]["completed_total"] == 4


def test_serve_self_test_metrics_text(tmp_path):
    from tpu_stencil_torch.serve import cli as serve_cli

    mpath = str(tmp_path / "m.txt")
    assert serve_cli.main(["--self-test", "--platform", "cpu",
                           "--metrics-text", mpath]) == 0
    snap = exposition.parse_text(open(mpath).read(),
                                 prefix="tpu_stencil_serve")
    assert snap["counters"]["completed_total"] >= 5


def test_serve_per_entry_introspection():
    rng = np.random.default_rng(11)
    obs.introspect.enable()
    with _serve(backend="pallas", max_queue=16, max_batch=4,
                bucket_edges=EDGES) as server:
        for shape in ((10, 8, 3), (17, 23), (10, 8, 3)):
            server.submit(rng.integers(0, 256, shape, dtype=np.uint8),
                          2).result(timeout=300)
        stats = server.stats()
        recs = server.introspection()
    # Two keys, two captures; each names the one K1 instance a rep
    # launches (registers and occupancy are read on a card only).
    assert stats["introspected_executables"] == 2
    assert len(recs) == 2
    assert {r["meta"]["channels"] for r in recs} == {1, 3}
    for r in recs:
        (k,) = r["kernels"]
        assert k["kernel"] == "stencil_fused" and k["fuse"] == 1
        assert r["model_bytes_per_rep"] > 0 and not r["available"]
    assert "introspect_serve_bucket_model_bytes_per_rep" in stats["gauges"]
    text = exposition.render_text(stats, prefix="tpu_stencil_serve")
    assert exposition.parse_text(text, prefix="tpu_stencil_serve") == stats


def test_serve_untraced_pays_no_introspection():
    rng = np.random.default_rng(12)
    with _serve(max_queue=8, max_batch=2, bucket_edges=(8, 16)) as server:
        server.submit(rng.integers(0, 256, (8, 8), dtype=np.uint8),
                      1).result(timeout=300)
        stats = server.stats()
    assert stats["introspected_executables"] == 0
    assert obs.introspect.records() == []


def test_memory_sampler_never_starts_on_the_cpu():
    from tpu_stencil_torch.serve.engine import _MemorySampler

    s = _MemorySampler(Registry(), 0.01, CPU)
    assert s.start() is False
    s.stop()


# -- the flight dump (tests/test_tracectx.py) --------------------------


def test_witness_mismatch_triggers_flight_dump(tmp_path, monkeypatch, rng):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path))
    oflight.install()
    faults.configure("integrity.corrupt_result:req=0")
    ctx = octx.fresh()
    img = rng.integers(0, 256, (12, 10), dtype=np.uint8)
    with _serve(max_queue=16, max_batch=4, bucket_edges=EDGES,
                witness_rate=1.0) as server:
        with octx.bind(ctx):
            fut = server.submit(img, 2)
        fut.result(timeout=300)
        dumps = []
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and not dumps:
            dumps = [n for n in os.listdir(tmp_path)
                     if "witness_mismatch" in n]
            time.sleep(0.02)
        assert dumps, "no witness_mismatch dump appeared"
        doc = json.loads(open(tmp_path / dumps[0]).read())
        assert doc["trigger"] == "witness_mismatch"
        assert doc["trace_id"] == ctx.trace_id
        assert any(sp["name"] == "serve.request" for sp in doc["spans"])
        assert server.stats()["counters"][
            "integrity_witness_mismatch_total"] == 1


def test_recording_never_changes_results(rng):
    oflight.install()
    with _serve(max_queue=16, max_batch=4, bucket_edges=EDGES) as server:
        for shape, reps in (((12, 10), 3), ((9, 17, 3), 2), ((1, 1), 1)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            np.testing.assert_array_equal(
                server.submit(img, reps).result(timeout=300),
                _golden(img, reps))


# -- resilience: the classifier names, the worker death, the warm plane -


def test_classify_queue_full_by_name():
    from tpu_stencil.resilience import retry as jretry

    e = QueueFull("full")
    assert retry.classify(e) == jretry.classify(e) == "transient"


@pytest.mark.parametrize("name", ["ServerClosed", "Draining"])
def test_classify_server_closed_by_name(name):
    from tpu_stencil.resilience import retry as jretry

    e = type(name, (RuntimeError,), {})("server is closed")
    assert retry.classify(e) == jretry.classify(e) == "permanent"
    assert retry.classify(ServerClosed("x")) == "permanent"


def test_reoffer_honours_retry_after_and_gives_up_typed():
    calls = []

    def full():
        calls.append(time.perf_counter())
        e = QueueFull("busy")
        e.retry_after_s = 0.05
        raise e

    with pytest.raises(TimeoutError, match="gave up re-offering"):
        retry.reoffer_call(full, give_up_after_s=0.12)
    assert len(calls) >= 2 and calls[1] - calls[0] >= 0.045
    snap = obs.registry().snapshot()["counters"]
    assert snap["resilience_retry_after_honored_total"] >= 1
    # A hint past the remaining budget gives up at once.
    calls.clear()

    def far():
        calls.append(1)
        e = QueueFull("busy")
        e.retry_after_s = 60.0
        raise e

    with pytest.raises(TimeoutError, match="asked for 60s"):
        retry.reoffer_call(far, give_up_after_s=1.0)
    assert len(calls) == 1


def test_submit_retrying_reoffers_until_the_queue_drains(rng):
    s = _serve(start=False, max_queue=1, bucket_edges=EDGES)
    img = rng.integers(0, 256, (6, 6), np.uint8)
    first = s.submit(img, 1)
    starter = threading.Timer(0.1, s.start)
    starter.start()
    second = s.submit_retrying(img, 1, give_up_after_s=30)
    np.testing.assert_array_equal(second.result(timeout=60), _golden(img, 1))
    np.testing.assert_array_equal(first.result(timeout=60), _golden(img, 1))
    s.close()
    with pytest.raises(ServerClosed):
        s.submit_retrying(img, 1)


def test_worker_death_fails_every_future_typed(rng):
    from tpu_stencil_torch.resilience.errors import (
        FatalInjectedFault, WorkerCrashed)

    faults.configure("compute:raise=fatal")
    s = _serve(start=False, max_queue=8, max_batch=1, bucket_edges=EDGES)
    img = rng.integers(0, 256, (6, 6), np.uint8)
    futs = [s.submit(img, 1) for _ in range(3)]
    s.start()
    for f in futs:
        with pytest.raises(WorkerCrashed) as e:
            f.result(timeout=60)
        assert isinstance(e.value.__cause__, FatalInjectedFault)
    with pytest.raises(WorkerCrashed):
        s.submit(img, 1)
    assert s.stats()["counters"]["resilience_worker_crashes_total"] == 1
    s.close()


def test_deadline_expired_requests_fail_typed(rng):
    from tpu_stencil_torch.resilience.errors import DeadlineExceeded

    s = _serve(start=False, max_queue=8, bucket_edges=EDGES)
    img = rng.integers(0, 256, (6, 6), np.uint8)
    late = s.submit(img, 1, deadline_s=0.01)
    ok = s.submit(img, 2)
    time.sleep(0.05)
    s.start()
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=60)
    np.testing.assert_array_equal(ok.result(timeout=60), _golden(img, 2))
    assert s.stats()["counters"]["deadline_expired_total"] == 1
    s.close()


def test_warm_plane_cache_access_and_cold_import(rng):
    with _serve(max_queue=8, bucket_edges=EDGES) as s:
        s.submit(rng.integers(0, 256, (6, 6), np.uint8), 1).result(
            timeout=60)
        (key,) = s.warm_keys()
        entry = s.warm_entry(key)
        assert entry is not None and entry.reps == 1
        before = s.stats()["counters"]
        assert not s.warm_seed(key, entry)            # a local key stays
        assert s.warm_seed(key[:-1] + (2,), entry)     # a new key seeds
        after = s.stats()["counters"]
        assert after["cache_hits_total"] == before["cache_hits_total"]
        assert after["cache_misses_total"] == before["cache_misses_total"]
        # An envelope naming no torch version degrades every entry to
        # cold, typed and counted.
        got = s.import_warm_state({"schema_version": 1,
                                   "entries": [{}, {}, {}]})
        assert got["imported"] == 0 and got["fallbacks"] == 3
        assert got["reasons"] == {"version_skew": 3}
        assert s.import_warm_state(None)["reasons"] == {
            "payload_unavailable": 1}
        assert s.stats()["counters"]["ctrl_warmstart_fallbacks_total"] == 4
        # The export names the cache's keys, the seeded one too.
        from tpu_stencil_torch.ctrl import warmstart

        env = s.export_warm_state()
        assert sorted(warmstart._key_from_wire(e["key"])
                      for e in env["entries"]) == sorted(s.warm_keys())
        assert len(env["entries"]) == 2
