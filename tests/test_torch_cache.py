"""The port's result cache against the JAX package's, on the CPU.

Mirrors ``tests/test_cache.py`` (the federation cases wait for the port's
``fed``): the fused BLAKE2b-160 + CRC32C scan (equal to the JAX package's
``digest_and_crc`` on the same bytes), the request key, the byte-budgeted
LRU store with its distrust fence, single-flight collapse, rendezvous
affinity (equal to the JAX package's order), the config and CLI checks,
the zipf keyspace, and the HTTP tier: a hit is byte-identical to a cold
compute and to the golden model, the CRC claim is validated alike on hit
and miss, N identical concurrent requests cost one dispatch, an expired
follower 504s without cancelling the leader, a witness mismatch or a
quarantine drops the replica's entries. Every frontend runs on
``devices=[cpu] * n`` and is closed in a finalizer.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_stencil import filters as jfilters
from tpu_stencil.cache import affinity as jaffinity
from tpu_stencil.cache import digest as jdigest
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil.serve import loadgen as jloadgen
from tpu_stencil_torch import obs
from tpu_stencil_torch.cache import ResultCache, affinity
from tpu_stencil_torch.cache import digest as cdigest
from tpu_stencil_torch.cache.singleflight import SingleFlight
from tpu_stencil_torch.cache.store import ResultStore
from tpu_stencil_torch.config import NetConfig, ServeConfig
from tpu_stencil_torch.integrity import checksum
from tpu_stencil_torch.resilience import faults
from tpu_stencil_torch.serve.metrics import Registry

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

CPU = torch.device("cpu")
H, W, C, REPS = 32, 24, 3, 3
EDGES = (8, 16, 32, 64)


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_STENCIL_TORCH_FLIGHTREC_DIR",
                       str(tmp_path / "flightrec"))
    faults.clear()
    obs.reset()
    yield
    faults.clear()
    obs.reset()


def _golden(img, reps, filter_name="gaussian"):
    return jstencil.reference_stencil_numpy(
        img, jfilters.get_filter(filter_name), reps
    )


def _wait_for(pred, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# -- digest + key -------------------------------------------------------

def test_digest_and_crc_one_scan_equals_separate_passes():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (3 << 20) + 17, dtype=np.uint8).tobytes()
    d, crc = cdigest.digest_and_crc(data)
    assert d == hashlib.blake2b(data, digest_size=20).digest()
    assert d == cdigest.content_digest(data)
    assert crc == checksum.crc32c(data)
    assert len(d) == cdigest.DIGEST_SIZE == 20
    arr = np.frombuffer(data, np.uint8)
    assert cdigest.digest_and_crc(arr) == (d, crc)
    # The JAX package's fused scan on the same bytes: the same pair.
    assert jdigest.digest_and_crc(data) == (d, crc)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, (1 << 20) - 1, 1 << 20,
                               (1 << 20) + 4097])
def test_digest_and_crc_equals_the_jax_package_at_chunk_edges(n):
    # Chunk and native-CRC boundaries (4 KiB, 1 MiB): the incremental
    # CRC through the port's crc32c(chunk, value) agrees with the JAX one.
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    assert cdigest.digest_and_crc(data) == jdigest.digest_and_crc(data)
    assert cdigest.content_digest(data) == jdigest.content_digest(data)


def test_request_key_total_over_every_knob():
    d = cdigest.content_digest(b"frame")
    base = cdigest.request_key(d, "gaussian", 3, 4, 5, 3, 0)
    variants = {
        cdigest.request_key(cdigest.content_digest(b"other"),
                            "gaussian", 3, 4, 5, 3, 0),
        cdigest.request_key(d, "box", 3, 4, 5, 3, 0),
        cdigest.request_key(d, "gaussian", 4, 4, 5, 3, 0),
        cdigest.request_key(d, "gaussian", 3, 5, 5, 3, 0),
        cdigest.request_key(d, "gaussian", 3, 4, 6, 3, 0),
        cdigest.request_key(d, "gaussian", 3, 4, 5, 1, 0),
        cdigest.request_key(d, "gaussian", 3, 4, 5, 3, 1),
    }
    assert base not in variants and len(variants) == 7
    assert base == cdigest.request_key(d, "gaussian", 3, 4, 5, 3, 0)
    assert base == jdigest.request_key(d, "gaussian", 3, 4, 5, 3, 0)


# -- store --------------------------------------------------------------

def _k(i):
    return ("key", i)


def test_store_lru_eviction_under_byte_budget():
    r = Registry()
    st = ResultStore(r, capacity_bytes=100)
    assert st.put(_k(1), b"a" * 40, None, 0, st.token())
    assert st.put(_k(2), b"b" * 40, None, 0, st.token())
    assert st.get(_k(1)).payload == b"a" * 40  # refresh: k2 is now LRU
    assert st.put(_k(3), b"c" * 40, None, 0, st.token())
    assert st.get(_k(2)) is None
    assert st.get(_k(1)) is not None and st.get(_k(3)) is not None
    c = r.snapshot()["counters"]
    assert c["result_cache_evictions_total"] == 1
    assert c["result_cache_insertions_total"] == 3
    assert not st.put(_k(9), b"z" * 101, None, 0, st.token())
    assert (r.snapshot()["counters"]["result_cache_admission_refused_total"]
            == 1)
    stats = st.stats()
    assert stats["entries"] == 2 and stats["bytes"] == 80
    assert stats["capacity_bytes"] == 100
    g = r.snapshot()["gauges"]
    assert g["result_cache_bytes"]["value"] == 80.0
    assert g["result_cache_entries"]["value"] == 2.0


def test_store_epoch_fence_refuses_post_distrust_insert():
    r = Registry()
    st = ResultStore(r, 1000)
    tok = st.token()
    st.invalidate_replica(0, "witness_mismatch")
    assert not st.put(_k(1), b"poison", None, 0, tok)
    assert st.put(_k(2), b"fine", None, 1, tok)  # sibling unaffected
    assert st.put(_k(1), b"clean", None, 0, st.token())
    assert (r.snapshot()["counters"]["result_cache_admission_refused_total"]
            == 1)


def test_store_refuses_quarantined_producer():
    bad = {0}
    r = Registry()
    st = ResultStore(r, 1000, quarantined=lambda i: i in bad)
    assert not st.put(_k(1), b"x", None, 0, st.token())
    assert st.put(_k(2), b"x", None, 1, st.token())
    bad.clear()
    assert st.put(_k(1), b"x", None, 0, st.token())
    assert (r.snapshot()["counters"]["result_cache_admission_refused_total"]
            == 1)


def test_invalidate_replica_drops_only_its_entries_by_cause():
    r = Registry()
    st = ResultStore(r, 10_000)
    st.put(_k(1), b"x" * 10, None, 0, st.token())
    st.put(_k(2), b"y" * 10, None, 0, st.token())
    st.put(_k(3), b"z" * 10, None, 1, st.token())
    assert st.invalidate_replica(0, "witness_mismatch") == 2
    assert st.get(_k(1)) is None and st.get(_k(2)) is None
    assert st.get(_k(3)).payload == b"z" * 10
    c = r.snapshot()["counters"]
    assert c["cache_invalidations_total"] == 2
    assert c["cache_invalidations_witness_mismatch_total"] == 2
    assert c["cache_invalidations_quarantine_total"] == 0  # pre-created
    assert st.clear() == 1
    c = r.snapshot()["counters"]
    assert c["cache_invalidations_clear_total"] == 1
    assert c["cache_invalidations_total"] == 3
    assert st.stats()["entries"] == 0


def test_result_cache_complete_resolves_followers_even_when_refused():
    r = Registry()
    cache = ResultCache(r, 1000, quarantined=lambda i: i == 0)
    key = cache.key(cdigest.content_digest(b"f"), "gaussian", 1, 2, 2, 1, 0)
    lead, _ = cache.join(key)
    _, fol = cache.join(key)
    assert lead
    # Replica 0 is distrusted: the store refuses, the follower still
    # gets the leader's bytes.
    assert cache.complete(key, b"abcd", "7", 0, cache.token()) is False
    assert fol.result(timeout=0) == (b"abcd", "7", 0)
    assert cache.lookup(key) is None
    assert cache.stats()["entries"] == 0


def test_singleflight_collapse_resolve_and_fail():
    r = Registry()
    sf = SingleFlight(r)
    lead, fut = sf.join(("k",))
    assert lead and fut is None
    f1 = sf.join(("k",))
    f2 = sf.join(("k",))
    assert not f1[0] and not f2[0]
    assert sf.inflight() == 1
    sf.resolve(("k",), 42)
    assert f1[1].result(timeout=0) == 42
    assert f2[1].result(timeout=0) == 42
    assert sf.inflight() == 0
    sf.resolve(("k",), 1)
    sf.fail(("k",), RuntimeError("late"))
    assert sf.join(("e",))[0]
    _, fol = sf.join(("e",))
    sf.fail(("e",), ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        fol.result(timeout=0)
    c = r.snapshot()["counters"]
    assert c["singleflight_leaders_total"] == 2
    assert c["singleflight_collapsed_total"] == 3


# -- rendezvous affinity ------------------------------------------------

def test_rendezvous_order_deterministic_total_and_minimal_churn():
    hosts = [f"host_{i}" for i in range(6)]
    d = cdigest.content_digest(b"frame-1")
    order = affinity.rendezvous_order(hosts, d)
    assert sorted(order) == sorted(hosts)
    assert order == affinity.rendezvous_order(hosts, d)
    assert order == affinity.rendezvous_order(list(reversed(hosts)), d)
    tops = {
        affinity.rendezvous_order(
            hosts, cdigest.content_digest(b"frame-%d" % i)
        )[0]
        for i in range(64)
    }
    assert len(tops) > 1
    gone = order[2]
    rest = affinity.rendezvous_order([h for h in hosts if h != gone], d)
    assert rest == [h for h in order if h != gone]
    # The JAX package ranks the same members in the same order.
    for i in range(16):
        dig = cdigest.content_digest(b"frame-%d" % i)
        assert (affinity.rendezvous_order(hosts, dig)
                == jaffinity.rendezvous_order(hosts, dig))


# -- config / CLI -------------------------------------------------------

def test_netconfig_result_cache_validation():
    with pytest.raises(ValueError, match="result_cache_mb"):
        NetConfig(result_cache_mb=-1.0)
    assert NetConfig().result_cache_mb == 0.0  # default off
    assert NetConfig(result_cache_mb=2.0).result_cache_bytes == 2 << 20


def test_net_cli_rejects_negative_result_cache():
    from tpu_stencil_torch.net import cli as net_cli

    with pytest.raises(SystemExit) as exc:
        net_cli.main(["--result-cache-mb", "-3"])
    assert exc.value.code == 2


# -- loadgen zipf keyspace ----------------------------------------------

def test_zipf_requests_deterministic_and_bounded():
    from tpu_stencil_torch.serve import loadgen

    imgs, idx = loadgen.zipf_requests(50, ((8, 6),), (3,), seed=3,
                                      s=1.2, keys=5)
    imgs2, idx2 = loadgen.zipf_requests(50, ((8, 6),), (3,), seed=3,
                                        s=1.2, keys=5)
    assert idx == idx2
    assert all(np.array_equal(a, b) for a, b in zip(imgs, imgs2))
    assert len(imgs) == 50 and min(idx) >= 0 and max(idx) < 5
    # The JAX package draws the same keyspace from the same seed.
    jimgs, jidx = jloadgen.zipf_requests(50, ((8, 6),), (3,), seed=3,
                                         s=1.2, keys=5)
    assert jidx == idx
    assert all(np.array_equal(a, b) for a, b in zip(imgs, jimgs))
    _, uniform = loadgen.zipf_requests(400, ((8, 6),), (3,), seed=3,
                                       s=0.0, keys=8)
    _, skewed = loadgen.zipf_requests(400, ((8, 6),), (3,), seed=3,
                                      s=2.5, keys=8)
    assert skewed.count(0) > uniform.count(0)
    with pytest.raises(ValueError, match="exponent"):
        loadgen.zipf_requests(5, ((8, 6),), (3,), seed=0, s=-0.1)
    with pytest.raises(ValueError, match="pool"):
        loadgen.zipf_requests(5, ((8, 6),), (3,), seed=0, s=1.0, keys=0)


def test_loadgen_zipf_hit_ratio_none_without_result_cache():
    from tpu_stencil_torch.serve import loadgen
    from tpu_stencil_torch.serve.engine import StencilServer

    with StencilServer(ServeConfig(max_queue=64, bucket_edges=EDGES),
                       device=CPU) as s:
        report = loadgen.run(s, requests=4, concurrency=2, reps=1,
                             shapes=((10, 12),), channels=(1,), seed=2,
                             zipf=1.0, zipf_keys=2)
    assert report["completed"] == 4
    assert report["zipf"] == 1.0 and report["zipf_keys"] == 2
    assert 1 <= report["distinct_keys_offered"] <= 2
    assert report["cache_hit_ratio"] is None


# -- HTTP tier ----------------------------------------------------------

@pytest.fixture
def net(request, tmp_path):
    """A frontend factory: every frontend it starts is drained and closed
    when the test ends."""
    started = []

    def make(**kw):
        from tpu_stencil_torch.net.http import NetFrontend

        replicas = kw.setdefault("replicas", 2)
        kw.setdefault("port", 0)
        kw.setdefault("result_cache_mb", 8.0)
        kw.setdefault("witness_rate", 0.0)
        kw.setdefault("probe_interval_s", 0.0)
        kw.setdefault("warm_fleet", False)
        kw.setdefault("bucket_edges", EDGES)
        kw.setdefault("prof_dir", str(tmp_path / "profspool"))
        fe = NetFrontend(NetConfig(**kw), devices=[CPU] * replicas)
        started.append(fe)
        return fe.start()

    yield make
    for fe in started:
        fe.close()


def _post(fe, img, reps, filter_name=None, extra_headers=None,
          timeout=300):
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    url = (fe.url + f"/v1/blur?w={w}&h={h}&reps={reps}"
                    f"&channels={channels}")
    if filter_name:
        url += f"&filter={filter_name}"
    req = urllib.request.Request(url, data=img.tobytes(), method="POST",
                                 headers=extra_headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), r.headers


def _http_error(fe, img, reps, **kw):
    try:
        _post(fe, img, reps, **kw)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    raise AssertionError("expected an HTTP error")


def _get_json(fe, path):
    with urllib.request.urlopen(fe.url + path, timeout=60) as r:
        return json.loads(r.read())


def test_hit_bit_identical_to_cold_compute_fuzz(net):
    rng = np.random.default_rng(11)
    fe = net()
    cases = [((16, 12), "gaussian", 2), ((16, 12, 3), "box", 1),
             ((24, 18, 3), "gaussian", 4), ((9, 13), "box", 0)]
    for shape, fname, reps in cases:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = np.asarray(_golden(img, reps, fname)).tobytes()
        out1, h1 = _post(fe, img, reps, filter_name=fname)
        out2, h2 = _post(fe, img, reps, filter_name=fname)
        assert h1["X-Cache"] == "miss" and h2["X-Cache"] == "hit"
        assert out1 == want and out2 == want
        stamp = str(checksum.crc32c(want))
        assert h1[checksum.RESULT_HEADER] == stamp
        assert h2[checksum.RESULT_HEADER] == stamp
    snap = fe.metrics_snapshot()
    assert snap["counters"]["result_cache_hits_total"] == len(cases)
    assert snap["counters"]["result_cache_misses_total"] == len(cases)
    assert snap["counters"]["result_cache_insertions_total"] == len(cases)
    # A hit launched nothing: one batch per case (the misses).
    assert snap["counters"]["fleet_batches_total"] == len(cases)


def test_crc_claim_validated_identically_on_hit_and_miss(net):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    body = img.tobytes()
    claim = {checksum.CRC_HEADER: str(checksum.crc32c(body))}
    fe = net()
    out1, h1 = _post(fe, img, REPS, extra_headers=claim)
    out2, h2 = _post(fe, img, REPS, extra_headers=claim)
    assert h1["X-Cache"] == "miss" and h2["X-Cache"] == "hit"
    assert out1 == out2 == _golden(img, REPS).tobytes()
    code, detail = _http_error(
        fe, img, REPS, extra_headers={checksum.CRC_HEADER: "12345"})
    assert code == 400 and "ChecksumMismatch" in detail
    code, detail = _http_error(
        fe, img, REPS, extra_headers={checksum.CRC_HEADER: "not-a-crc"})
    assert code == 400 and "malformed" in detail
    snap = fe.metrics_snapshot()
    assert snap["counters"]["integrity_checksum_failures_total"] == 1
    assert snap["counters"]["result_cache_hits_total"] == 1


def test_singleflight_one_dispatch_for_concurrent_identicals(net):
    rng = np.random.default_rng(9)
    fe = net(replicas=1)
    img = rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
    want = _golden(img, REPS).tobytes()
    rep0 = fe.fleet.replicas[0]
    orig = rep0._dispatch

    def slow(batch):
        time.sleep(1.0)  # hold the flight open for the followers
        return orig(batch)

    rep0._dispatch = slow
    results = []

    def post_one():
        results.append(_post(fe, img, REPS))

    leader = threading.Thread(target=post_one)
    leader.start()
    assert _wait_for(lambda: fe.cache.flights.inflight() == 1)
    followers = [threading.Thread(target=post_one) for _ in range(4)]
    for t in followers:
        t.start()
    leader.join(timeout=120)
    for t in followers:
        t.join(timeout=120)
    assert len(results) == 5
    xcs = sorted(h["X-Cache"] for _, h in results)
    assert xcs == ["collapsed"] * 4 + ["miss"]
    assert all(out == want for out, _ in results)
    snap = fe.metrics_snapshot()
    assert snap["counters"]["fleet_completed_total"] == 1
    assert snap["counters"]["singleflight_leaders_total"] == 1
    assert snap["counters"]["singleflight_collapsed_total"] == 4
    assert snap["counters"]["result_cache_insertions_total"] == 1


def test_follower_deadline_expires_typed_without_cancelling_leader(net):
    rng = np.random.default_rng(13)
    fe = net(replicas=1)
    rep0 = fe.fleet.replicas[0]
    orig = rep0._dispatch
    img = rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
    want = _golden(img, REPS).tobytes()

    def slow(batch):
        # Longer than the follower's deadline + grace wait (~5.2 s).
        time.sleep(6.5)
        return orig(batch)

    rep0._dispatch = slow
    leader_out = {}

    def leader():
        out, h = _post(fe, img, REPS)
        leader_out["body"], leader_out["xc"] = out, h["X-Cache"]

    t = threading.Thread(target=leader)
    t.start()
    assert _wait_for(lambda: fe.cache.flights.inflight() == 1)
    code, _ = _http_error(fe, img, REPS,
                          extra_headers={"X-Request-Timeout": "0.2"})
    assert code == 504
    t.join(timeout=120)
    assert leader_out["body"] == want and leader_out["xc"] == "miss"
    snap = fe.metrics_snapshot()
    assert snap["counters"]["fleet_completed_total"] == 1
    assert snap["counters"]["singleflight_collapsed_total"] == 1


@pytest.mark.chaos
def test_witness_mismatch_evicts_poisoned_entries_before_any_hit(net):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    want = _golden(img, REPS).tobytes()
    faults.configure("integrity.corrupt_result:times=1")
    fe = net(witness_rate=1.0, quarantine_after=3)
    out, h = _post(fe, img, REPS)
    assert h["X-Cache"] == "miss"
    assert out != want  # the corruption really went out cold

    def convicted():
        c = fe.metrics_snapshot()["counters"]
        return (c["cache_invalidations_witness_mismatch_total"] >= 1
                or c["result_cache_admission_refused_total"] >= 1)

    assert _wait_for(convicted)
    out2, h2 = _post(fe, img, REPS)
    assert h2["X-Cache"] == "miss"  # the poisoned entry is NOT hit
    assert out2 == want
    with urllib.request.urlopen(fe.url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    assert "tpu_stencil_net_cache_invalidations_witness_mismatch_total" \
        in text
    assert "tpu_stencil_net_fleet_integrity_witness_mismatch_total" in text


def test_quarantine_synchronously_empties_replica_entries(net):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    want = _golden(img, REPS).tobytes()
    fe = net()
    out, h = _post(fe, img, REPS)
    assert h["X-Cache"] == "miss" and h["X-Replica"] == "0"
    assert _post(fe, img, REPS)[1]["X-Cache"] == "hit"
    req = urllib.request.Request(
        fe.url + "/admin/quarantine?replica=0", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert json.loads(r.read())["quarantined"] is True
    assert _get_json(fe, "/admin/cache?action=stats")["entries"] == 0
    snap = fe.metrics_snapshot()
    assert snap["counters"]["cache_invalidations_quarantine_total"] == 1
    out2, h2 = _post(fe, img, REPS)
    assert h2["X-Cache"] == "miss" and h2["X-Replica"] == "1"
    assert out2 == want
    assert fe.cache.store.put(("x",), b"p", None, 0,
                              fe.cache.token()) is False
    snap = fe.metrics_snapshot()
    assert snap["counters"]["result_cache_admission_refused_total"] >= 1


def test_admin_cache_stats_clear_roundtrip_and_404_when_off(net):
    rng = np.random.default_rng(17)
    img = rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
    fe = net(replicas=1)
    _post(fe, img, 1)
    assert _post(fe, img, 1)[1]["X-Cache"] == "hit"
    stats = _get_json(fe, "/admin/cache?action=stats")
    assert stats["entries"] == 1 and stats["bytes"] == img.nbytes
    cleared = _get_json(fe, "/admin/cache?action=clear")
    assert cleared == {"action": "clear", "cleared": 1}
    assert _post(fe, img, 1)[1]["X-Cache"] == "miss"
    snap = fe.metrics_snapshot()
    assert snap["counters"]["cache_invalidations_clear_total"] == 1
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get_json(fe, "/admin/cache?action=typo")
    assert exc.value.code == 400
    status = _get_json(fe, "/statusz")
    assert status["config"]["result_cache_mb"] == 8.0
    assert status["cache"]["entries"] == 1
    fe_off = net(replicas=1, result_cache_mb=0.0)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get_json(fe_off, "/admin/cache")
    assert exc.value.code == 404  # "off" is distinguishable from "empty"
    assert _get_json(fe_off, "/statusz")["cache"] is None
    out, h = _post(fe_off, img, 1)
    assert h["X-Cache"] is None


def test_loadgen_zipf_reports_cache_hit_ratio_over_http(net):
    from tpu_stencil_torch.serve import loadgen

    fe = net(replicas=1)
    target = loadgen.HttpTarget(fe.url)
    try:
        report = loadgen.run(target, mode="closed", requests=10,
                             concurrency=1, reps=1, shapes=((10, 12),),
                             channels=(3,), seed=4, zipf=1.5,
                             zipf_keys=2)
    finally:
        target.close()
    assert report["completed"] == 10
    assert report["zipf"] == 1.5 and report["zipf_keys"] == 2
    distinct = report["distinct_keys_offered"]
    assert 1 <= distinct <= 2
    assert report["cache_hit_ratio"] == (10 - distinct) / 10
