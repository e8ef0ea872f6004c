"""The port's network tier against the JAX package's, side by side.

A JAX ``NetFrontend`` (the CPU, two replicas) and the port's (on
``devices=[cpu, cpu]``) take the same seeded requests, made with numpy,
over real sockets on port 0, and must agree on:

* the response bytes, with tolerance 0: every filter a request can name
  is an integer plan (``sep_int`` or ``direct_int``); a ``direct_f32``
  plan comes only from a custom filter, which the HTTP tier cannot take;
* the status codes over the 400 / 404 / 413 / 429 / 503 / 504 table;
* the ``X-Cache`` sequence of a result-cache run, and the response CRC;
* ``digest_and_crc`` on the same bodies;
* the key sets of ``/statusz``, ``/debug/timeseries`` and
  ``/debug/capacity``.

Both tiers are drained and closed in fixture finalizers.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_stencil.cache import digest as jdigest
from tpu_stencil.config import NetConfig as JNetConfig
from tpu_stencil.net import NetFrontend as JNetFrontend
from tpu_stencil_torch.cache import digest as cdigest
from tpu_stencil_torch.config import NetConfig
from tpu_stencil_torch.integrity import checksum
from tpu_stencil_torch.net import NetFrontend

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

CPU = torch.device("cpu")
EDGES = (8, 16, 32)
BASE = dict(port=0, replicas=2, bucket_edges=EDGES, max_queue=16,
            warm_fleet=False, flightrec_dir=None, prof_dir=None,
            witness_rate=0.0, probe_interval_s=0.0)


def _start(which, start_workers=True, **kw):
    cfg = dict(BASE, **kw)
    if which == "jax":
        return JNetFrontend(JNetConfig(**cfg),
                            start_workers=start_workers).start()
    return NetFrontend(NetConfig(**cfg), start_workers=start_workers,
                       devices=[CPU] * cfg["replicas"]).start()


@pytest.fixture
def pair():
    """A factory of (JAX tier, port tier) pairs with the same config;
    every tier it starts is closed when the test ends."""
    started = []

    def make(start_workers=True, **kw):
        out = (_start("jax", start_workers, **kw),
               _start("port", start_workers, **kw))
        started.extend(out)
        return out

    yield make
    for fe in started:
        fe.close()


def _post(url, img, reps, filter_name=None, headers=None, body=None,
          query=None, timeout=120.0):
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    hdr = {"X-Width": str(w), "X-Height": str(h), "X-Reps": str(reps),
           "X-Channels": str(c)}
    if filter_name:
        hdr["X-Filter"] = filter_name
    hdr.update(headers or {})
    req = urllib.request.Request(
        url + "/v1/blur" + (query or ""),
        data=img.tobytes() if body is None else body, headers=hdr,
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


REQUESTS = [
    ((12, 10), "gaussian", 2),
    ((12, 10, 3), "gaussian", 3),
    ((16, 16, 3), "box", 2),
    ((9, 13), "edge", 1),
    ((20, 14, 3), "soft_blur", 2),
    ((15, 11, 3), "gaussian5", 1),
    ((7, 9), "identity", 3),
    ((12, 10, 3), "gaussian", 0),
]


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, shape, dtype=np.uint8), f, r)
            for shape, f, r in REQUESTS]


def test_bytes_crc_and_x_cache_sequence_equal(pair):
    jfe, pfe = pair(result_cache_mb=8.0)
    seq = {"jax": [], "port": []}
    for img, fname, reps in _requests(31) * 2:
        body = img.tobytes()
        claim = {checksum.CRC_HEADER: str(checksum.crc32c(body))}
        got = {}
        for name, fe in (("jax", jfe), ("port", pfe)):
            status, out, hdr = _post(fe.url, img, reps, fname, claim)
            assert status == 200, (name, out[:200])
            got[name] = (out, hdr[checksum.RESULT_HEADER])
            seq[name].append(hdr["X-Cache"])
        assert got["port"] == got["jax"], (img.shape, fname, reps)
        assert int(got["port"][1]) == checksum.crc32c(got["port"][0])
    assert seq["port"] == seq["jax"]
    assert seq["port"] == ["miss"] * len(REQUESTS) + ["hit"] * len(REQUESTS)
    jc, pc = (fe.metrics_snapshot()["counters"] for fe in (jfe, pfe))
    for k in ("result_cache_hits_total", "result_cache_misses_total",
              "result_cache_insertions_total", "responses_2xx_total"):
        assert pc[k] == jc[k], k


def test_uncached_bytes_and_stamps_equal_without_integrity(pair):
    jfe, pfe = pair(integrity=False)
    for img, fname, reps in _requests(32):
        j = _post(jfe.url, img, reps, fname)
        p = _post(pfe.url, img, reps, fname)
        assert p[0] == j[0] == 200 and p[1] == j[1]
        assert checksum.RESULT_HEADER not in p[2]
        assert checksum.RESULT_HEADER not in j[2]
        assert p[2].get("X-Cache") is None and j[2].get("X-Cache") is None


def test_digest_and_crc_equal_on_request_bodies():
    for img, _f, _r in _requests(33):
        body = img.tobytes()
        assert cdigest.digest_and_crc(body) == jdigest.digest_and_crc(body)
        assert cdigest.digest_and_crc(img) == jdigest.digest_and_crc(img)


def _status_table(url):
    img = np.random.default_rng(34).integers(0, 256, (8, 8), np.uint8)
    body = img.tobytes()
    rows = {
        "no_geometry": urllib.request.Request(
            url + "/v1/blur", data=body, method="POST"),
        "bad_channels": None, "unknown_filter": None, "short_body": None,
        "bad_crc": None, "malformed_crc": None, "periodic": None,
        "oversized": urllib.request.Request(
            url + "/v1/blur?w=8&h=8&reps=1&channels=1",
            data=body + b"\0" * 100, method="POST"),
        "unknown_endpoint": urllib.request.Request(
            url + "/v2/blur", data=body, method="POST"),
        "unknown_get": urllib.request.Request(url + "/nope"),
        "bad_window": urllib.request.Request(
            url + "/debug/timeseries?window=-1"),
        "bad_restart": urllib.request.Request(
            url + "/admin/restart?replica=9", data=b"", method="POST"),
        "cache_off": urllib.request.Request(url + "/admin/cache"),
    }
    out = {}
    for name, req in rows.items():
        if req is None:
            continue
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                out[name] = r.status
        except urllib.error.HTTPError as e:
            out[name] = e.code
    out["bad_channels"] = _post(url, img.reshape(8, 4, 2), 1)[0]
    out["unknown_filter"] = _post(url, img, 1, "bogus")[0]
    out["short_body"] = _post(url, img, 1, body=body[:32])[0]
    out["bad_crc"] = _post(url, img, 1,
                           headers={checksum.CRC_HEADER: "12345"})[0]
    out["malformed_crc"] = _post(url, img, 1,
                                 headers={checksum.CRC_HEADER: "x"})[0]
    out["periodic"] = _post(url, img, 1,
                            headers={"X-Boundary": "periodic"})[0]
    return out


def test_status_codes_400_404_413_equal(pair):
    jfe, pfe = pair()
    jt, pt = _status_table(jfe.url), _status_table(pfe.url)
    assert pt == jt
    assert set(pt.values()) == {400, 404, 413}


def _fill_parked(fe, img, n):
    results = []

    def post():
        results.append(_post(fe.url, img, 1)[0])

    threads = [threading.Thread(target=post, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while (sum(fe.router.outstanding().values()) < n
           and time.monotonic() < deadline):
        time.sleep(0.01)
    return threads, results


def test_status_codes_429_503_504_equal(pair):
    img = np.random.default_rng(35).integers(0, 256, (8, 8), np.uint8)
    codes = {}
    # 429: every replica queue full (parked workers, max_queue 1), with
    # a Retry-After hint; then the parked requests complete.
    jfe, pfe = pair(start_workers=False, max_queue=1)
    for name, fe in (("jax", jfe), ("port", pfe)):
        threads, results = _fill_parked(fe, img, 2)
        status, _b, hdr = _post(fe.url, img, 1)
        codes.setdefault(name, []).append(status)
        assert hdr.get("Retry-After")
        fe.fleet.start_workers()
        for t in threads:
            t.join(timeout=120)
        assert results == [200, 200]
    # 504: a deadline expiring in a parked queue.
    jfe, pfe = pair(start_workers=False)
    for name, fe in (("jax", jfe), ("port", pfe)):
        result = {}
        t = threading.Thread(target=lambda: result.update(r=_post(
            fe.url, img, 1, headers={"X-Request-Timeout": "0.05"})))
        t.start()
        deadline = time.monotonic() + 60
        while (sum(fe.router.outstanding().values()) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        time.sleep(0.15)
        fe.fleet.start_workers()
        t.join(timeout=120)
        codes[name].append(result["r"][0])
    # 503: the shed watermark, every replica quarantined, draining.
    jfe, pfe = pair(max_inflight_mb=0.0001)
    for name, fe in (("jax", jfe), ("port", pfe)):
        status, body, hdr = _post(fe.url, img, 1)
        codes[name].append(status)
        assert b"shed" in body and hdr.get("Retry-After")
    jfe, pfe = pair()
    for name, fe in (("jax", jfe), ("port", pfe)):
        for i in (0, 1):
            fe.router.quarantine_replica(i, "test")
        codes[name].append(_post(fe.url, img, 1)[0])
        fe.begin_drain()
        codes[name].append(_post(fe.url, img, 1)[0])
        codes[name].append(_get(fe.url, "/healthz")[0])
    assert codes["port"] == codes["jax"] == [429, 504, 503, 503, 503, 503]


def _keys(d, depth=2):
    """The nested key set of a JSON payload, ``depth`` levels down."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk in _keys(v, depth - 1)}
    return out


def test_statusz_timeseries_capacity_key_sets_equal(pair):
    jfe, pfe = pair(sample_interval_s=0.05, result_cache_mb=1.0)
    img = np.random.default_rng(36).integers(0, 256, (10, 12), np.uint8)
    for fe in (jfe, pfe):
        assert _post(fe.url, img, 1)[0] == 200
    time.sleep(0.2)  # a few sampler ticks on both tiers
    for path in ("/statusz", "/debug/timeseries?window=30",
                 "/debug/capacity?window=30"):
        j = json.loads(_get(jfe.url, path)[1])
        p = json.loads(_get(pfe.url, path)[1])
        jk, pk = _keys(j), _keys(p)
        # The registries' counter, gauge and histogram names are each
        # engine's own (the port's bucket route keeps pinned-slot
        # counters the JAX engine has no use for): compare the payloads'
        # structure, not the registry contents.
        drop = ("net.", "counters.", "gauges.", "histograms.")
        assert ({k for k in pk if not k.startswith(drop)}
                == {k for k in jk if not k.startswith(drop)}), path
    for path in ("/debug/capacity", "/statusz"):
        j = json.loads(_get(jfe.url, path)[1])
        p = json.loads(_get(pfe.url, path)[1])
        for block in ("per_replica",):
            if isinstance(j.get(block), dict):
                assert set(p[block]) == set(j[block])
    # Every name the JAX tier's own registry carries, the port's carries.
    jn = jfe.registry.snapshot()
    pn = pfe.registry.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert set(jn[kind]) <= set(pn[kind]), kind
