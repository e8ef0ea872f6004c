"""The port's network serving tier against the JAX package's contract, on
the CPU, through real sockets on port 0.

Mirrors ``tests/test_net.py`` test for test, and the net and loadgen-HTTP
cases of ``tests/test_integrity.py``:

* a localhost round trip is byte-identical to the JAX package's golden
  model and to the port's ``driver.run_job``, grey and RGB, chunked too;
* admission never hangs a client: every queue full -> 429 + Retry-After,
  the in-flight watermark -> 503, draining -> 503, an expired deadline ->
  504, each typed and counted;
* a drain completes (or fails typed) every accepted request; a rolling
  restart keeps the rest of the fleet serving; a crashed worker is
  rebuilt; ``/metrics`` survives the exposition's exact round trip;
* continuous batching stacks concurrent same-key requests into one
  ``submit_group`` (counted, never timed), the ingest arena never bleeds
  one request's pixels into another, even when a released buffer is
  rewritten while its request is still in flight;
* the integrity layer: claims checked, results stamped, corruption
  caught, quarantine routes around a replica and probes bring it back;
* the port's own contracts: ``GET /admin/warmstate`` answers 200 with the
  program-cache keys (an ``unsupported`` envelope when the kernel sources
  cannot be read) and ``--warm-from`` such an envelope degrades every
  replica to a cold start, counted; ``--register`` posts to a federation
  router (a stub handler here); no card and no ``--platform cpu`` fails typed
  (``NoDeviceError``); a kernel that cannot build answers a typed 500
  with no torch-ops fallback.

Every frontend runs on ``devices=[cpu] * n`` (the kernels' plain
versions) and is drained and closed in a fixture finalizer.
"""

import http.client
import http.server
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from tpu_stencil import filters as jfilters
from tpu_stencil.config import NetConfig as JNetConfig
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import NetConfig, ServeConfig
from tpu_stencil_torch.integrity import checksum
from tpu_stencil_torch.obs import flight as oflight
from tpu_stencil_torch.resilience import faults

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
EDGES = (8, 16, 32, 64)
H, W, C, REPS = 32, 24, 3, 3


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path / "flightrec"))
    faults.clear()
    yield
    faults.clear()


def _golden(img, reps, name="gaussian"):
    return jstencil.reference_stencil_numpy(img, jfilters.get_filter(name),
                                            reps)


def _img(rng=None, shape=(H, W, C)):
    rng = rng or np.random.default_rng(7)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _post(url, img, reps, *, filter_name=None, timeout_s=None,
          boundary=None, via_headers=True, http_timeout=300.0,
          headers=None):
    """POST one frame; returns (status, body_bytes, headers_dict)."""
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    if via_headers:
        hdr = {"X-Width": str(w), "X-Height": str(h),
               "X-Reps": str(reps), "X-Channels": str(channels)}
        if filter_name:
            hdr["X-Filter"] = filter_name
        if timeout_s is not None:
            hdr["X-Request-Timeout"] = repr(timeout_s)
        if boundary:
            hdr["X-Boundary"] = boundary
        target = url + "/v1/blur"
    else:
        hdr = {}
        target = (url + f"/v1/blur?w={w}&h={h}&reps={reps}"
                        f"&channels={channels}")
        if filter_name:
            target += f"&filter={filter_name}"
    hdr.update(headers or {})
    req = urllib.request.Request(target, data=img.tobytes(), headers=hdr,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=http_timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _get(url, path, http_timeout=60.0):
    try:
        with urllib.request.urlopen(url + path, timeout=http_timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_admin(url, path):
    req = urllib.request.Request(url + path, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _new_frontend(start_workers=True, **overrides):
    from tpu_stencil_torch.net import NetFrontend

    kw = dict(port=0, replicas=2, bucket_edges=EDGES, max_queue=16,
              prof_dir=None)
    kw.update(overrides)
    return NetFrontend(NetConfig(**kw), start_workers=start_workers,
                       devices=[CPU] * kw["replicas"]).start()


@pytest.fixture
def make_fe():
    """A frontend factory: every frontend it starts is drained and
    closed when the test ends."""
    started = []

    def make(start_workers=True, **overrides):
        fe = _new_frontend(start_workers, **overrides)
        started.append(fe)
        return fe

    yield make
    for fe in started:
        fe.close()


@pytest.fixture(scope="module")
def fe():
    # One module-scoped tier (2 replicas on the CPU): programs built by
    # earlier tests stay warm for later ones.
    frontend = _new_frontend()
    yield frontend
    frontend.close()


def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- config / CLI validation ------------------------------------------


def test_netconfig_validation():
    with pytest.raises(ValueError, match="port"):
        NetConfig(port=70000)
    with pytest.raises(ValueError, match="replicas"):
        NetConfig(replicas=-1)
    with pytest.raises(ValueError, match="max_queue"):
        NetConfig(max_queue=0)
    with pytest.raises(ValueError, match="max_batch"):
        NetConfig(max_batch=0)
    with pytest.raises(ValueError, match="max_inflight_mb"):
        NetConfig(max_inflight_mb=-1.0)
    with pytest.raises(ValueError, match="request_timeout_s"):
        NetConfig(request_timeout_s=-0.1)
    with pytest.raises(ValueError, match="drain_timeout_s"):
        NetConfig(drain_timeout_s=0.0)
    with pytest.raises(ValueError, match="bucket_edges"):
        NetConfig(bucket_edges=(16, 8))
    with pytest.raises(ValueError, match="backend"):
        NetConfig(backend="mps")
    with pytest.raises(ValueError, match="host"):
        NetConfig(host="")
    with pytest.raises(ValueError, match="unknown filter"):
        NetConfig(filter_name="bogus")
    assert NetConfig(filter_name="gaussian5").filter_name == "gaussian5"
    assert NetConfig(max_inflight_mb=1.5).max_inflight_bytes == 3 << 19


@pytest.mark.parametrize("kw", [
    dict(port=-1), dict(replicas=-1), dict(max_queue=0),
    dict(drain_timeout_s=0.0), dict(witness_rate=1.5),
    dict(quarantine_after=0), dict(quarantine_window_s=0.0),
    dict(readmit_after=0), dict(probe_interval_s=-1.0),
    dict(flight_latency_threshold_s=-1.0), dict(coalesce_window_us=-1.0),
    dict(result_cache_mb=-1.0), dict(sample_interval_s=-1.0),
    dict(slo_error_budget=1.5), dict(slo_fast_window_s=0.0),
    dict(slo_fast_window_s=10.0, slo_slow_window_s=5.0),
    dict(slo_fast_burn=0.0), dict(slo_latency_p99_s=-1.0),
    dict(filter_name="nope"), dict(bucket_edges=(0, 8)),
])
def test_netconfig_refusals_equal_the_jax_package(kw):
    with pytest.raises(ValueError) as port_err:
        NetConfig(**kw)
    with pytest.raises(ValueError) as jax_err:
        JNetConfig(**kw)
    msg = str(port_err.value)
    if "filter_name" in kw:
        # Both name the unknown filter (each lists its own registry).
        assert "unknown filter 'nope'" in msg
        assert "unknown filter 'nope'" in str(jax_err.value)
    else:
        assert msg == str(jax_err.value)


def test_netconfig_derives_pinned_serve_configs():
    cfg = NetConfig(bucket_edges=EDGES, max_queue=7, max_batch=3,
                    request_timeout_s=1.5, filter_name="box")
    scfg = cfg.serve_config(3)
    assert scfg.device_index == 3
    assert scfg.bucket_edges == EDGES
    assert scfg.max_queue == 7 and scfg.max_batch == 3
    assert scfg.request_timeout_s == 1.5
    assert scfg.filter_name == "box"
    assert scfg.mem_sample_interval_s == 0.0
    # overlap is not forwarded: every replica serves on the bucket route.
    assert scfg.overlap == "off"
    # The fields the JAX package forwards, forwarded alike.
    jcfg = JNetConfig(bucket_edges=EDGES, max_queue=7, max_batch=3,
                      request_timeout_s=1.5, filter_name="box",
                      witness_rate=0.25)
    jscfg = jcfg.serve_config(3)
    scfg = NetConfig(bucket_edges=EDGES, max_queue=7, max_batch=3,
                     request_timeout_s=1.5, filter_name="box",
                     witness_rate=0.25).serve_config(3)
    for f in ("filter_name", "backend", "max_queue", "max_batch",
              "bucket_edges", "request_timeout_s", "device_index",
              "mem_sample_interval_s", "witness_rate", "witness_seed",
              "overlap"):
        assert getattr(scfg, f) == getattr(jscfg, f), f
    assert NetConfig(integrity=False).serve_config(0).witness_rate == 0.0


def test_serve_config_device_index_validation():
    with pytest.raises(ValueError, match="device_index"):
        ServeConfig(device_index=-1)
    assert ServeConfig(device_index=2).device_index == 2


def test_net_cli_rejects_bad_flags():
    from tpu_stencil_torch.net import cli as net_cli

    for argv in (["--port", "70000"],
                 ["--replicas", "-2"],
                 ["--drain-timeout", "0"],
                 ["--max-inflight-mb", "-1"],
                 ["--backend", "mps"],
                 ["--platform", "tpu"],
                 ["--filter", "typo"]):
        with pytest.raises(SystemExit) as exc:
            net_cli.main(argv)
        assert exc.value.code == 2, argv


def test_net_cli_without_a_card_fails_typed(capsys, monkeypatch):
    # No CUDA device and no --platform cpu: NoDeviceError, rc 2, before a
    # socket is bound or a replica is built.
    from tpu_stencil_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["net", "--port", "0"]) == 2
    err = capsys.readouterr().err
    assert "NoDeviceError" in err and "--platform cpu" in err


def test_fleet_without_a_card_raises_no_device_error(monkeypatch):
    from tpu_stencil_torch.devices import NoDeviceError
    from tpu_stencil_torch.net import NetFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    fe = NetFrontend(NetConfig(port=0))
    with pytest.raises(NoDeviceError):
        fe.start()
    fe.close()


def test_replicas_above_the_device_count_are_refused(capsys):
    from tpu_stencil_torch.net import NetFrontend
    from tpu_stencil_torch.net import cli as net_cli

    fe = NetFrontend(NetConfig(port=0, replicas=3), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="replicas=3 exceeds 2"):
        fe.start()
    fe.close()
    # The CLI offers the CPU --replicas times, so it never refuses there.
    assert net_cli.build_parser().parse_args(
        ["--platform", "cpu"]).platform == "cpu"


# -- round-trip exactness ---------------------------------------------


def test_http_round_trip_rgb_bit_exact(fe, rng):
    img = rng.integers(0, 256, (24, 18, 3), dtype=np.uint8)
    status, body, headers = _post(fe.url, img, 3)
    assert status == 200
    assert headers["X-Width"] == "18" and headers["X-Height"] == "24"
    got = np.frombuffer(body, np.uint8).reshape(img.shape)
    np.testing.assert_array_equal(got, _golden(img, 3))


def test_http_round_trip_grey_bit_exact(fe, rng):
    img = rng.integers(0, 256, (17, 23), dtype=np.uint8)
    status, body, _ = _post(fe.url, img, 2, via_headers=False)
    assert status == 200
    got = np.frombuffer(body, np.uint8).reshape(img.shape)
    np.testing.assert_array_equal(got, _golden(img, 2))


def test_http_zero_reps_identity(fe, rng):
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    status, body, _ = _post(fe.url, img, 0)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), img)


def test_http_per_request_filter(fe, rng):
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    status, body, _ = _post(fe.url, img, 2, filter_name="box")
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape),
        _golden(img, 2, "box"))


def test_http_round_trip_matches_run_job(fe, rng, tmp_path):
    from tpu_stencil_torch import driver
    from tpu_stencil_torch.config import ImageType, JobConfig

    img = rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)
    src = tmp_path / "frame.raw"
    out = tmp_path / "blur.raw"
    img.tofile(src)
    driver.run_job(JobConfig(
        image=str(src), width=28, height=20, repetitions=4,
        image_type=ImageType.RGB, output=str(out),
    ), device=CPU)
    want = np.fromfile(out, np.uint8).reshape(img.shape)
    status, body, _ = _post(fe.url, img, 4)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), want)


def _chunked_post(port, img, reps):
    payload = img.tobytes()
    h, w, c = img.shape

    def chunks():
        for i in range(0, len(payload), 997):  # deliberately odd stride
            yield payload[i:i + 997]

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", f"/v1/blur?w={w}&h={h}&reps={reps}"
                             f"&channels={c}",
                     body=chunks(), encode_chunked=True,
                     headers={"Transfer-Encoding": "chunked"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_chunked_upload_bit_exact(fe, rng):
    img = rng.integers(0, 256, (33, 21, 3), dtype=np.uint8)
    status, body = _chunked_post(fe.port, img, 2)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))


# -- HTTP status mapping ----------------------------------------------


def test_http_bad_params_400(fe, rng):
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    req = urllib.request.Request(fe.url + "/v1/blur", data=img.tobytes(),
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 400
    status, body, _ = _post(fe.url, img.reshape(8, 4, 2), 1)
    assert status == 400 and b"channels" in body
    status, body, _ = _post(fe.url, img, 1, filter_name="bogus")
    assert status == 400 and b"unknown filter" in body
    req = urllib.request.Request(
        fe.url + "/v1/blur?w=8&h=8&reps=1&channels=1",
        data=img.tobytes()[:32], method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 400
    assert b"needs exactly 64" in exc.value.read()


def test_http_oversized_body_413(fe):
    req = urllib.request.Request(
        fe.url + "/v1/blur?w=8&h=8&reps=1&channels=1",
        data=b"\0" * (8 * 8 + 100), method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 413


def test_http_malformed_content_length_400(fe):
    conn = http.client.HTTPConnection(fe.cfg.host, fe.port, timeout=60)
    try:
        conn.putrequest("POST", "/v1/blur?w=8&h=8&reps=1&channels=1")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert b"Content-Length" in resp.read()
    finally:
        conn.close()


def test_http_periodic_boundary_400(fe, rng):
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    status, body, _ = _post(fe.url, img, 1, boundary="periodic")
    assert status == 400 and b"zero only" in body
    assert b"tpu_stencil_torch" in body


def test_http_unknown_endpoint_404(fe):
    assert _get(fe.url, "/v2/blur")[0] == 404
    status, _, _ = _post(fe.url + "/nope", np.zeros((4, 4), np.uint8), 1)
    assert status == 404


def test_backpressure_429_then_drains_without_drops(make_fe, rng):
    frontend = make_fe(start_workers=False, max_queue=1, warm_fleet=False)
    imgs = [rng.integers(0, 256, (10, 12), dtype=np.uint8)
            for _ in range(2)]
    results = {}

    def client(i):
        results[i] = _post(frontend.url, imgs[i], 2)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    assert _wait_for(
        lambda: sum(frontend.router.outstanding().values()) == 2)
    status, body, headers = _post(
        frontend.url, rng.integers(0, 256, (10, 12), np.uint8), 2)
    assert status == 429
    assert headers.get("Retry-After")
    assert b"capacity" in body or b"full" in body
    assert frontend.registry.snapshot()["counters"]["rejected_total"] == 1
    frontend.fleet.start_workers()
    for t in threads:
        t.join(timeout=300)
    for i, img in enumerate(imgs):
        status, body, _ = results[i]
        assert status == 200, f"accepted request {i} was dropped"
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 2))


def test_load_shed_503_past_inflight_watermark(make_fe, rng):
    frontend = make_fe(max_inflight_mb=0.01)
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    status, body, headers = _post(frontend.url, img, 1)
    assert status == 503
    assert b"shed" in body
    assert headers.get("Retry-After")
    snap = frontend.registry.snapshot()
    assert snap["counters"]["shed_total"] == 1
    assert snap["counters"]["requests_total"] == 0  # never admitted
    small = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    status, body, _ = _post(frontend.url, small, 1)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(small.shape),
        _golden(small, 1))


def test_deadline_maps_to_504(make_fe, rng):
    frontend = make_fe(start_workers=False)
    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    result = {}

    def client():
        result["r"] = _post(frontend.url, img, 2, timeout_s=0.05)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    assert _wait_for(
        lambda: sum(frontend.router.outstanding().values()) >= 1)
    time.sleep(0.15)  # let the deadline expire while queued
    frontend.fleet.start_workers()
    t.join(timeout=300)
    status, body, _ = result["r"]
    assert status == 504
    assert b"expired" in body
    assert frontend.fleet.merged_counters()["deadline_expired_total"] == 1


# -- drain / restart ---------------------------------------------------


def test_drain_under_load_completes_every_accepted_request(make_fe, rng):
    frontend = make_fe()
    imgs = [rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
            for _ in range(4)]
    assert _post(frontend.url, imgs[0], 5)[0] == 200
    results = {}

    def client(i):
        results[i] = _post(frontend.url, imgs[i], 5)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    report = frontend.drain(30.0)
    assert report == {0: True, 1: True}
    assert _get(frontend.url, "/healthz")[0] == 503
    status, body, _ = _post(frontend.url, imgs[0], 5)
    assert status == 503 and b"draining" in body
    for t in threads:
        t.join(timeout=300)
    for i, img in enumerate(imgs):
        status, body, _ = results[i]
        assert status in (200, 503), f"request {i}: {status}"
        if status == 200:
            np.testing.assert_array_equal(
                np.frombuffer(body, np.uint8).reshape(img.shape),
                _golden(img, 5))
    snap = frontend.registry.snapshot()
    assert snap["gauges"]["draining"]["value"] == 1
    assert snap["counters"]["drain_abandoned_replicas_total"] == 0


def test_close_waits_for_admitted_requests_to_be_answered(rng,
                                                          monkeypatch):
    # The drain completes every admitted request; close() then lets each
    # handler write its response before the listener stops (a process
    # exit right after close() would otherwise cut a handler that had
    # its result but had not written it yet).
    from tpu_stencil_torch.net import http as net_http

    frontend = _new_frontend(replicas=1)
    events = []
    orig = net_http._Handler._send_result

    def slow_send(self, *a, **k):
        time.sleep(0.5)
        orig(self, *a, **k)
        events.append("sent")

    monkeypatch.setattr(net_http._Handler, "_send_result", slow_send)
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    result = {}
    t = threading.Thread(target=lambda: result.update(
        r=_post(frontend.url, img, 1)))
    t.start()
    try:
        assert _wait_for(lambda: frontend.fleet.merged_counters().get(
            "completed_total", 0) == 1, 60)
        frontend.drain(30.0)
    finally:
        frontend.close()
    events.append("closed")
    t.join(timeout=60)
    assert events == ["sent", "closed"]
    assert result["r"][0] == 200
    np.testing.assert_array_equal(
        np.frombuffer(result["r"][1], np.uint8).reshape(img.shape),
        _golden(img, 1))


def test_fleet_drain_reports_hung_replica(make_fe, rng, monkeypatch):
    frontend = make_fe()
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    assert _post(frontend.url, img, 1)[0] == 200
    rep0 = frontend.fleet.replicas[0]
    orig = rep0._dispatch

    def stuck(batch):
        time.sleep(5.0)
        return orig(batch)

    monkeypatch.setattr(rep0, "_dispatch", stuck)
    rep0.submit(img, 1)  # the worker parks inside stuck()
    time.sleep(0.2)
    report = frontend.drain(0.5)
    assert report[0] is False and report[1] is True
    snap = frontend.registry.snapshot()
    assert snap["counters"]["drain_abandoned_replicas_total"] == 1
    assert rep0.stats()["counters"]["serve_close_abandoned_total"] == 1


def test_close_returns_drained_vs_abandoned(rng, monkeypatch):
    from tpu_stencil_torch.serve.engine import StencilServer

    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    s = StencilServer(ServeConfig(max_queue=4, bucket_edges=EDGES),
                      device=CPU)
    s.submit(img, 1).result(timeout=300)
    assert s.close(timeout=30) is True
    assert s.stats()["counters"].get("serve_close_abandoned_total", 0) == 0
    s2 = StencilServer(ServeConfig(max_queue=4, bucket_edges=EDGES),
                       start=False, device=CPU)
    monkeypatch.setattr(
        s2, "_dispatch", lambda batch: time.sleep(5.0) or (batch,) * 4)
    s2.submit(img, 1)
    s2.start()
    time.sleep(0.2)
    assert s2.close(timeout=0.3) is False
    assert s2.stats()["counters"]["serve_close_abandoned_total"] == 1


def test_rolling_replica_restart(fe, rng):
    img = rng.integers(0, 256, (14, 14, 3), dtype=np.uint8)
    assert _post(fe.url, img, 2)[0] == 200
    before = fe.registry.snapshot()["counters"].get(
        "replica_restarts_total", 0)
    old = fe.fleet.replicas[0]
    status, body = _post_admin(fe.url, "/admin/restart?replica=0")
    assert status == 200
    payload = json.loads(body)
    assert payload["restarted"] and payload["old_drained"] is True
    assert fe.fleet.replicas[0] is not old
    # The fresh engine runs on the same device as the old one.
    assert fe.fleet.replicas[0].device == old.device == CPU
    snap = fe.registry.snapshot()
    assert snap["counters"]["replica_restarts_total"] == before + 1
    status, body, _ = _post(fe.url, img, 2)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))
    assert _post_admin(fe.url, "/admin/restart?replica=9")[0] == 400


def test_worker_crash_restarts_replica_and_serves(make_fe, rng,
                                                  monkeypatch):
    from tpu_stencil_torch.resilience.errors import WorkerCrashed

    frontend = make_fe(replicas=1)
    rep = frontend.fleet.replicas[0]

    def crashed(*a, **k):
        raise WorkerCrashed("injected: worker thread died")

    monkeypatch.setattr(rep, "submit", crashed)
    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    status, body, _ = _post(frontend.url, img, 2)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))
    assert frontend.fleet.replicas[0] is not rep
    snap = frontend.registry.snapshot()
    assert snap["counters"]["worker_crash_reroutes_total"] == 1
    assert snap["counters"]["replica_restarts_total"] == 1


def test_router_skips_mid_restart_replica(make_fe, rng):
    frontend = make_fe(warm_fleet=False)
    frontend.fleet.replicas[0].close(timeout=60)
    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    status, body, headers = _post(frontend.url, img, 2)
    assert status == 200 and int(headers["X-Replica"]) == 1
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))
    frontend.fleet.replicas[1].close(timeout=60)
    assert _post(frontend.url, img, 2)[0] == 429


# -- placement / warming ----------------------------------------------


def test_least_outstanding_placement_spreads_load(make_fe, rng):
    frontend = make_fe(start_workers=False, warm_fleet=False)
    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    futs = [frontend.router.submit(img, 1)[0] for _ in range(4)]
    assert frontend.router.outstanding() == {0: 2, 1: 2}
    snap = frontend.registry.snapshot()
    assert snap["gauges"]["replica_depth_dev0"]["value"] == 2
    assert snap["gauges"]["replica_depth_dev1"]["value"] == 2
    frontend.fleet.start_workers()
    for f in futs:
        np.testing.assert_array_equal(f.result(timeout=300),
                                      _golden(img, 1))


def test_warm_fleet_prewarms_sibling_caches(make_fe, rng):
    frontend = make_fe()
    img = rng.integers(0, 256, (11, 9, 3), dtype=np.uint8)
    status, _, headers = _post(frontend.url, img, 3)
    assert status == 200
    chosen = int(headers["X-Replica"])
    sibling = frontend.fleet.replicas[1 - chosen]
    assert _wait_for(
        lambda: sibling.stats()["counters"]["completed_total"] >= 1, 60)
    sstats = sibling.stats()["counters"]
    assert sstats["completed_total"] == 1  # the discarded warm frame
    assert sstats["cache_misses_total"] == 1
    assert (frontend.registry.snapshot()["counters"]
            ["warm_submits_total"] == 1)
    img2 = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    sibling.submit(img2, 3).result(timeout=300)
    assert sibling.stats()["counters"]["cache_hits_total"] == 1
    assert frontend.fleet.prewarm_others(chosen, img, 3) == 0


def test_fleet_replicas_share_one_device_list(make_fe):
    # [cpu, cpu]: two replicas on one device, each given it by device=,
    # neither turned into cuda:<i> by its pinned index.
    frontend = make_fe()
    assert frontend.fleet.devices == [CPU, CPU]
    assert [r.device for r in frontend.fleet.replicas] == [CPU, CPU]
    assert [r.cfg.device_index for r in frontend.fleet.replicas] == [
        None, None]
    assert [r.cfg.witness_seed for r in frontend.fleet.replicas] == [0, 1]
    assert all(r.cfg.overlap == "off" for r in frontend.fleet.replicas)


# -- scrape surfaces ---------------------------------------------------


def test_metrics_exposition_parse_round_trip(fe, rng):
    from tpu_stencil_torch.obs import exposition

    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    assert _post(fe.url, img, 1)[0] == 200
    status, body = _get(fe.url, "/metrics")
    assert status == 200
    text = body.decode()
    snap = exposition.parse_text(text, prefix="tpu_stencil_net")
    assert snap["counters"]["requests_total"] >= 1
    assert "fleet_completed_total" in snap["counters"]
    assert "fleet_batches_total" in snap["counters"]
    assert "replica_depth_dev0" in snap["gauges"]
    assert "request_bytes" in snap["histograms"]
    assert "request_latency_seconds" in snap["histograms"]
    assert snap["replicas"] == 2
    assert exposition.render_text(snap, prefix="tpu_stencil_net") == text


def test_statusz_schema(fe):
    status, body = _get(fe.url, "/statusz")
    assert status == 200
    payload = json.loads(body)
    assert payload["schema_version"] == 1
    assert payload["replicas"] == 2
    assert payload["draining"] is False
    assert len(payload["per_replica"]) == 2
    assert set(payload["outstanding"]) == {"0", "1"}
    assert "net" in payload and "counters" in payload["net"]
    assert payload["config"]["max_queue"] == 16


def test_healthz_ok_when_serving(fe):
    status, body = _get(fe.url, "/healthz")
    assert status == 200 and body == b"ok\n"


def test_capacity_names_the_h100_host_link(fe):
    from tpu_stencil_torch.runtime import roofline

    payload = json.loads(_get(fe.url, "/debug/capacity")[1])
    assert payload["bandwidth"]["roofline_gbps"] == (
        roofline.H100_PCIE_BYTES_PER_S / 1e9)
    assert payload["source"] == "net" and payload["schema_version"] == 1
    assert _get(fe.url, "/debug/capacity?window=0")[0] == 400


def test_net_spans_recorded(rng):
    obs.enable()
    try:
        frontend = _new_frontend()
        try:
            img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
            assert _post(frontend.url, img, 1)[0] == 200
            frontend.drain(10.0)
        finally:
            frontend.close()
        names = {s.name for s in obs.get_tracer().spans()}
        assert {"net.request", "net.route", "net.drain"} <= names, names
    finally:
        obs.disable()
        obs.reset()


# -- loadgen over HTTP -------------------------------------------------


def test_loadgen_http_closed_loop(fe):
    from tpu_stencil_torch.serve import loadgen

    target = loadgen.HttpTarget(fe.url)
    try:
        report = loadgen.run(
            target, mode="closed", requests=6, concurrency=2, reps=1,
            shapes=((10, 12),), channels=(3,), seed=1)
    finally:
        target.close()
    assert report["completed"] == 6
    assert report["p99_s"] >= report["p50_s"] > 0
    assert report["stats"]["counters"]["requests_total"] >= 6
    assert "fleet_completed_total" in report["stats"]["counters"]


def test_loadgen_http_rate_fps_report(fe):
    from tpu_stencil_torch.serve import loadgen

    target = loadgen.HttpTarget(fe.url)
    try:
        report = loadgen.run(
            target, requests=4, reps=1, rate_fps=200.0,
            shapes=((10, 12),), channels=(1,), seed=2)
    finally:
        target.close()
    assert report["mode"] == "open"
    assert report["requested_fps"] == 200.0
    assert report["completed"] == 4


def test_loadgen_http_all_shed_reports_zero_completed(make_fe):
    from tpu_stencil_torch.serve import loadgen
    from tpu_stencil_torch.serve.engine import ServerClosed

    frontend = make_fe(warm_fleet=False)
    frontend.begin_drain()
    target = loadgen.HttpTarget(frontend.url)
    try:
        report = loadgen.run(
            target, requests=3, reps=1, rate_fps=100.0,
            shapes=((8, 8),), channels=(1,), seed=3)
    finally:
        target.close()
    assert report["completed"] == 0
    assert report["p50_s"] == report["p99_s"] == 0.0
    target = loadgen.HttpTarget(frontend.url)
    try:
        t0 = time.perf_counter()
        fut = target.submit_retrying(np.zeros((8, 8), np.uint8), 1,
                                     give_up_after_s=300.0)
        with pytest.raises(ServerClosed, match="draining"):
            fut.result(timeout=60)
        assert time.perf_counter() - t0 < 30
    finally:
        target.close()


def test_serve_cli_http_mode(fe, capsys):
    from tpu_stencil_torch.serve import cli as serve_cli

    rc = serve_cli.main([
        "--http", fe.url, "--requests", "4", "--concurrency", "2",
        "--reps", "1", "--shapes", "10x12", "--channels", "3",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 4/4" in out and "http" in out


def test_http_target_maps_429_to_queue_full(make_fe, rng):
    from tpu_stencil_torch.serve import loadgen
    from tpu_stencil_torch.serve.engine import QueueFull

    frontend = make_fe(start_workers=False, max_queue=1, warm_fleet=False)
    target = loadgen.HttpTarget(frontend.url)
    try:
        img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        f1 = target.submit(img, 1)
        f2 = target.submit(img, 1)
        assert _wait_for(
            lambda: sum(frontend.router.outstanding().values()) == 2)
        f3 = target.submit(img, 1)
        with pytest.raises(QueueFull):
            f3.result(timeout=60)
        frontend.fleet.start_workers()
        for f in (f1, f2):
            np.testing.assert_array_equal(f.result(timeout=300),
                                          _golden(img, 1))
    finally:
        target.close()


def test_http_target_permanent_error_fails_fast(fe, rng):
    from tpu_stencil_torch.serve import loadgen

    target = loadgen.HttpTarget(fe.url + "/wrong-base")
    try:
        img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        t0 = time.perf_counter()
        fut = target.submit_retrying(img, 1, give_up_after_s=300.0)
        with pytest.raises(ValueError, match="HTTP 404"):
            fut.result(timeout=60)
        assert time.perf_counter() - t0 < 30
    finally:
        target.close()


# -- the CLI end to end: SIGTERM drain, warm-from, register ------------


class _StubFed(http.server.BaseHTTPRequestHandler):
    """A federation router stand-in: records ``POST /admin/register``."""

    seen = []

    def do_POST(self):  # noqa: N802 (stdlib handler contract)
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        type(self).seen.append((self.path.split("?")[0], q.get("url")))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def stub_fed():
    _StubFed.seen = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _StubFed)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", _StubFed.seen
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def test_register_posts_the_advertised_url_to_the_fed(stub_fed):
    from tpu_stencil_torch.net import cli as net_cli

    url, seen = stub_fed
    net_cli._register_with_fed(url, "http://10.0.0.7:8080")
    assert _wait_for(lambda: bool(seen), 30)
    assert seen == [("/admin/register", ["http://10.0.0.7:8080"])]


def test_admin_warmstate_answers_an_unsupported_envelope(fe, rng,
                                                        monkeypatch):
    from tpu_stencil_torch.ctrl import warmstart

    # A warm host answers its program-cache keys: keys, never binaries.
    assert _post(fe.url, _img(rng), REPS)[0] == 200
    status, body = _get(fe.url, "/admin/warmstate")
    assert status == 200
    doc = json.loads(body)
    assert doc["schema_version"] == 1 and doc["platform"] == "cpu"
    assert doc["entries"] and "unsupported" not in doc
    assert all(set(e) == {"key"} for e in doc["entries"])
    # An exporter whose kernel sources cannot be read ships nothing and
    # says why.
    monkeypatch.setattr(warmstart, "_kernel_fingerprint", lambda: None)
    status, body = _get(fe.url, "/admin/warmstate")
    assert status == 200
    doc = json.loads(body)
    assert doc["schema_version"] == 1 and doc["entries"] == []
    assert "kernel sources" in doc["unsupported"]


def test_warm_from_degrades_every_replica_to_cold_counted(fe, capsys,
                                                          monkeypatch):
    from tpu_stencil_torch.ctrl import warmstart
    from tpu_stencil_torch.net import NetFrontend
    from tpu_stencil_torch.net import cli as net_cli

    # The warm host cannot read its kernel sources: its envelope is the
    # unsupported one, and every replica of the joiner starts cold.
    monkeypatch.setattr(warmstart, "_kernel_fingerprint", lambda: None)
    joiner = NetFrontend(NetConfig(port=0, replicas=2, bucket_edges=EDGES,
                                   prof_dir=None), devices=[CPU] * 2)
    try:
        net_cli._pull_warm_state(joiner, fe.url)
        joiner.start()
        out = capsys.readouterr().out
        assert "imported 0 artifact(s), 2 fallback(s)" in out
        merged = joiner.fleet.merged_counters()
        assert merged["ctrl_warmstart_fallbacks_total"] == 2
        for rep in joiner.fleet.replicas:
            assert rep.stats()["counters"][
                "ctrl_warmstart_fallbacks_total"] == 1
        # An unreachable host is a cold start as well, never fatal.
        again = joiner.fleet.warmstate_import(None)
        assert again["fallbacks"] == 2
        # The JAX importer's typed reasons, one fallback each.
        rep = joiner.fleet.replicas[0]
        assert rep.import_warm_state({"schema_version": 2})["reasons"] == {
            "schema_mismatch": 1}
        assert rep.import_warm_state(json.loads(_get(
            fe.url, "/admin/warmstate")[1]))["reasons"] == {
            "exporter_unsupported": 1}
    finally:
        joiner.close()


def test_cli_sigterm_graceful_drain_subprocess(rng, fe, stub_fed, tmp_path):
    # The acceptance criterion as a black box: a real `python -m
    # tpu_stencil_torch net` process (warm-started from the module tier,
    # registering with a stub federation router) accepts a slow request;
    # SIGTERM flips /healthz to draining and stops admission; the
    # accepted request still completes; the process exits 0 reporting a
    # clean drain.
    fed_url, seen = stub_fed
    # One intra-op thread: the slow request must not take every core
    # from the suite's other workers.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_stencil_torch", "net", "--port", "0",
         "--replicas", "2", "--platform", "cpu", "--drain-timeout", "60",
         "--warm-from", fe.url, "--register", fed_url,
         "--flightrec-dir", str(tmp_path / "fr"),
         "--prof-dir", str(tmp_path / "prof")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env=env)
    try:
        line = proc.stdout.readline()
        # Every key the module tier holds, rebuilt in each of 2 replicas.
        imported = re.search(
            r"warm-start imported (\d+) artifact\(s\), 0 fallback\(s\)",
            line)
        assert imported, line
        n = int(imported.group(1))
        assert n >= 2 and n % 2 == 0, line
        line = proc.stdout.readline()
        assert "net: serving on http://" in line, line
        assert "2 replica(s)" in line and "devices=cpu,cpu" in line
        url = line.split()[3]
        assert _wait_for(lambda: bool(seen), 60)
        assert seen[0] == ("/admin/register", [url])
        img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
        status, body, _ = _post(url, img, 1, http_timeout=300)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 1))
        slow = rng.integers(0, 256, (256, 256), dtype=np.uint8)
        result = {}

        def client():
            result["r"] = _post(url, slow, 8000, http_timeout=300)

        t = threading.Thread(target=client, daemon=True)
        t.start()

        def admitted():
            st = json.loads(_get(url, "/statusz")[1])
            return sum(st["outstanding"].values()) >= 1

        # The slow request is admitted and computing before the signal (a
        # request the drain gate refuses answers 503, not this contract).
        assert _wait_for(admitted, 120)
        proc.send_signal(signal.SIGTERM)
        saw_draining = False
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            try:
                status, body = _get(url, "/healthz", http_timeout=5)
            except (ConnectionError, OSError):
                break
            if status == 503 and b"draining" in body:
                saw_draining = True
                break
            time.sleep(0.05)
        assert saw_draining, "healthz never flipped to draining"
        t.join(timeout=300)
        status, body, _ = result["r"]
        assert status == 200, f"accepted request died in drain: {status}"
        assert len(body) == slow.size
        rc = proc.wait(timeout=120)
        out = proc.stdout.read()
        assert rc == 0, (out, proc.stderr.read()[-2000:])
        assert "drained 2 replica(s) cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()


# -- continuous batching + zero-copy ingest ----------------------------


@pytest.fixture(scope="module")
def cfe():
    """A coalescing tier: a 10 s window that in practice never expires,
    so groups dispatch when FULL (max_batch=4) or when a member's
    deadline falls inside the window."""
    frontend = _new_frontend(max_batch=4, coalesce_window_us=10_000_000.0)
    yield frontend
    frontend.close()


def _post_many(url, imgs, reps, extra_headers=None, timeout_s=None):
    results = [None] * len(imgs)

    def work(i):
        h, w = imgs[i].shape[:2]
        channels = imgs[i].shape[2] if imgs[i].ndim == 3 else 1
        headers = {"X-Width": str(w), "X-Height": str(h),
                   "X-Reps": str(reps), "X-Channels": str(channels)}
        if timeout_s is not None:
            headers["X-Request-Timeout"] = repr(timeout_s)
        if extra_headers:
            headers.update(extra_headers[i])
        req = urllib.request.Request(url + "/v1/blur",
                                     data=imgs[i].tobytes(),
                                     headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, r.read(), dict(r.headers))
        except urllib.error.HTTPError as e:
            results[i] = (e.code, e.read(), dict(e.headers))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


def test_netconfig_coalesce_validation():
    with pytest.raises(ValueError, match="coalesce_window_us"):
        NetConfig(coalesce_window_us=-1.0)
    assert NetConfig(coalesce_window_us=250.0).coalesce_window_s == \
        pytest.approx(250e-6)
    assert NetConfig().coalesce_window_us == 0.0
    assert NetConfig().ingest_arena is True


def test_net_cli_coalesce_flags():
    from tpu_stencil_torch.net import cli as net_cli

    ns = net_cli.build_parser().parse_args([])
    assert ns.coalesce_window_us == 300.0
    assert ns.ingest_arena is True
    ns = net_cli.build_parser().parse_args(
        ["--coalesce-window-us", "0", "--no-ingest-arena"])
    assert ns.coalesce_window_us == 0.0
    assert ns.ingest_arena is False


def test_coalesced_group_bit_exact_fuzz(cfe, rng):
    for shape, reps in (((20, 30, 3), 3), ((17, 23), 2),
                        ((20, 30, 3), 0)):
        imgs = [rng.integers(0, 256, shape, dtype=np.uint8)
                for _ in range(4)]
        c0 = cfe.metrics_snapshot()["counters"]
        results = _post_many(cfe.url, imgs, reps)
        for img, (status, body, headers) in zip(imgs, results):
            assert status == 200, body
            np.testing.assert_array_equal(
                np.frombuffer(body, np.uint8).reshape(img.shape),
                _golden(img, reps))
            assert int(headers["X-Replica"]) >= 0
        c1 = cfe.metrics_snapshot()["counters"]
        assert (c1["coalesced_requests_total"]
                - c0.get("coalesced_requests_total", 0)) == 4
        assert (c1["coalesced_batches_total"]
                - c0.get("coalesced_batches_total", 0)) == 1


def test_coalesced_two_groups_race_across_replicas(cfe, rng):
    imgs = [rng.integers(0, 256, (12, 19, 3), dtype=np.uint8)
            for _ in range(8)]
    c0 = cfe.metrics_snapshot()["counters"]
    results = _post_many(cfe.url, imgs, 2)
    for img, (status, body, _h) in zip(imgs, results):
        assert status == 200, body
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 2))
    c1 = cfe.metrics_snapshot()["counters"]
    assert (c1["coalesced_batches_total"]
            - c0.get("coalesced_batches_total", 0)) == 2
    assert (c1["coalesced_requests_total"]
            - c0.get("coalesced_requests_total", 0)) == 8


def test_coalesce_deadline_inside_window_dispatches_early(cfe, rng):
    img = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    t0 = time.perf_counter()
    status, body, _ = _post(cfe.url, img, 2, timeout_s=2.0)
    elapsed = time.perf_counter() - t0
    assert status == 200, body
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))
    # Not stretched to the 10 s window (a bound, not a speed claim).
    assert elapsed < 8.0


def test_coalesce_trace_id_per_member(cfe, rng):
    from tpu_stencil_torch.obs import context as obs_ctx

    imgs = [rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
            for _ in range(4)]
    tids = [obs_ctx.new_trace_id() for _ in imgs]
    extra = [{obs_ctx.TRACE_HEADER: t,
              obs_ctx.SPAN_HEADER: obs_ctx.new_span_id()} for t in tids]
    results = _post_many(cfe.url, imgs, 1, extra_headers=extra)
    for tid, (status, _body, headers) in zip(tids, results):
        assert status == 200
        assert headers[obs_ctx.TRACE_HEADER] == tid


def test_coalesced_drain_flushes_forming_groups(make_fe, rng):
    frontend = make_fe(replicas=1, max_batch=8,
                       coalesce_window_us=30_000_000.0)
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    result = {}

    def post():
        result["r"] = _post(frontend.url, img, 1)

    t = threading.Thread(target=post)
    t.start()
    # Admitted: its bytes are reserved while it sits in the forming group.
    assert _wait_for(lambda: frontend.router._inflight_bytes > 0, 30)
    frontend.drain(timeout_s=30)
    t.join(timeout=60)
    status, body, _ = result["r"]
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 1))


def test_ingest_arena_reuses_and_never_cross_contaminates(fe, rng):
    c0 = fe.metrics_snapshot()["counters"]
    for _ in range(3):
        img = rng.integers(0, 256, (21, 29, 3), dtype=np.uint8)
        status, body, _ = _post(fe.url, img, 2)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 2))
    imgs = [rng.integers(0, 256, (21, 29, 3), dtype=np.uint8)
            for _ in range(4)]
    for img, (status, body, _h) in zip(imgs, _post_many(fe.url, imgs, 1)):
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 1))
    c1 = fe.metrics_snapshot()["counters"]
    assert (c1["arena_ingest_reuse_total"]
            - c0.get("arena_ingest_reuse_total", 0)) >= 2


def test_released_lease_rewritten_in_flight_leaves_results_exact(
        make_fe, rng, monkeypatch):
    # The owned-buffer contract: the engine releases the arena buffer once
    # its worker copied the frame into the batch canvas, before the
    # compute. Rewriting every buffer the moment it is released, while its
    # request is still outstanding, must not change any result: nothing
    # reads the arena buffer after on_consumed.
    from tpu_stencil_torch.net import arena

    frontend = make_fe(replicas=1, warm_fleet=False)
    released = []
    orig = arena.Lease.release

    def release_and_scribble(self):
        if not self._released:
            released.append(sum(frontend.router.outstanding().values()))
            self.array[:] = 0xA5  # the buffer reused by another upload
        orig(self)

    monkeypatch.setattr(arena.Lease, "release", release_and_scribble)
    imgs = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
            for _ in range(6)]
    for img, (status, body, _h) in zip(imgs,
                                       _post_many(frontend.url, imgs, 4)):
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 4))
    assert len(released) == 6
    # Every release came while its request was still in flight.
    assert min(released) >= 1


def test_ingest_arena_overlong_body_400_on_bucket_exact_frame(fe, rng):
    img = rng.integers(0, 256, (16, 16), dtype=np.uint8)  # 16 = an edge
    req = urllib.request.Request(
        fe.url + "/v1/blur?w=16&h=16&reps=1&channels=1",
        data=img.tobytes() + b"xx", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status = r.status
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 400


def test_ingest_arena_off_still_exact(make_fe, rng):
    frontend = make_fe(replicas=1, ingest_arena=False)
    img = rng.integers(0, 256, (14, 22, 3), dtype=np.uint8)
    status, body, _ = _post(frontend.url, img, 2)
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))
    assert "arena_ingest_reuse_total" not in (
        frontend.metrics_snapshot()["counters"])


def test_chunked_upload_into_arena_bit_exact(fe, rng):
    img = rng.integers(0, 256, (33, 21, 3), dtype=np.uint8)
    c0 = fe.metrics_snapshot()["counters"]
    status, body = _chunked_post(fe.port, img, 2)
    assert status == 200, body
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), _golden(img, 2))
    c1 = fe.metrics_snapshot()["counters"]
    assert (c1["arena_ingest_reuse_total"] + c1["arena_ingest_alloc_total"]
            > c0["arena_ingest_reuse_total"]
            + c0["arena_ingest_alloc_total"])


def test_retry_after_derived_from_queue_state(make_fe):
    from tpu_stencil_torch.net import router as router_mod

    frontend = make_fe(replicas=1, coalesce_window_us=2_000_000.0)
    r = frontend.router
    assert r.retry_after_s() >= router_mod.RETRY_AFTER_SHED
    idle = r.retry_after_s()
    for _ in range(8):
        frontend.registry.histogram("request_latency_seconds").observe(2.0)
        r._m_coal_delay.observe(1.5)
    r._outstanding[0] = 64
    loaded = r.retry_after_s()
    assert loaded > idle
    assert loaded <= router_mod.RETRY_AFTER_CAP
    r._outstanding[0] = 0
    assert r.retry_after_s(queue_full=True) >= \
        router_mod.RETRY_AFTER_QUEUE_FULL


def test_http_loadgen_burst_coalesces(cfe):
    from tpu_stencil_torch.serve import loadgen

    c0 = cfe.metrics_snapshot()["counters"]
    target = loadgen.HttpTarget(cfe.url)
    try:
        report = loadgen.run(
            target, mode="open", requests=8, rate=10_000.0, burst=4,
            reps=1, shapes=((12, 16), (18, 14)), channels=(1, 3),
            seed=3, timeout=300)
    finally:
        target.close()
    assert report["completed"] == 8
    assert report["burst"] == 4
    assert report["p50_s"] >= 0.0 and report["p99_s"] >= report["p50_s"]
    c1 = cfe.metrics_snapshot()["counters"]
    assert (c1["coalesced_requests_total"]
            - c0.get("coalesced_requests_total", 0)) == 8
    assert (c1["coalesced_batches_total"]
            - c0.get("coalesced_batches_total", 0)) == 2


def test_coalescing_stacks_each_burst_into_one_launch(make_fe, rng):
    # The JAX package's "coalescing beats one request per launch", by
    # count, not by time: bursts of 8 concurrent same-bucket requests to
    # one replica. Coalescing on, each full burst is one submit_group and
    # one engine batch, one program run; off, every request enters the
    # engine by its own submit. Every result exact.
    img = rng.integers(0, 256, (48, 32, 3), dtype=np.uint8)
    want = _golden(img, 5)
    k, rounds = 8, 3

    def run(window_us):
        frontend = make_fe(replicas=1, max_queue=64, max_batch=8,
                           coalesce_window_us=window_us)
        results = []
        for _ in range(rounds):
            results += _post_many(frontend.url, [img] * k, 5)
        for status, body, _h in results:
            assert status == 200
            np.testing.assert_array_equal(
                np.frombuffer(body, np.uint8).reshape(img.shape), want)
        return frontend.metrics_snapshot()["counters"]

    # A 10 s window never expires here: a group leaves only when full
    # (max_batch 8), however slowly the burst's posts arrive.
    on = run(10_000_000.0)
    assert on["coalesced_batches_total"] == rounds
    assert on["coalesced_requests_total"] == rounds * k
    assert on["fleet_batches_total"] == rounds
    off = run(0.0)
    assert off.get("coalesced_batches_total", 0) == 0
    assert off["requests_total"] == off["fleet_requests_total"] == rounds * k
    assert rounds <= off["fleet_batches_total"] <= rounds * k


# -- integrity at the edge ---------------------------------------------


def _blur_url(fe, w=W, h=H, reps=REPS, c=C):
    return fe.url + f"/v1/blur?w={w}&h={h}&reps={reps}&channels={c}"


def _raw_post(url, body, headers=None, timeout=300):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), r.headers


def _http_error(url, body, headers=None):
    try:
        _raw_post(url, body, headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    raise AssertionError("expected an HTTP error")


def _inet(make_fe, **kw):
    kw.setdefault("witness_rate", 0.0)
    kw.setdefault("probe_interval_s", 0.0)
    kw.setdefault("bucket_edges", None)
    return make_fe(**kw)


def test_net_request_crc_validated_and_result_stamped(make_fe):
    img = _img()
    body = img.tobytes()
    fe = _inet(make_fe)
    out, headers = _raw_post(_blur_url(fe), body, {
        checksum.CRC_HEADER: str(checksum.crc32c(body))})
    assert out == _golden(img, REPS).tobytes()
    assert int(headers[checksum.RESULT_HEADER]) == checksum.crc32c(out)
    code, detail = _http_error(_blur_url(fe), body,
                               {checksum.CRC_HEADER: "12345"})
    assert code == 400 and "ChecksumMismatch" in detail
    code, detail = _http_error(_blur_url(fe), body,
                               {checksum.CRC_HEADER: "not-a-crc"})
    assert code == 400 and "malformed" in detail
    snap = fe.metrics_snapshot()
    assert snap["counters"]["integrity_checksum_failures_total"] == 1


def test_net_claim_check_uses_the_native_crc_on_big_bodies(make_fe):
    # A body of 4 KiB or more is checked through the port's C++ CRC32C
    # (checksum.crc32c routes it there); its value is the table's.
    img = _img(shape=(64, 48, 3))
    body = img.tobytes()
    assert len(body) >= checksum.NATIVE_MIN_BYTES
    assert checksum.native_crc32c(body) == checksum._crc32c_py(body)
    assert checksum.claim_error(str(checksum.crc32c(body)), body) is None
    msg, mismatch = checksum.claim_error("1", body)
    assert mismatch and "ChecksumMismatch" in msg
    msg, mismatch = checksum.claim_error("x", body)
    assert not mismatch and "malformed" in msg
    fe = _inet(make_fe, replicas=1)
    out, _ = _raw_post(_blur_url(fe, w=48, h=64), body, {
        checksum.CRC_HEADER: str(checksum.crc32c(body))})
    assert out == _golden(img, REPS).tobytes()


def test_net_no_integrity_disables_the_layer(make_fe):
    img = _img()
    body = img.tobytes()
    fe = _inet(make_fe, integrity=False)
    out, headers = _raw_post(_blur_url(fe), body,
                             {checksum.CRC_HEADER: "12345"})
    assert out == _golden(img, REPS).tobytes()
    assert checksum.RESULT_HEADER not in headers
    assert all(r.cfg.witness_rate == 0.0 for r in fe.fleet.replicas)


@pytest.mark.chaos
def test_net_corrupt_ingest_dies_typed_with_client_crc(make_fe):
    img = _img()
    body = img.tobytes()
    faults.configure("integrity.corrupt_ingest")
    fe = _inet(make_fe)
    code, detail = _http_error(_blur_url(fe), body, {
        checksum.CRC_HEADER: str(checksum.crc32c(body))})
    assert code == 400 and "ChecksumMismatch" in detail


@pytest.mark.chaos
def test_net_corrupt_body_detected_by_client_verify(make_fe):
    img = _img()
    body = img.tobytes()
    faults.configure("net.corrupt_body")
    fe = _inet(make_fe)
    out, headers = _raw_post(_blur_url(fe), body)
    assert checksum.crc32c(out) != int(headers[checksum.RESULT_HEADER])
    assert out != _golden(img, REPS).tobytes()


def test_net_admin_quarantine_routes_around_replica(make_fe):
    img = _img()
    body = img.tobytes()
    fe = _inet(make_fe)
    out, _ = _raw_post(fe.url + "/admin/quarantine?replica=0", b"")
    j = json.loads(out)
    assert j["quarantined"] is True and j["changed"] is True
    for _ in range(3):
        _, headers = _raw_post(_blur_url(fe), body)
        assert headers["X-Replica"] == "1"
    status = json.loads(_get(fe.url, "/statusz")[1])
    assert status["quarantine"]["quarantined"] == {
        "0": "operator request (POST /admin/quarantine)"}
    text = _get(fe.url, "/metrics")[1].decode()
    assert "tpu_stencil_net_integrity_quarantines_total 1" in text
    assert "tpu_stencil_net_replica_quarantined_dev0 1" in text
    out, _ = _raw_post(
        fe.url + "/admin/quarantine?replica=0&action=clear", b"")
    assert json.loads(out)["quarantined"] is False
    code, _ = _http_error(fe.url + "/admin/quarantine?replica=9", b"")
    assert code == 400


def test_net_all_replicas_quarantined_rejects_typed(make_fe):
    img = _img()
    fe = _inet(make_fe)
    for i in (0, 1):
        fe.router.quarantine_replica(i, "test")
    code, detail = _http_error(_blur_url(fe), img.tobytes())
    assert code == 503 and "quarantined" in detail
    snap = fe.metrics_snapshot()
    assert snap["counters"]["quarantine_unroutable_total"] == 1


@pytest.mark.chaos
def test_net_quarantine_full_cycle(make_fe):
    img = _img()
    body = img.tobytes()
    want = _golden(img, REPS).tobytes()
    faults.configure("integrity.corrupt_result:times=3")
    fe = _inet(make_fe, witness_rate=1.0, warm_fleet=False,
               quarantine_after=3, readmit_after=2, probe_interval_s=0.05)
    for _ in range(3):
        out, headers = _raw_post(_blur_url(fe), body)
        assert headers["X-Replica"] == "0"
        assert out != want
    assert _wait_for(lambda: fe.quarantine.is_quarantined(0))
    out, headers = _raw_post(_blur_url(fe), body)
    assert headers["X-Replica"] == "1" and out == want
    assert _wait_for(lambda: not fe.quarantine.is_quarantined(0), 60)
    snap = fe.metrics_snapshot()
    assert snap["counters"]["integrity_quarantines_total"] == 1
    assert snap["counters"]["integrity_readmits_total"] == 1
    assert snap["counters"]["integrity_probes_total"] >= 2
    assert snap["counters"]["fleet_integrity_witness_mismatch_total"] >= 3
    for _ in range(4):
        out, headers = _raw_post(_blur_url(fe), body)
        assert out == want


def test_net_statusz_reports_integrity_config(make_fe):
    fe = _inet(make_fe, witness_rate=0.25)
    cfgz = json.loads(_get(fe.url, "/statusz")[1])["config"]
    assert cfgz["integrity"] is True
    assert cfgz["witness_rate"] == 0.25


@pytest.mark.chaos
def test_loadgen_http_verify_crc_counts_wire_corruption(make_fe):
    from tpu_stencil_torch.serve import loadgen

    faults.configure("net.corrupt_body:times=0:p=1.0")
    fe = _inet(make_fe)
    target = loadgen.HttpTarget(fe.url, verify="crc")
    try:
        report = loadgen.run(target, mode="open", requests=4, rate=50.0,
                             reps=2, verify="crc")
    finally:
        target.close()
    assert report["verify_failures_total"] == 4


def test_loadgen_http_verify_crc_clean(make_fe):
    from tpu_stencil_torch.serve import loadgen

    fe = _inet(make_fe)
    target = loadgen.HttpTarget(fe.url, verify="crc")
    try:
        report = loadgen.run(target, requests=4, concurrency=2, reps=2,
                             verify="crc")
    finally:
        target.close()
    assert report["verify_failures_total"] == 0
    assert report["completed"] == 4


def test_kernel_build_failure_answers_a_typed_500_without_fallback(
        make_fe, rng, monkeypatch):
    # A K1 that cannot be built: the request fails with a 500 naming
    # KernelBuildError; neither torch-ops path (padded_step, iterate) is
    # called in its place.
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    calls = []

    def refuse(*a, **k):
        raise _build.KernelBuildError("stencil_fused: nvcc exited 1")

    monkeypatch.setattr(cs, "stencil_fused", refuse)
    monkeypatch.setattr(lowering, "padded_step",
                        lambda *a, **k: calls.append("padded_step"))
    monkeypatch.setattr(lowering, "iterate",
                        lambda *a, **k: calls.append("iterate"))
    fe = make_fe(replicas=1, backend="pallas", witness_rate=0.0)
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    status, body, _ = _post(fe.url, img, 3)
    assert status == 500
    assert json.loads(body)["error"].startswith("KernelBuildError")
    assert calls == []
    assert fe.fleet.merged_counters()["failed_total"] == 1


def test_http_tax_tool_rehearses_on_the_cpu(tmp_path, capsys, monkeypatch):
    # The measuring tool behind PERF.md's HTTP-tax table: on the CPU a
    # rehearsal (its numbers mean nothing); every variant's load completes
    # and the JSON names the device it ran on.
    from tpu_stencil_torch.tools import http_tax

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the net process it starts
    out = tmp_path / "tax.json"
    assert http_tax.main([
        "--platform", "cpu", "--requests", "4", "--concurrency", "2",
        "--shape", "16x12", "--reps", "2", "--runs", "1",
        "--variants", "in_process,http,http_reps0", "--json", str(out),
    ]) == 0
    doc = json.loads(out.read_text())
    assert doc["device"].startswith("cpu")
    assert set(doc["variants"]) == {"in_process", "http", "http_reps0"}
    for runs in doc["variants"].values():
        assert [r["completed"] for r in runs] == [4]
    with pytest.raises(SystemExit) as exc:
        http_tax.main(["--platform", "cpu", "--variants", "nope"])
    assert exc.value.code == 2
