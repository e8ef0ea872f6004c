"""The port's federation front-router tier against the JAX package's
contract, on the CPU, through real sockets on port 0.

Mirrors ``tests/test_fed.py`` test for test (all but the slow-marked
``test_bench_fed_capture_subprocess``, which drives the JAX package's
``bench.py``), the fed cases of ``tests/test_integrity.py`` and
``test_fed_timeseries_merge_survives_kill9_member`` of
``tests/test_telemetry.py``:

* a federated round trip is byte-identical to the port's
  ``driver.run_job`` and the JAX package's NumPy golden model;
* kill -9 of a member under concurrent load: every request completes or
  fails with a typed status, the breaker opens, the member is evicted,
  and both show in ``/metrics`` and ``/statusz`` while survivors serve;
* a rolling drain of every member completes every accepted request
  (member processes exit rc 0);
* per-tenant quotas reject the hot tenant typed (429 + Retry-After);
  premium tenants keep headroom past the shed watermark;
* the ``net.accept`` / ``net.body`` / ``net.corrupt_body`` chaos sites
  produce the socket-level failures the verdict classifier is built for;
* clients honor Retry-After as the re-offer backoff floor.

Every member runs on ``devices=[cpu]`` (in process) or ``--platform
cpu`` (a subprocess); nothing here times a request: the tests wait on
counters and events. Frontends and processes are closed or killed in
``finally`` blocks with timeouts.
"""

import http.client
import json
import os
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
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil_torch.config import FedConfig, NetConfig
from tpu_stencil_torch.integrity import checksum
from tpu_stencil_torch.obs import flight as oflight
from tpu_stencil_torch.resilience import faults

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
EDGES = (8, 16, 32, 64)


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path / "flightrec"))
    faults.clear()
    yield
    faults.clear()


def _golden(img, reps, name="gaussian"):
    return jstencil.reference_stencil_numpy(img, jfilters.get_filter(name),
                                            reps)


def _post(url, img, reps, *, filter_name=None, tenant=None,
          http_timeout=300.0, headers=None):
    """POST one frame; returns (status, body_bytes, headers) with the
    headers case-insensitive (the fed passes member headers through in
    ``str.title`` form)."""
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    hdr = {"X-Width": str(w), "X-Height": str(h),
           "X-Reps": str(reps), "X-Channels": str(channels)}
    if filter_name:
        hdr["X-Filter"] = filter_name
    if tenant:
        hdr["X-Tenant"] = tenant
    hdr.update(headers or {})
    req = urllib.request.Request(url + "/v1/blur", data=img.tobytes(),
                                 headers=hdr, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=http_timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _get(url, path, http_timeout=60.0):
    try:
        with urllib.request.urlopen(url + path, timeout=http_timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_admin(url, path, http_timeout=60.0):
    req = urllib.request.Request(url + path, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=http_timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _make_member(**overrides):
    from tpu_stencil_torch.net import NetFrontend

    kw = dict(port=0, replicas=1, bucket_edges=EDGES, max_queue=64,
              prof_dir=None)
    start_workers = overrides.pop("start_workers", True)
    kw.update(overrides)
    return NetFrontend(NetConfig(**kw), start_workers=start_workers,
                       devices=[CPU] * kw["replicas"]).start()


def _make_fed(members, **overrides):
    from tpu_stencil_torch.fed import FedFrontend

    kw = dict(port=0, members=tuple(m.url for m in members),
              heartbeat_interval_s=10.0)  # tests drive beats explicitly
    kw.update(overrides)
    return FedFrontend(FedConfig(**kw)).start()


def _wait_for(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    assert pred(), f"timed out waiting for {what}"


# -- config / CLI validation -------------------------------------------


def test_fedconfig_validation():
    with pytest.raises(ValueError, match="port"):
        FedConfig(port=70000)
    with pytest.raises(ValueError, match="member URL"):
        FedConfig(members=("localhost:8080",))
    with pytest.raises(ValueError, match="heartbeat_interval_s"):
        FedConfig(heartbeat_interval_s=0)
    with pytest.raises(ValueError, match="suspect_after"):
        FedConfig(suspect_after=0)
    with pytest.raises(ValueError, match="evict_after"):
        FedConfig(suspect_after=3, evict_after=2)
    with pytest.raises(ValueError, match="breaker_threshold"):
        FedConfig(breaker_threshold=0)
    with pytest.raises(ValueError, match="breaker_cooldown_s"):
        FedConfig(breaker_cooldown_s=0)
    with pytest.raises(ValueError, match="forward_timeout_s"):
        FedConfig(forward_timeout_s=0)
    with pytest.raises(ValueError, match="reoffer_s"):
        FedConfig(reoffer_s=-1)
    with pytest.raises(ValueError, match="tenant_quota"):
        FedConfig(tenant_quota=0)
    with pytest.raises(ValueError, match="premium_quota_factor"):
        FedConfig(premium_quota_factor=0)
    with pytest.raises(ValueError, match="drain_timeout_s"):
        FedConfig(drain_timeout_s=0)
    cfg = FedConfig(members=("http://h1:1", "http://h2:2"),
                    max_inflight_mb=1.5)
    assert cfg.max_inflight_bytes == 3 << 19
    assert cfg.members == ("http://h1:1", "http://h2:2")


@pytest.mark.parametrize("kw", [
    dict(port=70000), dict(members=("localhost:8080",)),
    dict(heartbeat_interval_s=0), dict(suspect_after=3, evict_after=2),
    dict(breaker_cooldown_s=0), dict(hedge_min_s=-1),
    dict(max_inflight_mb=-1), dict(flight_latency_threshold_s=-1),
    dict(slo_error_budget=2.0), dict(sample_interval_s=-1),
], ids=lambda kw: ",".join(kw))
def test_fedconfig_refusals_equal_the_jax_package(kw):
    from tpu_stencil.config import FedConfig as JFedConfig

    with pytest.raises(ValueError) as want:
        JFedConfig(**kw)
    with pytest.raises(ValueError) as got:
        FedConfig(**kw)
    assert str(got.value) == str(want.value)


def test_fed_cli_rejects_bad_flags():
    from tpu_stencil_torch.fed import cli as fed_cli

    for argv in (["--port", "70000"],
                 ["--member", "nohost:1"],
                 ["--heartbeat-interval", "0"],
                 ["--evict-after", "1", "--suspect-after", "2"],
                 ["--breaker-threshold", "0"],
                 ["--tenant-quota", "0"],
                 ["--drain-timeout", "0"]):
        with pytest.raises(SystemExit) as exc:
            fed_cli.main(argv)
        assert exc.value.code == 2, argv


def test_fed_cli_takes_the_jax_clis_flags():
    from tpu_stencil.fed import cli as jcli
    from tpu_stencil_torch.fed import cli as pcli

    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings)

    assert flags(pcli.build_parser()) == flags(jcli.build_parser())


def test_host_id_is_metric_safe():
    from tpu_stencil_torch.fed import host_id_for

    hid = host_id_for("http://127.0.0.1:8080/")
    assert hid == "127_0_0_1_8080"
    assert hid.replace("_", "").isalnum()


# -- breaker unit ------------------------------------------------------


def test_breaker_lifecycle(monkeypatch):
    from tpu_stencil_torch.fed import breaker as breaker_mod
    from tpu_stencil_torch.fed.breaker import (
        CLOSED,
        HALF_OPEN,
        OPEN,
        Breaker,
    )

    # The breaker's clock, moved by hand: cooldowns pass without a sleep.
    now = [100.0]
    monkeypatch.setattr(breaker_mod.time, "monotonic", lambda: now[0])
    b = Breaker(threshold=2, cooldown_s=0.1)
    assert b.state == CLOSED and b.allow()
    b.record_failure()
    assert b.state == CLOSED and b.allow()  # one failure: still closed
    b.record_failure()
    assert b.state == OPEN
    assert not b.allow()  # open, cooldown not elapsed
    now[0] += 0.12
    assert b.allow()  # the half-open probe slot
    assert b.state == HALF_OPEN
    assert not b.allow()  # one probe at a time
    b.record_failure()  # the probe died: re-open
    assert b.state == OPEN
    now[0] += 0.12
    assert b.allow()
    assert b.record_success() is True  # probe landed: breaker closes
    assert b.state == CLOSED and b.allow()
    # A cancelled probe releases its slot without judging the host.
    b.record_failure(), b.record_failure()
    now[0] += 0.12
    assert b.allow() and not b.allow()
    b.release_probe()
    assert b.allow()  # slot free again, still half-open evidence-less


def test_verdict_classification():
    import socket

    from tpu_stencil_torch.fed.router import _verdict_exc
    from tpu_stencil_torch.resilience.errors import InjectedFault

    assert _verdict_exc(ConnectionRefusedError()) == "connect"
    assert _verdict_exc(socket.timeout()) == "timeout"
    assert _verdict_exc(TimeoutError()) == "timeout"
    assert _verdict_exc(
        http.client.IncompleteRead(b"partial")
    ) == "eof"
    assert _verdict_exc(ConnectionResetError()) == "reset"
    assert _verdict_exc(
        http.client.RemoteDisconnected("gone")
    ) == "reset"
    assert _verdict_exc(OSError("no route")) == "connect"
    assert _verdict_exc(InjectedFault("chaos")) == "injected"
    assert _verdict_exc(RuntimeError("??")) == "error"


def test_host_unavailable_classifies_transient():
    from tpu_stencil_torch.resilience import HostUnavailable as exported
    from tpu_stencil_torch.resilience import retry
    from tpu_stencil_torch.resilience.errors import HostUnavailable

    assert exported is HostUnavailable
    e = HostUnavailable("breaker open", host="h1")
    assert e.host == "h1"
    assert retry.classify(e) == retry.TRANSIENT
    assert HostUnavailable("no member").host is None


def test_new_fault_points_registered():
    for point in ("net.accept", "net.body", "fed.heartbeat",
                  "fed.forward", "fed.hedge"):
        assert point in faults.POINTS
        assert faults.site(point) is None  # unarmed: zero-overhead


def test_retry_after_floor_honored(monkeypatch):
    # An exception carrying the server's Retry-After hint floors the
    # backoff sleep, counted in resilience_retry_after_honored_total.
    from tpu_stencil_torch import obs
    from tpu_stencil_torch.resilience import retry
    from tpu_stencil_torch.serve.engine import QueueFull

    pauses = []

    class _Clock:
        @staticmethod
        def sleep(s):
            pauses.append(s)

    monkeypatch.setattr(retry, "time", _Clock)
    counter = obs.registry().counter(
        "resilience_retry_after_honored_total"
    )
    before = counter.value
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            e = QueueFull("busy")
            e.retry_after_s = 0.3
            raise e
        return "ok"

    assert retry.retry_call(
        flaky,
        policy=retry.RetryPolicy(attempts=3, base_delay=0.001,
                                 max_delay=0.01),
    ) == "ok"
    assert pauses == [0.3]  # floored, not exp-jitter
    assert counter.value == before + 1


# -- the in-process federation -----------------------------------------


@pytest.fixture(scope="module")
def fedpair():
    """Two in-process member hosts behind one federation frontend."""
    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2], reoffer_s=0.2)
    yield fed, m1, m2
    fed.close()
    m1.close()
    m2.close()


def test_fed_round_trip_bit_exact(fedpair, rng, tmp_path):
    # The federated round trip is byte-identical to the port's run_job
    # and the JAX package's golden model.
    from tpu_stencil_torch import driver
    from tpu_stencil_torch.config import ImageType, JobConfig

    fed, _, _ = fedpair
    img = rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)
    src = tmp_path / "frame.raw"
    out = tmp_path / "blur.raw"
    img.tofile(src)
    driver.run_job(JobConfig(
        image=str(src), width=28, height=20, repetitions=4,
        image_type=ImageType.RGB, output=str(out),
    ), device=CPU)
    want = np.fromfile(out, np.uint8).reshape(img.shape)
    np.testing.assert_array_equal(want, _golden(img, 4))
    status, body, headers = _post(fed.url, img, 4)
    assert status == 200
    assert headers["X-Fed-Member"]  # which host computed is visible
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape), want
    )


def test_fed_grey_round_trip_and_filter(fedpair, rng):
    fed, _, _ = fedpair
    img = rng.integers(0, 256, (17, 23), dtype=np.uint8)
    status, body, _ = _post(fed.url, img, 2, filter_name="box")
    assert status == 200
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(img.shape),
        _golden(img, 2, "box"),
    )


def test_fed_member_400_passes_through(fedpair, rng):
    fed, _, _ = fedpair
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    status, body, _ = _post(fed.url, img, 1, filter_name="bogus")
    assert status == 400 and b"unknown filter" in body
    # Fed-side validation is its own 400 (never forwarded).
    req = urllib.request.Request(fed.url + "/v1/blur",
                                 data=img.tobytes(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 400


def test_fed_metrics_fold_and_round_trip(fedpair, rng):
    from tpu_stencil_torch.fed import host_id_for
    from tpu_stencil_torch.obs import exposition

    fed, m1, m2 = fedpair
    img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
    assert _post(fed.url, img, 1)[0] == 200
    status, body = _get(fed.url, "/metrics")
    assert status == 200
    text = body.decode()
    snap = exposition.parse_text(text, prefix="tpu_stencil_fed")
    assert snap["counters"]["requests_total"] >= 1
    assert snap["counters"]["forwarded_total"] >= 1
    # Member scrapes folded under fleet_<host>_, the net tier's replica
    # fold one hop up.
    for m in (m1, m2):
        hid = host_id_for(m.url)
        assert f"fleet_{hid}_requests_total" in snap["counters"]
    assert "forward_latency_seconds" in snap["histograms"]
    assert "request_latency_seconds" in snap["histograms"]
    assert snap["members"] == 2  # scalar rider
    # The exact inverse property every exposition surface guarantees.
    assert exposition.render_text(snap, prefix="tpu_stencil_fed") == text


def test_fed_statusz_schema(fedpair):
    fed, _, _ = fedpair
    status, body = _get(fed.url, "/statusz")
    assert status == 200
    payload = json.loads(body)
    assert payload["schema_version"] == 1
    assert payload["draining"] is False
    assert len(payload["members"]) == 2
    for m in payload["members"]:
        assert m["state"] == "healthy"
    assert "breakers" in payload and "tenants" in payload
    assert "net" in payload and "counters" in payload["net"]
    assert payload["config"]["tenant_quota"] == 32


def test_fed_healthz(fedpair):
    fed, _, _ = fedpair
    status, body = _get(fed.url, "/healthz")
    assert status == 200 and body == b"ok\n"


def test_fed_debug_prof_is_404_clean(fedpair):
    fed, _, _ = fedpair
    for status, body in (_get(fed.url, "/debug/prof"),
                         _post_admin(fed.url, "/debug/prof?seconds=1")):
        assert status == 404
        assert b"no device profiler on the federation tier" in body


def test_registration_endpoint(fedpair):
    fed, _, _ = fedpair
    # A dead URL fails its registration health check typed.
    status, body = _post_admin(
        fed.url, "/admin/register?url=http%3A%2F%2F127.0.0.1%3A9"
    )
    assert status == 400 and b"health check" in body
    # Missing url param.
    assert _post_admin(fed.url, "/admin/register")[0] == 400
    # A live third member registers and serves.
    m3 = _make_member()
    try:
        status, body = _post_admin(
            fed.url,
            "/admin/register?url=" + urllib.parse.quote(m3.url, safe=""),
        )
        assert status == 200
        payload = json.loads(body)
        assert payload["state"] == "healthy"
        assert any(m["host_id"] == payload["host_id"]
                   for m in json.loads(_get(fed.url, "/statusz")[1])
                   ["members"])
    finally:
        m3.close()


def test_loadgen_http_against_federation(fedpair):
    # The port's loadgen pointed at a federation works unchanged: same
    # loops, same report schema, stats scraped from the fed's registry.
    from tpu_stencil_torch.serve import loadgen

    fed, _, _ = fedpair
    target = loadgen.HttpTarget(fed.url)
    try:
        report = loadgen.run(
            target, mode="closed", requests=6, concurrency=2, reps=1,
            shapes=((10, 12),), channels=(3,), seed=1,
        )
    finally:
        target.close()
    assert report["completed"] == 6
    assert report["stats"]["counters"]["requests_total"] >= 6
    assert "retry_after_honored_total" in report


# -- membership / host loss (in-process) -------------------------------


def test_heartbeat_suspicion_window_and_eviction(rng):
    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2], suspect_after=2, evict_after=3,
                    reoffer_s=0.0)
    try:
        img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
        assert _post(fed.url, img, 1)[0] == 200
        hid1 = fed.membership.members()[0].host_id
        # Kill member 1's listener (drain first so close() is quick).
        m1.drain(10.0)
        m1.close()
        # One missed beat: still HEALTHY — never a single-timeout
        # demotion; the window is the whole point.
        fed.membership.beat()
        assert fed.membership.get(hid1).state == "healthy"
        assert fed.membership.get(hid1).misses == 1
        # Second miss: SUSPECT (routable, but after every healthy host).
        fed.membership.beat()
        assert fed.membership.get(hid1).state == "suspect"
        assert len(fed.membership.routable()) == 2
        # Third miss: evicted.
        fed.membership.beat()
        assert fed.membership.get(hid1).state == "evicted"
        assert fed.membership.routable()[0].state == "healthy"
        snap = fed.registry.snapshot()
        assert snap["counters"]["evictions_total"] == 1
        assert snap["gauges"]["members_evicted"]["value"] == 1
        # Survivor keeps serving, bit-exact.
        status, body, headers = _post(fed.url, img, 1)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 1),
        )
        # The eviction is visible in the text scrape too.
        text = _get(fed.url, "/metrics")[1].decode()
        assert "tpu_stencil_fed_evictions_total 1" in text
    finally:
        fed.close()
        m2.close()


def test_draining_member_leaves_routing_before_failing(rng):
    # A member whose healthz answers 503 is removed from routing by the
    # next beat — the drain-ahead-of-failure contract.
    from tpu_stencil_torch.fed import host_id_for

    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2])
    try:
        m1.begin_drain()  # healthz now 503, requests would 503 too
        fed.membership.beat()
        routable = fed.membership.routable()
        assert len(routable) == 1
        img = np.zeros((8, 8), np.uint8)
        for _ in range(3):
            status, _, headers = _post(fed.url, img, 1)
            assert status == 200
            assert headers["X-Fed-Member"] == host_id_for(m2.url)
    finally:
        fed.close()
        m1.close()
        m2.close()


def test_admin_drain_is_sticky_against_heartbeat_healing():
    # An ADMIN drain (pinned) survives a heartbeat 200; only
    # re-registration readmits.
    from tpu_stencil_torch.fed import host_id_for

    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2])
    try:
        hid = host_id_for(m1.url)
        # Self-reported drains (healthz 503) DO heal on a later 200:
        fed.membership.mark_draining(hid)
        fed.membership.beat()  # m1 healthz still answers 200
        assert fed.membership.get(hid).state == "healthy"
        # A pinned admin drain does not:
        fed.membership.mark_draining(hid, pinned=True)
        fed.membership.beat()
        assert fed.membership.get(hid).state == "draining"
        assert len(fed.membership.routable()) == 1
        # Re-registration is the explicit way back in.
        fed.membership.register(m1.url)
        assert fed.membership.get(hid).state == "healthy"
        assert not fed.membership.get(hid).pinned_draining
    finally:
        fed.close()
        m1.close()
        m2.close()


def test_reregistration_resets_breaker_and_hedge_state():
    # A host re-registering after an eviction or drain is a NEW process
    # on a reused netloc: it inherits neither the dead one's open
    # breaker nor its forward-latency tail in the hedge p99 trigger.
    from tpu_stencil_torch.fed import host_id_for

    m1 = _make_member()
    fed = _make_fed([m1], breaker_threshold=2, hedge_min_s=0.05)
    try:
        hid = host_id_for(m1.url)
        fed.breakers.record_failure(hid)
        fed.breakers.record_failure(hid)
        assert fed.breakers.get(hid).state == "open"
        for _ in range(8):
            fed.router._observe_forward(hid, 7.5)
        assert fed.router._hedge_after() == pytest.approx(7.5)

        fed.membership.mark_draining(hid, pinned=True)
        fed.membership.register(m1.url)  # the restarted host announces

        assert fed.breakers.get(hid).state == "closed"
        assert fed.router._hedge_after() == pytest.approx(0.05)
        snap = fed.registry.snapshot()["counters"]
        assert snap["reregister_resets_total"] == 1
        # A plain re-registration of a HEALTHY member is NOT a
        # resurrection: learned state survives, no reset counted.
        fed.breakers.record_failure(hid)
        fed.router._observe_forward(hid, 3.0)
        fed.membership.register(m1.url)
        snap = fed.registry.snapshot()["counters"]
        assert snap["reregister_resets_total"] == 1
        b = fed.breakers.get(hid).snapshot()
        assert b["consecutive_failures"] == 1
        assert fed.router._hedge_after() == pytest.approx(3.0)
    finally:
        fed.close()
        m1.close()


def test_breaker_opens_after_consecutive_failures(rng):
    # One member, killed: requests classify connect/reset, the breaker
    # opens at the threshold, and the next request fails typed
    # HostUnavailable WITHOUT paying a connect attempt.
    m1 = _make_member()
    fed = _make_fed([m1], breaker_threshold=2, breaker_cooldown_s=30.0,
                    reoffer_s=0.0, hedge=False)
    try:
        img = np.zeros((8, 8), np.uint8)
        assert _post(fed.url, img, 1)[0] == 200
        m1.drain(10.0)
        m1.close()
        hid = fed.membership.members()[0].host_id
        for _ in range(2):
            status, body, headers = _post(fed.url, img, 1)
            assert status == 503
            assert b"HostUnavailable" in body
            assert headers.get("Retry-After")
        assert fed.breakers.get(hid).state == "open"
        # Breaker-open rejection: typed, instant, no connect.
        status, body, _ = _post(fed.url, img, 1)
        assert status == 503 and b"breaker" in body
        snap = fed.registry.snapshot()
        assert snap["counters"]["breaker_open_total"] == 1
        assert snap["counters"]["forward_connect_total"] >= 2
        assert json.loads(_get(fed.url, "/statusz")[1])["breakers"][
            hid]["state"] == "open"
    finally:
        fed.close()


def test_hedge_fires_on_stalled_member(rng, monkeypatch):
    # net.body stall chaos on the primary: the hedge fires at the p99
    # trigger, the OTHER member answers, first response wins, and the
    # stalled loser is cancelled typed, visible in the counters. The
    # stall (6 s) ends on its own; the test waits on counters, never on
    # the clock.
    from tpu_stencil_torch.net.http import STALL_ENV

    monkeypatch.setenv(STALL_ENV, "6")
    faults.configure("net.body:at=0:raise=TimeoutError")
    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2], hedge_min_s=0.1, reoffer_s=0.0)
    try:
        img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
        status, body, headers = _post(fed.url, img, 2)
        assert status == 200
        assert headers["X-Fed-Hedged"] == "1"
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 2),
        )
        snap = fed.registry.snapshot()
        assert snap["counters"]["hedges_total"] == 1
        assert snap["counters"]["hedge_wins_total"] == 1
        # The loser's socket was closed under it: counted cancelled.
        _wait_for(lambda: fed.registry.counter(
            "hedge_cancelled_total").value == 1, 30,
            "the stalled leg's cancellation")
    finally:
        faults.clear()
        fed.close()
        m1.close()
        m2.close()


# -- federation-scope admission ----------------------------------------


def test_tenant_quota_isolates_hot_client(rng):
    # The hot tenant degrades to ITS quota (429 + Retry-After); another
    # tenant is untouched. Parked member workers pin the hot tenant's
    # request outstanding.
    m1 = _make_member(start_workers=False, warm_fleet=False)
    fed = _make_fed([m1], tenant_quota=1, reoffer_s=0.0, hedge=False)
    try:
        img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
        results = {}

        def client(key, tenant):
            results[key] = _post(fed.url, img, 1, tenant=tenant)

        t_hot = threading.Thread(target=client, args=("hot1", "hot"),
                                 daemon=True)
        t_hot.start()
        _wait_for(lambda: fed.router.tenants().get("hot", 0) >= 1, 30,
                  "the hot tenant's request outstanding")
        assert fed.router.tenants() == {"hot": 1}
        # The hot tenant's second request: typed 429, instant.
        status, body, headers = _post(fed.url, img, 1, tenant="hot")
        assert status == 429
        assert b"quota" in body and b"'hot'" in body
        assert headers.get("Retry-After")
        # A different tenant is admitted (and queued) just fine.
        t_other = threading.Thread(target=client,
                                   args=("other1", "calm"), daemon=True)
        t_other.start()
        _wait_for(lambda: fed.router.tenants().get("calm", 0) >= 1, 30,
                  "the calm tenant's request outstanding")
        assert fed.router.tenants().get("calm") == 1
        m1.fleet.start_workers()
        t_hot.join(timeout=300)
        t_other.join(timeout=300)
        assert results["hot1"][0] == 200
        assert results["other1"][0] == 200
        snap = fed.registry.snapshot()
        assert snap["counters"]["tenant_quota_rejections_total"] == 1
        assert fed.router.tenants() == {}  # bounded: released on done
    finally:
        fed.close()
        m1.close()


def test_premium_tenant_headroom_past_shed_watermark(rng):
    # Byte-shed priority classes: standard sheds at the watermark,
    # premium keeps 25% headroom.
    m1 = _make_member()
    # 10x10 grey: nbytes = 2*100 = 200; watermark 160 bytes. Standard
    # sheds (200 > 160); premium limit is 200 (160*1.25) and admits.
    fed = _make_fed([m1], max_inflight_mb=160 / (1 << 20),
                    premium_tenants=("vip",), reoffer_s=0.0)
    try:
        img = rng.integers(0, 256, (10, 10), dtype=np.uint8)
        status, body, headers = _post(fed.url, img, 1, tenant="std")
        assert status == 503 and b"shed" in body
        assert headers.get("Retry-After")
        status, body, _ = _post(fed.url, img, 1, tenant="vip")
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 1),
        )
        assert fed.registry.snapshot()["counters"]["shed_total"] == 1
    finally:
        fed.close()
        m1.close()


def test_fed_drain_gate_and_report(rng):
    m1 = _make_member()
    fed = _make_fed([m1])
    try:
        img = np.zeros((8, 8), np.uint8)
        assert _post(fed.url, img, 1)[0] == 200
        report = fed.drain(10.0)
        assert all(report.values()) and len(report) == 1
        assert _get(fed.url, "/healthz")[0] == 503
        status, body, _ = _post(fed.url, img, 1)
        assert status == 503 and b"draining" in body
        assert fed.registry.snapshot()["gauges"]["draining"]["value"] == 1
    finally:
        fed.close()
        m1.close()


def test_rolling_member_drain_in_process(rng):
    # POST /admin/drain?host= bleeds the member out of routing AND
    # drives its own SIGTERM-equivalent admin path.
    from tpu_stencil_torch.fed import host_id_for

    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2])
    try:
        img = np.zeros((8, 8), np.uint8)
        assert _post(fed.url, img, 1)[0] == 200
        hid1 = host_id_for(m1.url)
        status, body = _post_admin(fed.url, f"/admin/drain?host={hid1}")
        assert status == 200
        payload = json.loads(body)
        assert payload["draining"] is True
        assert payload["member_response"]["draining"] is True
        # The member's own admin path ran: healthz flipped, CLI flag up.
        assert m1.admin_drain_requested.is_set()
        assert _get(m1.url, "/healthz")[0] == 503
        assert fed.membership.get(hid1).state == "draining"
        # Traffic now lands only on the survivor.
        for _ in range(3):
            status, _, headers = _post(fed.url, img, 1)
            assert status == 200
            assert headers["X-Fed-Member"] == host_id_for(m2.url)
        # Unknown host: typed 404.
        assert _post_admin(fed.url, "/admin/drain?host=nope")[0] == 404
    finally:
        fed.close()
        m1.close()
        m2.close()


# -- net.accept / net.body chaos sites ---------------------------------


def test_net_accept_fault_drops_connection(rng):
    faults.configure("net.accept:at=0")
    m = _make_member()
    try:
        img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        # First request: the connection drops with no response, the
        # transport-level failure the fed classifies "reset".
        with pytest.raises((http.client.RemoteDisconnected,
                            http.client.BadStatusLine,
                            ConnectionError, OSError)):
            req = urllib.request.Request(
                m.url + "/v1/blur?w=8&h=8&reps=1&channels=1",
                data=img.tobytes(), method="POST",
            )
            urllib.request.urlopen(req, timeout=60)
        # times=1 default: the next request is clean and bit-exact.
        status, body, _ = _post(m.url, img, 1)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 1),
        )
    finally:
        faults.clear()
        m.close()


def test_net_body_fault_truncates_mid_body(rng):
    faults.configure("net.body:at=0")
    m = _make_member()
    try:
        img = rng.integers(0, 256, (16, 16), dtype=np.uint8)
        conn = http.client.HTTPConnection("127.0.0.1", m.port, timeout=60)
        try:
            conn.request(
                "POST", "/v1/blur?w=16&h=16&reps=1&channels=1",
                body=img.tobytes(),
            )
            resp = conn.getresponse()
            assert resp.status == 200  # headers promise the body...
            with pytest.raises(http.client.IncompleteRead):
                resp.read()  # ...the wire delivers half, then EOF
        finally:
            conn.close()
        status, body, _ = _post(m.url, img, 1)
        assert status == 200 and len(body) == img.size
    finally:
        faults.clear()
        m.close()


def test_fed_survives_injected_mid_body_eof(rng):
    # net.body truncation on the member: the fed classifies "eof",
    # charges the breaker, reroutes, and the client sees one clean 200.
    faults.configure("net.body:at=0")
    m1 = _make_member()
    m2 = _make_member()
    fed = _make_fed([m1, m2], hedge=False, reoffer_s=0.0)
    try:
        img = rng.integers(0, 256, (12, 12), dtype=np.uint8)
        status, body, _ = _post(fed.url, img, 2)
        assert status == 200
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape),
            _golden(img, 2),
        )
        snap = fed.registry.snapshot()
        assert snap["counters"]["forward_eof_total"] == 1
        assert snap["counters"]["reroutes_total"] == 1
    finally:
        faults.clear()
        fed.close()
        m1.close()
        m2.close()


def test_retrying_client_honors_retry_after_floor(rng, monkeypatch):
    # A queue-full 429 carries Retry-After: 1; the re-offering client
    # floors its backoff there instead of hammering with millisecond
    # jitter (the pause it asks for is recorded, not timed).
    from tpu_stencil_torch import obs
    from tpu_stencil_torch.resilience import retry
    from tpu_stencil_torch.serve import loadgen

    m = _make_member(start_workers=False, max_queue=1, warm_fleet=False)
    pauses = []
    real_sleep = time.sleep

    class _Clock:
        @staticmethod
        def sleep(s):
            pauses.append(s)
            real_sleep(min(s, 0.05))

    fill = loadgen.HttpTarget(m.url)
    target = loadgen.HttpTarget(m.url)
    try:
        img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
        pinned = fill.submit(img, 1)  # occupies the 1-deep queue
        _wait_for(lambda: sum(m.router.outstanding().values()) >= 1, 30,
                  "the pinned request queued")
        before = obs.registry().counter(
            "resilience_retry_after_honored_total"
        ).value
        offers = []
        orig_post = target._post

        def counting_post(*a, **k):
            offers.append(1)
            return orig_post(*a, **k)

        target._post = counting_post
        monkeypatch.setattr(retry, "time", _Clock)
        fut = target.submit_retrying(img, 1, give_up_after_s=60.0)
        _wait_for(lambda: len(offers) >= 2, 60, "a re-offer")
        m.fleet.start_workers()
        np.testing.assert_array_equal(
            fut.result(timeout=300), _golden(img, 1)
        )
        pinned.result(timeout=300)
        assert obs.registry().counter(
            "resilience_retry_after_honored_total"
        ).value > before
        # Re-offers were spaced by the server's hint (1 s), not
        # millisecond jitter.
        assert pauses and pauses[0] >= 1.0
    finally:
        target.close()
        fill.close()
        m.close()


# -- the fed cases of the integrity suite ------------------------------


@pytest.mark.chaos
def test_fed_bad_payload_verdict_reroutes_to_exact_bytes(rng):
    from tpu_stencil_torch.fed.http import FedFrontend

    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    body = img.tobytes()
    want = _golden(img, 3).tobytes()
    m1 = _make_member(witness_rate=0.0, probe_interval_s=0.0)
    m2 = _make_member(witness_rate=0.0, probe_interval_s=0.0)
    # hedge=False: a cold first forward outlives the hedge trigger, and a
    # clean hedge winning the race would mask the reroute under test.
    fed = FedFrontend(FedConfig(
        port=0, members=(m1.url, m2.url), heartbeat_interval_s=5.0,
        hedge=False,
    )).start()
    try:
        # Arm AFTER the members started (their sites resolve at start()):
        # one member 200 gets its body flipped on the wire.
        faults.configure("net.corrupt_body:times=1")
        m1.fault_corrupt_body = faults.site("net.corrupt_body")
        m2.fault_corrupt_body = faults.site("net.corrupt_body")
        status, out, headers = _post(fed.url, img, 3, headers={
            checksum.CRC_HEADER: str(checksum.crc32c(body)),
        })
        # The fed hop caught the corrupt 200 (bad_payload), charged the
        # breaker, rerouted: the client never saw wrong bytes.
        assert status == 200 and out == want
        assert int(headers[checksum.RESULT_HEADER]) == checksum.crc32c(out)
        snap = fed.registry.snapshot()
        assert snap["counters"]["forward_bad_payload_total"] == 1
        assert snap["counters"]["reroutes_total"] >= 1
    finally:
        faults.clear()
        fed.close()
        m1.close()
        m2.close()


def test_fed_edge_validates_request_crc(rng):
    m1 = _make_member()
    fed = _make_fed([m1])
    try:
        img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        status, body, _ = _post(fed.url, img, 3, headers={
            checksum.CRC_HEADER: "999",
        })
        assert status == 400 and b"ChecksumMismatch" in body
        # No member round trip was spent on the corrupt body.
        assert fed.registry.snapshot()["counters"].get(
            "forwarded_total", 0) == 0
    finally:
        fed.close()
        m1.close()


def test_fed_bad_payload_on_length_contradiction(rng):
    from tpu_stencil_torch.fed.router import (
        BadPayload,
        _Attempt,
        _verdict_exc,
    )

    att = _Attempt.__new__(_Attempt)
    good = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8).tobytes()
    stamp = {checksum.RESULT_HEADER.lower(): str(checksum.crc32c(good))}
    att._verify_payload(dict(stamp), good)  # clean: no raise
    with pytest.raises(BadPayload):
        att._verify_payload({checksum.RESULT_HEADER.lower(): "1"}, good)
    with pytest.raises(BadPayload):
        att._verify_payload(
            {"x-width": "10", "x-height": "10", "x-channels": "3"},
            b"short",
        )
    assert _verdict_exc(BadPayload("x")) == "bad_payload"


def test_member_kernel_build_error_reaches_the_client_typed(monkeypatch,
                                                            rng):
    # A member whose kernel cannot build answers a typed 500 naming
    # KernelBuildError; the fed carries it as the JAX fed carries any
    # member 5xx (breaker charged, reroute, then 503 HostUnavailable),
    # naming the member's error. Nothing falls back to torch ops.
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    def refuse(*_a, **_k):
        raise _build.KernelBuildError("kernel build failed (forced)")

    steps = []
    m1 = _make_member(backend="pallas")
    fed = _make_fed([m1], hedge=False, reoffer_s=0.0)
    try:
        monkeypatch.setattr(cs, "stencil_fused", refuse)
        monkeypatch.setattr(lowering, "padded_step",
                            lambda *a, **k: steps.append(a))
        img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
        status, body, _ = _post(m1.url, img, 2)
        assert status == 500 and b"KernelBuildError" in body
        status, body, headers = _post(fed.url, img, 2)
        assert status == 503 and headers.get("Retry-After")
        assert b"HostUnavailable" in body
        assert b"http_500 (KernelBuildError)" in body
        c = fed.registry.snapshot()["counters"]
        assert c["forward_http_5xx_total"] == 1
        assert steps == []
    finally:
        fed.close()
        m1.close()


# -- the fed process never initializes CUDA ----------------------------


def test_fed_path_never_initializes_cuda(fedpair, rng, monkeypatch):
    # Nothing the fed runs calls into torch.cuda: a round trip, the
    # merged scrapes and the admin surface with CUDA's lazy init armed
    # to fail. (The members here are CPU members in this process; they
    # never touch CUDA either.)
    def boom(*_a, **_k):
        raise AssertionError("the federation path initialized CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    fed, _, _ = fedpair
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    assert _post(fed.url, img, 2)[0] == 200
    for path in ("/metrics", "/statusz", "/debug/capacity",
                 "/debug/tenants", "/debug/timeseries"):
        assert _get(fed.url, path)[0] == 200, path


# -- host-loss chaos with real subprocess members ----------------------


def _spawn_member(register_url=None, extra=()):
    argv = [sys.executable, "-m", "tpu_stencil_torch", "net", "--port",
            "0", "--replicas", "1", "--platform", "cpu",
            "--drain-timeout", "60", "--prof-dir", "none",
            "--flightrec-dir", "none"]
    if register_url:
        argv += ["--register", register_url]
    argv += list(extra)
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    line = proc.stdout.readline()
    if "net: serving on http://" not in line:
        _reap(proc)
        raise AssertionError(line)
    return proc, line.split()[3]


def _reap(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)
    proc.stdout.close()
    proc.stderr.close()


def test_kill9_member_under_load_every_request_typed(rng):
    # kill -9 one member under concurrent load: every request completes
    # or fails with a typed status (never a hang, never a transport
    # exception out of the federation), the eviction lands in the
    # scrape, and survivors keep serving.
    from tpu_stencil_torch.fed import FedFrontend, host_id_for

    p1, url1 = _spawn_member()
    p2 = fed = None
    try:
        p2, url2 = _spawn_member()
        fed = FedFrontend(FedConfig(
            port=0, members=(url1, url2), heartbeat_interval_s=0.1,
            suspect_after=2, evict_after=3, breaker_threshold=2,
            breaker_cooldown_s=60.0, forward_timeout_s=60.0,
            reoffer_s=0.2, flightrec_dir=None,
        )).start()
        img = rng.integers(0, 256, (24, 24), dtype=np.uint8)
        want = _golden(img, 3)
        served = set()
        for _ in range(4):
            status, _, headers = _post(fed.url, img, 3)
            assert status == 200
            served.add(headers["X-Fed-Member"])
        # Digest affinity lands every copy of this frame on one member:
        # that member is the one killed, so the load feels the loss.
        assert len(served) == 1
        if served == {host_id_for(url2)}:
            (p1, url1), (p2, url2) = (p2, url2), (p1, url1)
        results = []
        results_lock = threading.Lock()
        kill_at = threading.Event()

        def client(i):
            for j in range(4):
                if i == 0 and j == 2:
                    kill_at.set()
                try:
                    status, body, _ = _post(fed.url, img, 3,
                                            http_timeout=120)
                except Exception as e:  # noqa: BLE001
                    with results_lock:
                        results.append(("exc", type(e).__name__))
                    continue
                with results_lock:
                    results.append((status, body))

        threads = [threading.Thread(target=client, args=(i,),
                                    daemon=True) for i in range(6)]
        for t in threads:
            t.start()
        kill_at.wait(timeout=60)
        os.kill(p1.pid, signal.SIGKILL)  # the host is GONE, mid-load
        for t in threads:
            t.join(timeout=300)
        assert len(results) == 24
        for status, payload in results:
            # Typed statuses only: 200 (served, possibly via hedge or
            # reroute) or a typed rejection.
            assert status in (200, 429, 503, 504), (status, payload)
            if status == 200:
                np.testing.assert_array_equal(
                    np.frombuffer(payload, np.uint8).reshape(img.shape),
                    want,
                )
        hid1 = host_id_for(url1)
        _wait_for(lambda: fed.membership.get(hid1).state == "evicted", 60,
                  "the dead member's eviction")
        status, body, headers = _post(fed.url, img, 3)
        assert status == 200
        assert headers["X-Fed-Member"] == host_id_for(url2)
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(img.shape), want
        )
        text = _get(fed.url, "/metrics")[1].decode()
        assert "tpu_stencil_fed_evictions_total 1" in text
        snap = fed.registry.snapshot()
        assert (snap["counters"].get("breaker_open_total", 0) >= 1
                or snap["counters"].get("reroutes_total", 0) >= 1
                or snap["counters"].get("hedges_total", 0) >= 1)
        stz = json.loads(_get(fed.url, "/statusz")[1])
        assert any(m["state"] == "evicted" for m in stz["members"])
    finally:
        if fed is not None:
            fed.close()
        _reap(p1)
        if p2 is not None:
            _reap(p2)


def test_rolling_drain_of_every_member_zero_drops(rng):
    # Drain every member in sequence through the fed's admin path while
    # load runs: every accepted request completes, each member exits
    # rc 0 reporting a clean drain.
    from tpu_stencil_torch.fed import FedFrontend, host_id_for

    fed = FedFrontend(FedConfig(
        port=0, heartbeat_interval_s=0.2, reoffer_s=0.2, flightrec_dir=None,
    )).start()
    p1 = p2 = None
    try:
        # Members register THEMSELVES (`net --register`).
        p1, url1 = _spawn_member(register_url=fed.url)
        p2, url2 = _spawn_member(register_url=fed.url)
        _wait_for(lambda: len(fed.membership.routable()) == 2, 60,
                  "both members registered")
        img = rng.integers(0, 256, (16, 16), dtype=np.uint8)
        want = _golden(img, 2)
        assert _post(fed.url, img, 2)[0] == 200
        results = []
        results_lock = threading.Lock()

        def client():
            for _ in range(3):
                status, body, _ = _post(fed.url, img, 2, http_timeout=120)
                with results_lock:
                    results.append((status, body))

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        # Roll member 1 out mid-load.
        status, _ = _post_admin(fed.url,
                                f"/admin/drain?host={host_id_for(url1)}")
        assert status == 200
        rc1 = p1.wait(timeout=120)
        out1 = p1.stdout.read()
        assert rc1 == 0, out1
        assert "drained 1 replica(s) cleanly" in out1
        for t in threads:
            t.join(timeout=300)
        # ZERO drops: every request answered 200 bit-exact.
        assert len(results) == 12
        for status, body in results:
            assert status == 200, status
            np.testing.assert_array_equal(
                np.frombuffer(body, np.uint8).reshape(img.shape), want
            )
        # Roll the last member too: its accepted work also completes.
        status, _ = _post_admin(fed.url,
                                f"/admin/drain?host={host_id_for(url2)}")
        assert status == 200
        rc2 = p2.wait(timeout=120)
        assert rc2 == 0
        assert "drained 1 replica(s) cleanly" in p2.stdout.read()
        # The federation is now memberless: typed 503, never a hang.
        status, body, _ = _post(fed.url, img, 2)
        assert status == 503 and b"HostUnavailable" in body
    finally:
        fed.close()
        if p1:
            _reap(p1)
        if p2:
            _reap(p2)


@pytest.mark.chaos
def test_fed_timeseries_merge_survives_kill9_member(rng):
    # A member killed -9 mid-load surfaces as an explicit stale entry in
    # the merged /debug/timeseries: the payload stays well-formed, the
    # fan-out stays bounded (never a hang), and the fold stamps the
    # staleness gauge.
    from tpu_stencil_torch.fed import FedFrontend, host_id_for
    from tpu_stencil_torch.obs import exposition

    p1, url1 = _spawn_member(extra=("--sample-interval", "0.2"))
    p2 = fed = None
    stop = threading.Event()
    try:
        p2, url2 = _spawn_member(extra=("--sample-interval", "0.2"))
        fed = FedFrontend(FedConfig(
            port=0, members=(url1, url2), heartbeat_interval_s=10.0,
            sample_interval_s=0.1, breaker_threshold=2, flightrec_dir=None,
        )).start()
        img = rng.integers(0, 256, (12, 10), dtype=np.uint8)
        status, body, _ = _post(fed.url, img, 3)
        assert status == 200 and body == _golden(img, 3).tobytes()

        def load():
            while not stop.is_set():
                try:
                    _post(fed.url, img, 3, http_timeout=30.0)
                except Exception:  # noqa: BLE001
                    pass

        t = threading.Thread(target=load, daemon=True)
        t.start()
        doc = json.loads(_get(fed.url, "/debug/timeseries?window=60",
                              http_timeout=30.0)[1])
        id1, id2 = host_id_for(url1), host_id_for(url2)
        assert doc["source"] == "fed" and set(doc["members"]) == {id1, id2}
        assert not doc["members"][id1]["stale"]
        assert not doc["members"][id2]["stale"]
        assert doc["members"][id1]["schema_version"] == 1
        os.kill(p2.pid, signal.SIGKILL)
        p2.wait(timeout=30)
        status, raw = _get(fed.url, "/debug/timeseries?window=60",
                           http_timeout=30.0)
        assert status == 200
        doc = json.loads(raw)  # well-formed despite the dead member
        assert set(doc["members"]) == {id1, id2}
        live, dead = doc["members"][id1], doc["members"][id2]
        assert not live["stale"] and live["counters"]
        assert dead["stale"] and "error" in dead
        assert dead["scrape_age_s"] >= 0 or dead["scrape_age_s"] == -1.0
        snap = fed.metrics_snapshot()
        age_live = snap["gauges"][f"fleet_{id1}_scrape_age_seconds"]
        age_dead = snap["gauges"][f"fleet_{id2}_scrape_age_seconds"]
        assert age_live["value"] >= 0.0
        assert age_dead["value"] >= 0.0 or age_dead["value"] == -1.0
        assert snap["counters"]["member_scrape_failures_total"] >= 1
        text = exposition.render_text(snap, prefix="tpu_stencil_fed")
        assert f"fleet_{id1}_scrape_age_seconds" in text
    finally:
        stop.set()
        if fed is not None:
            fed.close()
        _reap(p1)
        if p2 is not None:
            _reap(p2)


# -- fed CLI, end to end -----------------------------------------------


def test_fed_cli_sigterm_drain_subprocess(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_stencil_torch", "fed", "--port", "0",
         "--drain-timeout", "30", "--flightrec-dir", "none"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
    )
    try:
        line = proc.stdout.readline()
        assert "fed: serving on http://" in line, line
        url = line.split()[3]
        assert _get(url, "/healthz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        out = proc.stdout.read()
        assert rc == 0, (out, proc.stderr.read()[-2000:])
        assert "drained 0 host(s) cleanly" in out
    finally:
        _reap(proc)
