"""The port's federation and control plane against the JAX package's, side
by side.

A JAX ``FedFrontend`` over JAX ``NetFrontend`` members (the CPU) and the
port's over port members (``devices=[cpu]``) take the same seeded
requests, made with numpy, over real sockets on port 0, and must agree
on:

* the response bytes, with tolerance 0: every filter a request can name
  is an integer plan (``sep_int`` or ``direct_int``); a ``direct_f32``
  plan comes only from a custom filter, which the HTTP tiers cannot take;
* the result CRC each response is stamped with;
* the status codes over the 400 / 404 / 413 / 429 / 503 / 504 table,
  tenant-quota 429s included, and the forward verdicts the fed counts;
* ``host_id_for`` on the same URLs;
* the key sets of the fed's ``/statusz``, ``/debug/capacity`` and
  ``/debug/tenants``.

And, for the control plane: the two ``CapacityPlanner`` s give the same
decision sequence for one seeded sequence of ``CapacitySignal`` s; the
warm-state envelopes of two servers that served the same requests name
the same keys after ``canonical_backend``; and each importer degrades
the other package's envelope as ``version_skew`` without raising.

Every frontend is drained and closed in a fixture finalizer.
"""

import copy
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_stencil.config import FedConfig as JFedConfig
from tpu_stencil.config import NetConfig as JNetConfig
from tpu_stencil_torch.config import FedConfig, NetConfig, canonical_backend
from tpu_stencil_torch.integrity import checksum

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

CPU = torch.device("cpu")
EDGES = (8, 16, 32)
MEMBER = dict(port=0, replicas=1, bucket_edges=EDGES, max_queue=16,
              warm_fleet=False, flightrec_dir=None, prof_dir=None,
              witness_rate=0.0, probe_interval_s=0.0)
FED = dict(port=0, heartbeat_interval_s=10.0, flightrec_dir=None,
           hedge=False, reoffer_s=0.0)


def _member(which, start_workers=True, **kw):
    cfg = dict(MEMBER, **kw)
    if which == "jax":
        from tpu_stencil.net import NetFrontend as JNetFrontend

        return JNetFrontend(JNetConfig(**cfg),
                            start_workers=start_workers).start()
    from tpu_stencil_torch.net import NetFrontend

    return NetFrontend(NetConfig(**cfg), start_workers=start_workers,
                       devices=[CPU] * cfg["replicas"]).start()


def _fed(which, members, **kw):
    cfg = dict(FED, members=tuple(m.url for m in members), **kw)
    if which == "jax":
        from tpu_stencil.fed import FedFrontend as JFedFrontend

        return JFedFrontend(JFedConfig(**cfg)).start()
    from tpu_stencil_torch.fed import FedFrontend

    return FedFrontend(FedConfig(**cfg)).start()


@pytest.fixture
def pair():
    """A factory of ``{"jax": (fed, members), "port": (fed, members)}``
    with the same configuration; everything it starts is closed when the
    test ends."""
    started = []

    def make(n_members=2, start_workers=True, member_kw=None, **fed_kw):
        out = {}
        for which in ("jax", "port"):
            members = [_member(which, start_workers, **(member_kw or {}))
                       for _ in range(n_members)]
            started.extend(members)
            fed = _fed(which, members, **fed_kw)
            started.append(fed)
            out[which] = (fed, members)
        return out

    yield make
    for fe in reversed(started):
        fe.close()


def _post(url, img, reps, filter_name=None, headers=None, body=None,
          timeout=120.0):
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    hdr = {"X-Width": str(w), "X-Height": str(h), "X-Reps": str(reps),
           "X-Channels": str(c)}
    if filter_name:
        hdr["X-Filter"] = filter_name
    hdr.update(headers or {})
    req = urllib.request.Request(
        url + "/v1/blur", data=img.tobytes() if body is None else body,
        headers=hdr, method="POST")
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


def _wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


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


def test_bytes_and_result_crc_equal(pair):
    feds = pair()
    for img, fname, reps in _requests(41):
        body = img.tobytes()
        claim = {checksum.CRC_HEADER: str(checksum.crc32c(body))}
        got = {}
        for which, (fed, _m) in feds.items():
            status, out, hdr = _post(fed.url, img, reps, fname, claim)
            assert status == 200, (which, out[:200])
            assert hdr["X-Fed-Hedged"] == "0"
            got[which] = (out, hdr[checksum.RESULT_HEADER])
        assert got["port"] == got["jax"], (img.shape, fname, reps)
        assert int(got["port"][1]) == checksum.crc32c(got["port"][0])
    jc, pc = (feds[w][0].registry.snapshot()["counters"]
              for w in ("jax", "port"))
    for k in ("requests_total", "forwarded_total", "responses_2xx_total",
              "affinity_routed_total"):
        assert pc[k] == jc[k] == len(REQUESTS), k


def _status_table(url):
    img = np.random.default_rng(42).integers(0, 256, (8, 8), np.uint8)
    body = img.tobytes()
    rows = {
        "no_geometry": urllib.request.Request(
            url + "/v1/blur", data=body, method="POST"),
        "oversized": urllib.request.Request(
            url + "/v1/blur?w=8&h=8&reps=1&channels=1",
            data=body + b"\0" * 100, method="POST"),
        "unknown_endpoint": urllib.request.Request(
            url + "/v2/blur", data=body, method="POST"),
        "unknown_get": urllib.request.Request(url + "/nope"),
        "prof_get": urllib.request.Request(url + "/debug/prof"),
        "prof_post": urllib.request.Request(
            url + "/debug/prof?seconds=1", data=b"", method="POST"),
        "bad_window": urllib.request.Request(
            url + "/debug/timeseries?window=-1"),
        "register_no_url": urllib.request.Request(
            url + "/admin/register", data=b"", method="POST"),
        "register_dead": urllib.request.Request(
            url + "/admin/register?url=http%3A%2F%2F127.0.0.1%3A9",
            data=b"", method="POST"),
        "drain_unknown": urllib.request.Request(
            url + "/admin/drain?host=nope", data=b"", method="POST"),
        "preempt_unknown": urllib.request.Request(
            url + "/admin/preempt?host=nope", data=b"", method="POST"),
        "bad_trace": urllib.request.Request(url + "/debug/trace/zz"),
    }
    out = {}
    for name, req in rows.items():
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                out[name] = r.status
        except urllib.error.HTTPError as e:
            out[name] = e.code
    out["bad_channels"] = _post(url, img.reshape(8, 4, 2), 1)[0]
    out["bad_reps"] = _post(url, img, -1)[0]
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
    feds = pair()
    jt = _status_table(feds["jax"][0].url)
    pt = _status_table(feds["port"][0].url)
    assert pt == jt
    assert set(pt.values()) == {400, 404, 413}


def _park(url, img, n, fe, tenant=None):
    """``n`` requests posted to ``url`` on threads, returned once ``fe``
    (the fed, or a member) counts them outstanding."""
    results = []
    hdr = {"X-Tenant": tenant} if tenant else None

    def post():
        results.append(_post(url, img, 1, headers=hdr)[0])

    threads = [threading.Thread(target=post, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    _wait_for(lambda: sum(fe.router.outstanding().values()) >= n)
    return threads, results


def test_status_codes_429_503_504_and_verdicts_equal(pair):
    img = np.random.default_rng(43).integers(0, 256, (8, 8), np.uint8)
    codes = {"jax": [], "port": []}
    # 429, tenant quota: the hot tenant's second request while its first
    # is parked on a member; another tenant is admitted.
    feds = pair(n_members=1, start_workers=False, tenant_quota=1)
    for which, (fed, (m,)) in feds.items():
        threads, results = _park(fed.url, img, 1, fed, tenant="hot")
        status, body, hdr = _post(fed.url, img, 1,
                                  headers={"X-Tenant": "hot"})
        assert b"quota" in body and hdr.get("Retry-After")
        codes[which].append(status)
        m.fleet.start_workers()
        for t in threads:
            t.join(timeout=120)
        codes[which] += results
        codes[which].append(
            fed.registry.counter("tenant_quota_rejections_total").value)
    # 429, every member queue full (max_queue 1, parked), with the
    # member's Retry-After; 504, a deadline expiring in a parked queue.
    feds = pair(n_members=1, start_workers=False,
                member_kw=dict(max_queue=1))
    for which, (fed, (m,)) in feds.items():
        threads, results = _park(fed.url, img, 1, m)
        status, _b, hdr = _post(fed.url, img, 1)
        assert hdr.get("Retry-After")
        codes[which].append(status)
        m.fleet.start_workers()
        for t in threads:
            t.join(timeout=120)
        codes[which] += results
    feds = pair(n_members=1, start_workers=False)
    for which, (fed, (m,)) in feds.items():
        result = {}
        t = threading.Thread(target=lambda: result.update(r=_post(
            fed.url, img, 1, headers={"X-Request-Timeout": "0.05"})))
        t.start()
        _wait_for(lambda: sum(m.router.outstanding().values()) >= 1)
        time.sleep(0.15)  # the deadline passes while the request is queued
        m.fleet.start_workers()
        t.join(timeout=120)
        codes[which].append(result["r"][0])
    # 503: the fed's shed watermark, a draining fed, a memberless fed.
    feds = pair(n_members=1, max_inflight_mb=0.0001)
    for which, (fed, _m) in feds.items():
        status, body, hdr = _post(fed.url, img, 1)
        assert b"shed" in body and hdr.get("Retry-After")
        codes[which].append(status)
        fed.begin_drain()
        codes[which].append(_post(fed.url, img, 1)[0])
        codes[which].append(_get(fed.url, "/healthz")[0])
    feds = pair(n_members=0)
    for which, (fed, _m) in feds.items():
        status, body, _h = _post(fed.url, img, 1)
        assert b"HostUnavailable" in body
        codes[which].append(status)
    # Verdicts: a member that is gone (connect), then the breaker open.
    feds = pair(n_members=1, breaker_threshold=1, breaker_cooldown_s=60.0)
    for which, (fed, (m,)) in feds.items():
        m.drain(10.0)
        m.close()
        for _ in range(2):
            codes[which].append(_post(fed.url, img, 1)[0])
        c = fed.registry.snapshot()["counters"]
        codes[which] += [c.get("forward_connect_total", 0),
                         c.get("breaker_open_total", 0)]
    assert codes["port"] == codes["jax"]
    assert codes["port"] == [429, 200, 1, 429, 200, 504, 503, 503, 503,
                             503, 503, 503, 1, 1]


def test_mid_body_eof_verdict_and_reroute_equal(pair):
    # net.body truncates one member 200 mid-body (each package's own
    # fault harness): both feds classify "eof", reroute, and answer the
    # same exact bytes.
    from tpu_stencil.resilience import faults as jfaults
    from tpu_stencil_torch.resilience import faults as pfaults

    img = np.random.default_rng(44).integers(0, 256, (12, 12, 3), np.uint8)
    out = {}
    for which, harness in (("jax", jfaults), ("port", pfaults)):
        harness.configure("net.body:at=0")
        try:
            members = [_member(which) for _ in range(2)]
        finally:
            harness.clear()
        fed = _fed(which, members)
        try:
            status, body, _h = _post(fed.url, img, 2)
            c = fed.registry.snapshot()["counters"]
            out[which] = (status, body, c["forward_eof_total"],
                          c["reroutes_total"])
        finally:
            fed.close()
            for m in members:
                m.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 200 and out["port"][2:] == (1, 1)


def test_host_id_for_equal():
    from tpu_stencil.fed import host_id_for as jhost
    from tpu_stencil_torch.fed import host_id_for as phost

    urls = ["http://127.0.0.1:8080", "http://127.0.0.1:8080/",
            "https://host-1.example:443", "http://host.1:80",
            "http://[::1]:9000/", "http://a_b-c.d:1"]
    rng = np.random.default_rng(45)
    urls += [f"http://10.{a}.{b}.{c}:{p}" for a, b, c, p in
             rng.integers(0, 256, (20, 4)) * [1, 1, 1, 250]]
    assert [phost(u) for u in urls] == [jhost(u) for u in urls]


def _keys(d, depth=2):
    """The nested key set of a JSON payload, ``depth`` levels down."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk in _keys(v, depth - 1)}
    return out


def test_statusz_capacity_tenants_key_sets_equal(pair):
    feds = pair(sample_interval_s=0.05)
    img = np.random.default_rng(46).integers(0, 256, (10, 12), np.uint8)
    for fed, _m in feds.values():
        for tenant in ("alpha", "beta"):
            assert _post(fed.url, img, 1,
                         headers={"X-Tenant": tenant})[0] == 200
    # Member-keyed maps are keyed by host ids (different ports) and the
    # merged registry names are each engine's own: compare structure.
    drop = ("net.", "members.", "outstanding.", "breakers.")
    for path in ("/statusz", "/debug/capacity?window=30",
                 "/debug/tenants"):
        j = json.loads(_get(feds["jax"][0].url, path)[1])
        p = json.loads(_get(feds["port"][0].url, path)[1])
        jk = {k for k in _keys(j) if not k.startswith(drop)}
        pk = {k for k in _keys(p) if not k.startswith(drop)}
        assert pk == jk, path
        if path == "/statusz":
            assert [sorted(m) for m in p["members"]] == [
                sorted(m) for m in j["members"]]
        if path == "/debug/tenants":
            assert set(p["fed"]) == set(j["fed"]) == {"alpha", "beta"}
            assert p["fed"] == j["fed"]


def test_planners_give_the_same_decisions():
    from tpu_stencil.config import CtrlConfig as JCtrlConfig
    from tpu_stencil.ctrl import CapacityPlanner as JPlanner
    from tpu_stencil.ctrl import CapacitySignal as JSignal
    from tpu_stencil_torch.config import CtrlConfig
    from tpu_stencil_torch.ctrl import CapacityPlanner, CapacitySignal

    kw = dict(fed_url="http://127.0.0.1:1", min_hosts=1, max_hosts=4,
              fast_samples=2, slow_samples=4, cooldown_samples=2,
              scale_out_utilization=0.8, hold_utilization=0.5,
              scale_in_utilization=0.2, saturation_horizon_s=10.0)
    planners = {"jax": JPlanner(JCtrlConfig(**kw)),
                "port": CapacityPlanner(CtrlConfig(**kw))}
    signals = {"jax": JSignal, "port": CapacitySignal}
    rng = np.random.default_rng(47)
    owned = {"jax": 1, "port": 1}
    seq = {"jax": [], "port": []}
    # Phases of load so every branch is reached: ramps, plateaus,
    # unknown samples, saturation forecasts, dead and preempted hosts.
    levels = np.concatenate([np.full(12, 0.95), np.full(8, 0.6),
                             np.full(14, 0.05), rng.random(80)])
    for i, level in enumerate(levels):
        util = None if rng.random() < 0.1 else float(level)
        tts = float(rng.random() * 20) if rng.random() < 0.15 else None
        dead = int(rng.random() < 0.04)
        pre = int(rng.random() < 0.03)
        for which in ("jax", "port"):
            sig = signals[which](utilization=util, time_to_saturation_s=tts,
                                 dead_hosts=dead, preempted_hosts=pre)
            d = planners[which].observe(sig, owned[which])
            seq[which].append((d.action, d.reason, d.count))
            if d.action in ("scale_out", "replace"):
                owned[which] = min(8, owned[which] + d.count)
            elif d.action == "scale_in":
                owned[which] -= 1
    assert seq["port"] == seq["jax"]
    assert {a for a, _r, _c in seq["port"]} == {
        "hold", "scale_out", "scale_in", "replace"}
    jc = planners["jax"].registry.snapshot()
    pc = planners["port"].registry.snapshot()
    assert pc["counters"] == jc["counters"]


def _warm_servers():
    """A JAX server (backend ``xla``) and a port server (backend ``torch``,
    the port's spelling of the same) that served the same requests."""
    from tpu_stencil.config import ServeConfig as JServeConfig
    from tpu_stencil.serve.engine import StencilServer as JServer
    from tpu_stencil_torch.config import ServeConfig
    from tpu_stencil_torch.serve.engine import StencilServer

    jsrv = JServer(JServeConfig(backend="xla", max_queue=16))
    psrv = StencilServer(ServeConfig(backend="torch", max_queue=16),
                         device=CPU)
    for img, fname, reps in _requests(48)[:4]:
        want = jsrv.submit(img, reps, filter_name=fname).result(timeout=300)
        got = psrv.submit(img, reps, filter_name=fname).result(timeout=300)
        np.testing.assert_array_equal(got, want)
    return jsrv, psrv


def test_warm_envelope_keys_equal_after_canonical_backend():
    jsrv, psrv = _warm_servers()
    try:
        jenv, penv = jsrv.export_warm_state(), psrv.export_warm_state()
    finally:
        jsrv.close()
        psrv.close()

    def keys(env):
        out = set()
        for e in env["entries"]:
            k = list(e["key"])
            k[4] = canonical_backend(k[4])
            out.add(json.dumps(k))
        return out

    assert not jenv.get("unsupported") and len(jenv["entries"]) == 4
    assert {e["key"][4] for e in penv["entries"]} == {"torch"}
    assert keys(penv) == keys(jenv)


def test_importers_degrade_the_other_packages_envelope():
    jsrv, psrv = _warm_servers()
    try:
        jenv, penv = jsrv.export_warm_state(), psrv.export_warm_state()
        n = len(jenv["entries"])
        # The port's importer: an envelope naming jax and no torch.
        got = psrv.import_warm_state(copy.deepcopy(jenv))
        assert got == {"imported": 0, "fallbacks": n,
                       "reasons": {"version_skew": n}}
        # The JAX importer: an envelope naming torch and no jax.
        got = jsrv.import_warm_state(copy.deepcopy(penv))
        assert got == {"imported": 0, "fallbacks": n,
                       "reasons": {"version_skew": n}}
        for srv in (jsrv, psrv):
            c = srv.registry.snapshot()["counters"]
            assert c["ctrl_warmstart_fallbacks_total"] == n
            assert c.get("ctrl_warmstart_imported_total", 0) == 0
    finally:
        jsrv.close()
        psrv.close()
