"""The port's live telemetry plane against the JAX package's, on the CPU.

Mirrors ``tests/test_telemetry.py``'s ring, sampler, histogram-exemplar,
SLO, profiler-spool and net-endpoint cases (the federation merge waits
for the port's ``fed``): windowed deltas and rates and bucket-delta
quantiles come out of the ring exactly, a counter minted mid-window
deltas from zero, the SLO engine breaches and recovers with its event
lines, exemplars resolve to the request that landed them, the profiler
spool refuses escapes and holds its cap and its one-at-a-time lock, and
the net tier serves ``/debug/timeseries`` and ``/debug/prof``. The same
snapshots drive the JAX package's ring and SLO engine beside the port's,
which must give the same payloads. The overhead case counts (snapshots a
tick, ring bounds, bucket counts); it times nothing.
"""

import glob
import json
import os
import time
import urllib.error
import urllib.request
from io import StringIO

import numpy as np
import pytest
import torch

from tpu_stencil import filters as jfilters
from tpu_stencil.config import NetConfig as JNetConfig
from tpu_stencil.obs import slo as jslo
from tpu_stencil.obs import timeseries as jts
from tpu_stencil.ops import stencil as jstencil
from tpu_stencil.serve.metrics import Registry as JRegistry
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import NetConfig
from tpu_stencil_torch.obs import context as octx
from tpu_stencil_torch.obs import events as oevents
from tpu_stencil_torch.obs import exposition
from tpu_stencil_torch.obs import flight as oflight
from tpu_stencil_torch.obs import prof as oprof
from tpu_stencil_torch.obs import slo as oslo
from tpu_stencil_torch.obs import timeseries as ots
from tpu_stencil_torch.resilience import faults
from tpu_stencil_torch.serve.metrics import Histogram, Registry

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

CPU = torch.device("cpu")
EDGES = (8, 16, 32, 64)
REPS = 2


@pytest.fixture(autouse=True)
def _fresh_obs(tmp_path, monkeypatch):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path / "flightrec"))
    obs.reset()
    yield
    obs.reset()
    faults.clear()


def _golden(img, reps, name="gaussian"):
    return jstencil.reference_stencil_numpy(
        img, jfilters.get_filter(name), reps
    )


def _post(url, img, reps, http_timeout=120.0):
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    headers = {"X-Width": str(w), "X-Height": str(h),
               "X-Reps": str(reps), "X-Channels": str(channels)}
    req = urllib.request.Request(url + "/v1/blur", data=img.tobytes(),
                                 headers=headers, method="POST")
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


def _post_raw(url, path, http_timeout=60.0):
    req = urllib.request.Request(url + path, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=http_timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def make_net(tmp_path):
    """A frontend factory on ``[cpu] * replicas``; every frontend it
    starts is drained and closed when the test ends."""
    started = []

    def make(**overrides):
        from tpu_stencil_torch.net import NetFrontend

        kw = dict(port=0, replicas=1, bucket_edges=EDGES, max_queue=64,
                  prof_dir=str(tmp_path / "profspool"))
        kw.update(overrides)
        fe = NetFrontend(NetConfig(**kw), devices=[CPU] * kw["replicas"])
        started.append(fe)
        return fe.start()

    yield make
    for fe in started:
        fe.close()


# -- time-series ring ---------------------------------------------------


def _snap(counters=None, gauges=None, histograms=None):
    return {
        "counters": counters or {},
        "gauges": {k: {"value": v, "peak": v}
                   for k, v in (gauges or {}).items()},
        "histograms": histograms or {},
    }


def _both_rings(interval_s=1.0):
    return ots.TimeSeriesRing(interval_s), jts.TimeSeriesRing(interval_s)


def test_ring_window_deltas_rates_and_gauges():
    ring, jring = _both_rings()
    for i in range(11):
        for r in (ring, jring):
            r.append(
                _snap(counters={"requests_total": 10 * i},
                      gauges={"queue_depth": i % 4}),
                t_mono=100.0 + i, ts_unix=1000.0 + i,
            )
    out = ring.window(10.0)
    assert out["schema_version"] == ots.SCHEMA_VERSION
    assert out["samples"] == 11 and out["span_s"] == 10.0
    c = out["counters"]["requests_total"]
    assert c["delta"] == 100 and c["rate_per_s"] == pytest.approx(10.0)
    g = out["gauges"]["queue_depth"]
    assert g["min"] == 0 and g["max"] == 3 and g["last"] == 10 % 4
    out5 = ring.window(5.0)
    assert out5["counters"]["requests_total"]["delta"] == 60
    assert out == jring.window(10.0) and out5 == jring.window(5.0)


def test_ring_counter_minted_mid_window_baselines_at_zero():
    ring = ots.TimeSeriesRing(interval_s=1.0)
    ring.append(_snap(counters={}), t_mono=0.0, ts_unix=0.0)
    ring.append(_snap(counters={"late_total": 7}), t_mono=1.0, ts_unix=1.0)
    out = ring.window(60.0)
    assert out["counters"]["late_total"]["delta"] == 7
    assert ring.counter_delta("late_total", 60.0) == 7
    assert ring.counter_delta(("absent_total", "late_total"), 60.0) == 7


def test_ring_histogram_bucket_deltas_and_p99():
    def hist(count, s, b_01, b_inf):
        return {"request_latency_seconds": {
            "count": count, "sum": s,
            "buckets": {"0.1": b_01, "+Inf": b_inf},
        }}

    ring, jring = _both_rings()
    for r in (ring, jring):
        r.append(_snap(histograms=hist(0, 0.0, 0, 0)), t_mono=0.0,
                 ts_unix=0.0)
        r.append(_snap(histograms=hist(100, 5.0, 99, 100)), t_mono=10.0,
                 ts_unix=10.0)
    out = ring.window(60.0)
    h = out["histograms"]["request_latency_seconds"]
    assert h["count_delta"] == 100
    assert h["rate_per_s"] == pytest.approx(10.0)
    assert h["mean_s"] == pytest.approx(0.05)
    assert h["p99_est_s"] == pytest.approx(0.1)
    deltas = ring.bucket_deltas("request_latency_seconds", 60.0)
    assert deltas == {"0.1": 99, "+Inf": 100}
    assert ring.bucket_deltas("absent", 60.0) is None
    assert out == jring.window(60.0)


def test_quantile_inf_bucket_reports_largest_finite_bound():
    q = ots.quantile_from_bucket_deltas({"0.5": 0, "+Inf": 10}, 0.99)
    assert q == 0.5
    assert ots.quantile_from_bucket_deltas({}, 0.99) == 0.0
    assert ots.quantile_from_bucket_deltas({"+Inf": 0}, 0.99) == 0.0
    for d in ({"0.5": 0, "+Inf": 10}, {"0.01": 3, "0.1": 9, "+Inf": 10}):
        for q in (0.5, 0.9, 0.99):
            assert (ots.quantile_from_bucket_deltas(d, q)
                    == jts.quantile_from_bucket_deltas(d, q))


def test_sampler_swallows_snapshot_and_callback_failures():
    calls = {"n": 0, "cb": 0}

    def snap_fn():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("scrape blew up")
        return _snap(counters={"x_total": calls["n"]})

    s = ots.Sampler(snap_fn, interval_s=0.01)

    def bad_cb(ring):
        calls["cb"] += 1
        raise ValueError("SLO hook blew up")

    s.on_sample.append(bad_cb)
    s.sample_once()
    s.sample_once()  # snapshot raises: no sample, no callback, no crash
    s.sample_once()
    assert len(s.ring) == 2 and calls["cb"] == 2


def test_sampler_thread_starts_with_a_sample_and_stops():
    s = ots.Sampler(lambda: _snap(counters={"x_total": 1}), interval_s=0.01)
    s.start()
    try:
        assert len(s.ring) >= 1  # a fresh process answers its first scrape
        deadline = time.monotonic() + 30
        while len(s.ring) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(s.ring) >= 3
    finally:
        s.stop()
    assert s._thread is None


def test_telemetry_cost_is_bounded_by_construction():
    # The JAX package's overhead bound as counts: one registry snapshot a
    # tick, a ring bounded by retention over interval, one bucket walk an
    # observe (cumulative counts exact), the exemplar kept per bucket.
    reg = Registry()
    for i in range(100):
        reg.counter(f"c{i}_total").inc(i)
    hist = reg.histogram("h0_seconds")
    snaps = {"n": 0}

    def snap():
        snaps["n"] += 1
        return reg.snapshot()

    sampler = ots.Sampler(snap, interval_s=1.0, retention_s=10.0)
    for _ in range(50):
        sampler.sample_once()
    assert snaps["n"] == 50
    assert len(sampler.ring) == 11  # retention / interval + 1
    with octx.bind(octx.fresh()):
        for i in range(2000):
            hist.observe(0.001 * (i % 40))
    b = hist.snapshot()["buckets"]
    assert b["+Inf"] == 2000 and b["0.001"] == 100  # 0.0 and 0.001
    assert set(hist.snapshot()["exemplars"]) <= set(b)
    out = sampler.ring.window(60.0)
    assert out["counters"]["c99_total"]["delta"] == 0


# -- histogram buckets + exemplars --------------------------------------


def test_histogram_buckets_cumulative_with_exemplar():
    h = Histogram(cap=64)
    ctx = octx.fresh()
    with octx.bind(ctx):
        h.observe(0.003)   # lands in le=0.005
    h.observe(100.0)       # +Inf only, no context bound -> no exemplar
    snap = h.snapshot()
    b = snap["buckets"]
    assert b["0.001"] == 0 and b["0.005"] == 1 and b["+Inf"] == 2
    assert b["30.0"] == 1
    ex = snap["exemplars"]
    assert ex == {"0.005": {"trace_id": ctx.trace_id, "value": 0.003}}


def test_exposition_round_trips_buckets_and_exemplars():
    reg = Registry()
    reg.counter("requests_total").inc(3)
    h = reg.histogram("request_latency_seconds")
    with octx.bind(octx.fresh()):
        h.observe(0.02)
    snap = reg.snapshot()
    text = exposition.render_text(snap, prefix="tpu_stencil_net")
    assert ("# TYPE tpu_stencil_net_request_latency_seconds histogram"
            in text)
    assert 'request_latency_seconds_bucket{le="+Inf"} 1' in text
    assert ' # {trace_id="' in text
    assert exposition.parse_text(text, prefix="tpu_stencil_net") == snap


# -- SLO engine ---------------------------------------------------------


def _err_objective(mod=oslo, budget=0.05):
    return mod.Objective(
        name="error_ratio", kind="error_ratio",
        bad=("responses_5xx_total",),
        total=("responses_2xx_total", "responses_5xx_total"),
        budget=budget,
    )


def _feed(ring, t, ok, bad):
    ring.append(_snap(counters={"responses_2xx_total": ok,
                                "responses_5xx_total": bad}),
                t_mono=t, ts_unix=t)


def test_slo_engine_breach_fires_event_and_recovers():
    buf = StringIO()
    oevents.set_stream(buf)
    reg = Registry()
    ring = ots.TimeSeriesRing(interval_s=1.0)
    eng = oslo.SloEngine([_err_objective()], reg, tier="net",
                         fast_window_s=10.0, slow_window_s=30.0)
    _feed(ring, 0.0, 0, 0)
    _feed(ring, 1.0, 100, 0)
    eng.evaluate(ring)
    assert not eng.degraded()
    _feed(ring, 2.0, 150, 100)
    eng.evaluate(ring)
    assert eng.degraded()
    assert reg.snapshot()["counters"]["slo_breaches_total"] == 1
    gauges = reg.snapshot()["gauges"]
    assert gauges["degraded"]["value"] == 1
    assert gauges["slo_error_ratio_fast_burn_rate"]["value"] >= 6.0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    breach = [e for e in events if e["event"] == "slo.breach"]
    assert breach and breach[0]["objective"] == "error_ratio"
    assert breach[0]["verdict"] == "degraded"
    st = eng.statusz()
    assert st["degraded"] and st["objectives"]["error_ratio"]["breached"]
    for t in range(3, 9):
        _feed(ring, float(t), 150 + 100 * t, 100 + 8 * t)
    eng.evaluate(ring)
    assert eng.degraded()
    for t in range(9, 25):
        _feed(ring, float(t), 1500 + 500 * t, 148)
    eng.evaluate(ring)
    assert not eng.degraded()
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert any(e["event"] == "slo.recover" for e in events)
    assert reg.snapshot()["gauges"]["degraded"]["value"] == 0


def test_slo_engine_statusz_and_gauges_equal_the_jax_package():
    # One seeded counter stream through both engines: the same breached
    # flags, burns, degraded bit and gauges at every tick.
    rng = np.random.default_rng(3)
    reg, jreg = Registry(), JRegistry()
    ring, jring = _both_rings()
    eng = oslo.SloEngine([_err_objective()], reg, tier="net",
                         fast_window_s=5.0, slow_window_s=15.0)
    jeng = jslo.SloEngine([_err_objective(jslo)], jreg, tier="net",
                          fast_window_s=5.0, slow_window_s=15.0)
    ok = bad = 0
    for t in range(60):
        ok += int(rng.integers(0, 50))
        bad += int(rng.integers(0, 12)) if 15 <= t < 35 else 0
        _feed(ring, float(t), ok, bad)
        _feed(jring, float(t), ok, bad)
        eng.evaluate(ring)
        jeng.evaluate(jring)
        assert eng.statusz() == jeng.statusz(), t
        g = {k: v["value"] for k, v in reg.snapshot()["gauges"].items()}
        jg = {k: v["value"] for k, v in jreg.snapshot()["gauges"].items()}
        assert g == jg, t


def test_slo_latency_objective_counts_bucket_tail():
    obj = oslo.Objective(name="latency_p99", kind="latency",
                         histogram="request_latency_seconds",
                         threshold_s=0.1, budget=0.01)
    ring = ots.TimeSeriesRing(interval_s=1.0)

    def hist(b_01, b_inf):
        return {"request_latency_seconds": {
            "count": b_inf, "sum": 0.0,
            "buckets": {"0.1": b_01, "+Inf": b_inf},
        }}

    ring.append(_snap(histograms=hist(0, 0)), t_mono=0.0, ts_unix=0.0)
    ring.append(_snap(histograms=hist(95, 100)), t_mono=10.0,
                ts_unix=10.0)
    assert obj.burn(ring, 60.0) == pytest.approx(5.0)
    empty = ots.TimeSeriesRing(interval_s=1.0)
    assert obj.burn(empty, 60.0) == 0.0


def test_default_net_objectives_follow_config_knobs():
    cfg = NetConfig(slo_error_budget=0.02, slo_latency_p99_s=0.0)
    objs = oslo.default_net_objectives(cfg)
    assert [o.name for o in objs] == ["error_ratio", "witness_mismatch"]
    assert objs[0].budget == 0.02
    cfg = NetConfig(slo_latency_p99_s=0.25)
    names = [o.name for o in oslo.default_net_objectives(cfg)]
    assert "latency_p99" in names
    # The JAX package derives the same objectives from the same knobs.
    for kw in (dict(slo_error_budget=0.02), dict(slo_latency_p99_s=0.25),
               dict(slo_error_budget=0.001)):
        port = oslo.default_net_objectives(NetConfig(**kw))
        jax = jslo.default_net_objectives(JNetConfig(**kw))
        assert ([dataclass_tuple(o) for o in port]
                == [dataclass_tuple(o) for o in jax])
        assert ([dataclass_tuple(o) for o in
                 oslo.default_fed_objectives(NetConfig(**kw))]
                == [dataclass_tuple(o) for o in
                    jslo.default_fed_objectives(JNetConfig(**kw))])


def dataclass_tuple(o):
    return (o.name, o.kind, o.bad, o.total, o.histogram, o.threshold_s,
            o.budget, o.min_events)


# -- profiler spool -----------------------------------------------------


def test_prof_spool_read_refuses_escape(tmp_path):
    spool = tmp_path / "profspool"
    run = spool / "prof-1"
    run.mkdir(parents=True)
    (run / "trace.json").write_bytes(b"{}")
    (tmp_path / "secret.txt").write_bytes(b"nope")
    assert oprof.spool_read(str(spool), "prof-1/trace.json") == b"{}"
    assert oprof.spool_read(str(spool), "../secret.txt") is None
    assert oprof.spool_read(str(spool), "/etc/hostname") is None
    assert oprof.spool_read(None, "prof-1/trace.json") is None
    idx = oprof.spool_list(str(spool))
    assert idx["schema_version"] == 1 and idx["spool_cap"] == oprof.SPOOL_CAP
    assert [r["run"] for r in idx["runs"]] == ["prof-1"]


def test_prof_available_is_import_only_and_capture_clamps_and_prunes(
        tmp_path):
    ok, reason = oprof.available()
    assert ok and reason == ""
    spool = tmp_path / "profspool"
    spool.mkdir()
    for i in range(oprof.SPOOL_CAP):
        (spool / f"prof-{i:04d}").mkdir()
    run = oprof.capture(0.0, str(spool))  # clamps up to MIN_SECONDS
    assert run["seconds"] == oprof.MIN_SECONDS
    assert [f["path"] for f in run["files"]] == [
        f"{run['run']}/{oprof.TRACE_FILE}"]
    trace = json.loads(oprof.spool_read(str(spool), run["files"][0]["path"]))
    assert "traceEvents" in trace
    runs = [r["run"] for r in oprof.spool_list(str(spool))["runs"]]
    assert len(runs) == oprof.SPOOL_CAP and "prof-0000" not in runs
    assert run["run"] in runs
    assert oprof._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="busy"):
            oprof.capture(0.05, str(spool))
    finally:
        oprof._capture_lock.release()


# -- net tier integration -----------------------------------------------


def test_net_timeseries_exemplar_and_prof_endpoints(make_net, rng):
    fe = make_net(sample_interval_s=0.05)
    img = rng.integers(0, 256, (12, 10), dtype=np.uint8)
    status, body, headers = _post(fe.url, img, REPS)
    assert status == 200
    tid = headers["X-Trace-Id"]
    assert body == _golden(img, REPS).tobytes()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        status, raw = _get(fe.url, "/debug/timeseries?window=60")
        assert status == 200
        doc = json.loads(raw)
        if doc["counters"].get("responses_2xx_total",
                               {}).get("delta", 0) >= 1:
            break
        time.sleep(0.05)
    assert doc["schema_version"] == 1 and doc["source"] == "net"
    assert doc["counters"]["responses_2xx_total"]["rate_per_s"] > 0
    assert "request_latency_seconds" in doc["histograms"]
    assert doc["slo"] is not None and not doc["slo"]["degraded"]
    assert _get(fe.url, "/debug/timeseries?window=bogus")[0] == 400
    assert _get(fe.url, "/debug/timeseries?window=-5")[0] == 400
    status, metrics = _get(fe.url, "/metrics")
    text = metrics.decode()
    assert status == 200 and "_bucket{le=" in text
    exline = [ln for ln in text.splitlines()
              if "request_latency_seconds_bucket" in ln
              and f'# {{trace_id="{tid}"}}' in ln]
    assert exline, "request's exemplar missing from /metrics"
    status, spans = _get(fe.url, f"/debug/trace/{tid}")
    assert status == 200 and json.loads(spans)["trace_id"] == tid
    assert "flightrec_dropped_total 0" in text
    # The profiler: torch.profiler is available here, so a capture works
    # end to end and is listed and fetchable.
    assert oprof.available()[0]
    status, raw = _post_raw(fe.url, "/debug/prof?seconds=0.05")
    assert status == 200
    run = json.loads(raw)
    assert run["files"], "capture produced no trace files"
    path = run["files"][0]["path"]
    assert _get(fe.url, f"/debug/prof/{path}")[0] == 200
    assert _get(fe.url, "/debug/prof/../../etc/hostname")[0] == 404
    idx = json.loads(_get(fe.url, "/debug/prof")[1])
    assert idx["available"] and idx["runs"]
    assert oprof._capture_lock.acquire(blocking=False)
    try:
        status, raw = _post_raw(fe.url, "/debug/prof?seconds=0.05")
        assert status == 409
    finally:
        oprof._capture_lock.release()
    assert _post_raw(fe.url, "/debug/prof?seconds=bogus")[0] == 400
    st = json.loads(_get(fe.url, "/statusz")[1])
    assert st["slo"]["degraded"] is False
    assert st["timeseries"]["samples"] >= 1
    assert st["flightrec_dropped_total"] == 0


def test_net_prof_404_when_off_or_unavailable(make_net, monkeypatch):
    fe = make_net(prof_dir=None)
    assert _post_raw(fe.url, "/debug/prof?seconds=0.05")[0] == 404
    assert _get(fe.url, "/debug/prof")[0] == 404
    fe2 = make_net()
    monkeypatch.setattr(oprof, "available",
                        lambda: (False, "torch profiler unavailable: X"))
    status, raw = _post_raw(fe2.url, "/debug/prof?seconds=0.05")
    assert status == 404 and b"unavailable" in raw


def test_net_timeseries_404_when_sampler_off(make_net):
    fe = make_net(sample_interval_s=0.0)
    status, raw = _get(fe.url, "/debug/timeseries")
    assert status == 404
    assert b"sampler" in raw
    assert _get(fe.url, "/healthz")[1] == b"ok\n"


def test_flightrec_drop_counter_counts_spool_cap(tmp_path, monkeypatch):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path))
    buf = StringIO()
    oevents.set_stream(buf)
    rec = oflight.install(capacity=64, spool_dir=str(tmp_path))
    assert oflight.dropped_total() == 0
    for i in range(oflight.SPOOL_CAP + 3):
        rec.dump("slow_request", trace_id=f"t{i}", tier="net")
    assert oflight.dropped_total() == 3
    assert len(glob.glob(str(tmp_path / "*.json"))) == oflight.SPOOL_CAP
    drops = [json.loads(line) for line in buf.getvalue().splitlines()
             if json.loads(line)["event"] == "flightrec.spool_drop"]
    assert len(drops) == 1
    assert drops[0]["verdict"] == "capped"


@pytest.mark.chaos
def test_corrupt_results_flip_healthz_degraded_with_a_slo_dump(
        make_net, rng, tmp_path, monkeypatch):
    # Every result corrupted with every result witnessed: the replica is
    # convicted at once, the witness-mismatch objective burns, /healthz
    # answers 200 "degraded", a slo.breach event names a traced request
    # and a slo_burn dump lands in the spool. Counted, not timed: the
    # test waits for each signal.
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path))
    buf = StringIO()
    oevents.set_stream(buf)
    faults.configure("integrity.corrupt_result:times=0:p=1.0")
    fe = make_net(sample_interval_s=0.05, slo_fast_window_s=2.0,
                  slo_slow_window_s=4.0, witness_rate=1.0,
                  warm_fleet=False, quarantine_after=1,
                  probe_interval_s=0.0)
    img = rng.integers(0, 256, (12, 10), dtype=np.uint8)
    assert _post(fe.url, img, REPS)[0] == 200
    deadline = time.monotonic() + 30.0
    while (_get(fe.url, "/healthz")[1] != b"degraded\n"
           and time.monotonic() < deadline):
        time.sleep(0.05)
    status, health = _get(fe.url, "/healthz")
    assert status == 200 and health == b"degraded\n"
    # Quarantined with no prober: the next request is 503 unroutable.
    assert _post(fe.url, img, REPS)[0] == 503
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    breaches = [e for e in events if e["event"] == "slo.breach"]
    assert breaches and breaches[0]["tier"] == "net"
    assert breaches[0]["trace_id"]
    dumps = glob.glob(str(tmp_path / "*-slo_burn-*.json"))
    assert dumps, os.listdir(str(tmp_path))
    st = json.loads(_get(fe.url, "/statusz")[1])
    assert st["slo"]["degraded"] is True
