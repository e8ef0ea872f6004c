"""Request-scoped trace context, the flight recorder and the event log of
the port, against the JAX package's.

The port's ``obs.context``, ``obs.flight`` and ``obs.events`` are copies
of the JAX package's with their semantics unchanged (the serving and
streaming slices will bind and install them); each case here runs the same
calls through both and compares what they record, dump and emit, field for
field. The net, fed and serve cases of the JAX file come with those
slices.
"""

import json
import os
from io import StringIO

import pytest

from tpu_stencil import obs as jobs
from tpu_stencil.obs import context as jctx
from tpu_stencil.obs import events as jevents
from tpu_stencil.obs import flight as jflight
from tpu_stencil.obs import tracing as jtracing
from tpu_stencil_torch import obs
from tpu_stencil_torch.obs import context as octx
from tpu_stencil_torch.obs import events as oevents
from tpu_stencil_torch.obs import export as oexport
from tpu_stencil_torch.obs import flight as oflight
from tpu_stencil_torch.obs import tracing as otracing

PKGS = {
    "port": (obs, octx, oevents, oflight, otracing),
    "jax": (jobs, jctx, jevents, jflight, jtracing),
}


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def test_env_names_carry_the_port_prefix():
    assert oflight.ENV_SPOOL == "TPU_STENCIL_TORCH_FLIGHTREC_DIR"
    assert oevents.ENV_VAR == "TPU_STENCIL_TORCH_EVENT_LOG"
    assert (octx.TRACE_HEADER, octx.SPAN_HEADER) == (jctx.TRACE_HEADER,
                                                     jctx.SPAN_HEADER)


def test_context_mint_bind_adopt():
    ctx = octx.fresh()
    assert octx.valid_id(ctx.trace_id) and len(ctx.trace_id) == 32
    assert octx.valid_id(ctx.span_id) and len(ctx.span_id) == 16
    assert octx.current() is None
    with octx.bind(ctx):
        assert octx.current() is ctx
        inner = octx.fresh()
        with octx.bind(inner):
            assert octx.current() is inner
        assert octx.current() is ctx
    assert octx.current() is None
    adopted = octx.from_headers({"X-Trace-Id": ctx.trace_id,
                                 "X-Span-Id": ctx.span_id})
    assert adopted.trace_id == ctx.trace_id
    assert adopted.span_id != ctx.span_id
    assert adopted.parent_span_id == ctx.span_id
    assert octx.headers_for(adopted) == jctx.headers_for(
        jctx.TraceContext(adopted.trace_id, adopted.span_id))
    for bad in ("x" * 65, "abc def", "a/b", "", None, "\x00"):
        assert octx.valid_id(bad) is jctx.valid_id(bad) is False
        minted = octx.from_headers({"X-Trace-Id": bad})
        assert minted.trace_id != bad and octx.valid_id(minted.trace_id)
    assert octx.frame_context(3).trace_id == jctx.frame_context(3).trace_id


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_spans_carry_bound_context_into_both_sinks(pkg):
    o, ctxm, _, flight, _ = PKGS[pkg]
    rec = flight.install()
    o.enable()
    ctx = ctxm.fresh()
    with ctxm.bind(ctx):
        with o.span("net.request", "net"):
            pass
    with o.span("net.request", "net"):
        pass
    ring = rec.spans_for(ctx.trace_id)
    assert len(ring) == 1 and ring[0].span_id == ctx.span_id
    traced = [r for r in o.get_tracer().spans()
              if r.trace_id == ctx.trace_id]
    assert len(traced) == 1 and traced[0] is ring[0]


def test_flight_ring_and_tree_match_jax():
    recs = {}
    for pkg in ("port", "jax"):
        _, _, _, flight, tracing = PKGS[pkg]
        ring = flight.FlightRecorder(capacity=16)
        for i in range(50):
            ring.record(tracing.SpanRecord(
                name=f"s{i}", cat="t", t0=float(i), t1=float(i) + 1 + (i % 3),
                tid=i % 2, tname="t", depth=i % 2, args={"i": i}))
        recs[pkg] = [flight.span_dict(r) for r in ring.snapshot()]
        assert [r["name"] for r in recs[pkg]] == [f"s{i}"
                                                   for i in range(34, 50)]
    assert recs["port"] == recs["jax"]
    assert oflight.build_tree(recs["port"]) == jflight.build_tree(recs["jax"])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_flight_dump_and_spool_cap(tmp_path, monkeypatch, pkg):
    o, ctxm, _, flight, _ = PKGS[pkg]
    monkeypatch.setenv(flight.ENV_SPOOL, str(tmp_path))
    rec = flight.install()
    ctx = ctxm.fresh()
    with ctxm.bind(ctx):
        with o.span("net.request", "net"):
            pass
    doc = json.loads(open(rec.dump("slow_request", trace_id=ctx.trace_id,
                                   tier="net", threshold_s=0.5)).read())
    assert (doc["trigger"], doc["trace_id"], doc["scope"],
            doc["span_count"]) == ("slow_request", ctx.trace_id, "trace", 1)
    assert sorted(doc) == ["info", "schema_version", "scope", "span_count",
                           "spans", "tier", "trace_id", "trigger", "ts_unix"]
    for _ in range(flight.SPOOL_CAP + 10):
        rec.dump("slow_request", trace_id=ctx.trace_id)
    files = [n for n in os.listdir(tmp_path) if n.endswith(".json")]
    assert len(files) == flight.SPOOL_CAP == jflight.SPOOL_CAP
    index = flight.spool_index(None)
    assert index[0]["trigger"] == "slow_request"
    assert json.loads(flight.spool_read(None, index[0]["file"]))
    assert flight.spool_read(None, "../evil.json") is None
    assert flight.dropped_total() == 11


def test_trace_scoped_dump_falls_back_to_recent_ring(tmp_path, monkeypatch):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path))
    rec = oflight.install()
    with obs.span("net.route", "net"):
        pass
    doc = json.loads(open(rec.dump("breaker_open", trace_id="a" * 32,
                                   tier="fed")).read())
    assert doc["scope"] == "recent" and doc["span_count"] >= 1


def test_trigger_silenced_under_scratch_registry(tmp_path, monkeypatch):
    monkeypatch.setenv(oflight.ENV_SPOOL, str(tmp_path))
    oflight.install()
    buf = StringIO()
    oevents.set_stream(buf)
    with otracing.scratch_registry():
        assert oflight.trigger("witness_mismatch", trace_id="frame-3",
                               tier="stream") is None
    assert not list(tmp_path.iterdir()) and buf.getvalue() == ""
    assert oflight.trigger("witness_mismatch", trace_id="frame-3",
                           tier="stream")
    assert list(tmp_path.iterdir()) and buf.getvalue()


def _event_line(pkg, **fields):
    _, _, events, _, _ = PKGS[pkg]
    buf = StringIO()
    events.set_stream(buf)
    events.emit("fed.forward", trace_id="abc123", tier="fed",
                verdict="timeout", duration_s=1.25, host="h2", **fields)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    doc.pop("ts_unix")
    return doc


def test_event_lines_match_jax():
    port = _event_line("port", weird=object(), skipped=None)
    assert port == _event_line("jax", weird=object(), skipped=None) | {
        "weird": port["weird"]}
    assert isinstance(port["weird"], str) and "skipped" not in port


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_trigger_without_recorder_only_emits_event(pkg):
    _, _, events, flight, _ = PKGS[pkg]
    buf = StringIO()
    events.set_stream(buf)
    assert flight.get() is None
    assert flight.trigger("breaker_open", trace_id="t1", tier="fed",
                          host="h1") is None
    line = json.loads(buf.getvalue().strip())
    assert line["event"] == "flightrec.breaker_open" and line["host"] == "h1"


def test_export_per_trace_filter_and_shape(tmp_path):
    obs.enable()
    a, b = octx.fresh(), octx.fresh()
    with octx.bind(a), obs.span("net.request", "net"):
        pass
    with octx.bind(b), obs.span("net.request", "net"):
        pass
    path = oexport.write_chrome_trace(str(tmp_path / "one.json"),
                                      obs.get_tracer(), trace_id=a.trace_id)
    evs = [e for e in json.load(open(path))["traceEvents"]
           if e.get("ph") == "X"]
    assert len(evs) == 1 and evs[0]["args"]["trace_id"] == a.trace_id
    assert set(evs[0]) == {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                           "args"}
    meta = [e for e in json.load(open(path))["traceEvents"]
            if e.get("ph") == "M"]
    assert {m["name"] for m in meta} == {"process_name", "thread_name"}
    path_all = oexport.write_chrome_trace(str(tmp_path / "all.json"),
                                          obs.get_tracer())
    assert len([e for e in json.load(open(path_all))["traceEvents"]
                if e.get("ph") == "X"]) == 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_event_log_env_appends_lines_to_the_file(tmp_path, monkeypatch, pkg):
    _, _, events, _, _ = PKGS[pkg]
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv(events.ENV_VAR, str(path))
    events.set_stream(None)
    try:
        events.emit("flightrec.slow_request", trace_id="t1", tier="net")
        events.emit("flightrec.breaker_open", tier="fed")
    finally:
        events.reset()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["event"] for ln in lines] == ["flightrec.slow_request",
                                             "flightrec.breaker_open"]
    assert lines[0]["trace_id"] == "t1" and "trace_id" not in lines[1]


def test_spool_http_payload_matches_jax(tmp_path, monkeypatch):
    payloads = {}
    for pkg in ("port", "jax"):
        o, ctxm, _, flight, _ = PKGS[pkg]
        spool = tmp_path / pkg
        spool.mkdir()
        monkeypatch.setenv(flight.ENV_SPOOL, str(spool))
        rec = flight.install()
        with o.span("net.request", "net"):
            pass
        name = os.path.basename(rec.dump("slow_request", tier="net"))
        index = json.loads(flight.spool_http_payload(None, None))
        assert [e["file"] for e in index] == [name]
        one = json.loads(flight.spool_http_payload(None, name))
        assert flight.spool_http_payload(None, "../" + name) is None
        assert flight.spool_http_payload(None, "missing.json") is None
        payloads[pkg] = ({k: v for k, v in index[0].items()
                          if k not in ("file", "ts_unix")},
                         sorted(one), one["trigger"], one["span_count"])
        flight.reset()
    assert payloads["port"] == payloads["jax"]
