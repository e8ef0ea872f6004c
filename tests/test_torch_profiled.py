"""The profiler sink of the port's tracing, the job path's spans on the
profiler's clock, and the benchmark's three readers of them.

While a ``torch.profiler`` collects, every span and the profiler-only
``model.place``, ``model.issue`` and ``host.gc`` are kept in the sink,
stamped on the profiler's base (``time.time_ns()``). Off the profiler the
span call is the shared no-op; the ``--trace`` tracer and the flight ring
never see a profiler-only span. The readers
(``benchmark/metrics/{issue_ms,idle_program_pct,idle_gc_pct}.mpx.py``) are
checked on a synthetic capture against hand-computed answers.
"""

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import program_spans, spec
from benchmark.harness.cell import Window
from benchmark.harness.trace import Capture, DeviceOp
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.obs import tracing
from tpu_stencil_torch.obs import prof as oprof

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 48, 40
READERS = ("issue_ms.mpx", "idle_program_pct.mpx", "idle_gc_pct.mpx")


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    obs.reset()


def _img(channels):
    shape = (H, W) + ((3,) if channels == 3 else ())
    return np.random.default_rng(5).integers(0, 256, shape, np.uint8)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _program_spans(lo=0, hi=1 << 62):
    return [r for r in tracing.profiled_spans(lo, hi)
            if r.name.startswith("model.")]


# -- (a) the clock ------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("channels", [1, 3])
def test_job_spans_lie_inside_the_profilers_own_range(channels, backend):
    img = _img(channels)
    engine = tdriver.prepare_engine(
        IteratedConv2D("gaussian", backend=backend, device=CPU), img,
        calls=[5])
    x = torch.from_numpy(img)
    with _cpu_profile() as p:
        with record_function("outer"):
            y = engine.step_fn(x, 5)
    outer = [e for e in p.profiler.kineto_results.events()
             if e.name() == "outer"]
    assert len(outer) == 1
    lo, hi = outer[0].start_ns(), outer[0].end_ns()
    recs = _program_spans()
    assert [r.name for r in recs] == ["model.place", "model.issue"]
    for r in recs:
        assert lo <= r.start_ns <= r.end_ns <= hi, (r, lo, hi)
        assert r.tid == threading.get_native_id() and r.cat == "model"
    place, issue = recs
    assert place.end_ns <= issue.start_ns
    assert place.args == {"bytes": img.nbytes}
    assert issue.args["reps"] == 5
    assert issue.args["launches"] == 0  # the CPU runs no kernel
    assert issue.args["kernel"] == backend
    np.testing.assert_array_equal(
        y.numpy(), engine.step_fn(x, 5).numpy())


# -- (b) the off path ---------------------------------------------------


def test_span_is_the_shared_noop_without_a_profiler_or_sink():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not tracing.sinks_active()
    assert tracing.span("x", "y") is tracing._NULL
    assert tracing.span("x", "y", profiler_only=True) is tracing._NULL
    assert not tracing._NULL.recording
    img = _img(3)
    model = IteratedConv2D("gaussian", backend="pallas", device=CPU)
    model(img, 3)
    model.batch(np.stack([img, img]), 2)
    gc.collect()
    assert tracing.profiled_spans(0, 1 << 62) == []
    assert tracing.profiled_dropped(0, 1 << 62) == 0


@pytest.mark.timing
def test_disabled_span_call_is_cheap():
    """The port's bound on the disabled span call (the JAX package's
    20 us): three global reads and the shared no-op object."""
    n = 100_000
    for profiler_only in (False, True):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("x", "y", profiler_only=profiler_only):
                pass
        per_call = (time.perf_counter() - t0) / n
        assert per_call < 20e-6, f"{per_call * 1e6:.2f} us per span"


# -- (c) parity with the JAX package's --trace spans ----------------------


def test_profiler_only_spans_never_reach_the_tracer_or_flight_ring():
    img = _img(3)
    model = IteratedConv2D("gaussian", backend="pallas", device=CPU)
    obs.enable()
    ring = obs.flight.install()
    try:
        with obs.span("outer", "t"):
            model(img, 2)
        untraced = [r.name for r in obs.get_tracer().spans()]
        obs.enable()
        with _cpu_profile():
            with obs.span("outer", "t"):
                model(img, 2)
        assert [r.name for r in obs.get_tracer().spans()] == untraced
        assert untraced == ["outer"]
        assert [r.name for r in ring.snapshot()] == ["outer", "outer"]
        assert obs.get_tracer().spans()[0].depth == 0
    finally:
        obs.flight.reset()
    recs = tracing.profiled_spans(0, 1 << 62)
    # The ordinary span lands in the profiler sink too, outermost.
    assert [(r.name, r.depth) for r in recs] == [
        ("outer", 0), ("model.place", 1), ("model.issue", 1)]


# -- (d) garbage collection ---------------------------------------------


def test_a_collection_under_the_profiler_is_one_host_gc_span():
    with _cpu_profile():
        t0 = time.time_ns()
        gc.collect()
        t1 = time.time_ns()
    recs = [r for r in tracing.profiled_spans(t0, t1)
            if r.name == "host.gc"]
    assert len(recs) == 1
    assert recs[0].cat == "runtime" and recs[0].args["generation"] == 2
    assert recs[0].args["collected"] >= 0
    assert t0 <= recs[0].start_ns <= recs[0].end_ns <= t1
    gc.collect()  # the profiler has stopped: nothing more is kept
    assert len([r for r in tracing.profiled_spans(0, 1 << 62)
                if r.name == "host.gc"]) == 1


# -- the benchmark's readers ---------------------------------------------


def _ctx(capture, chips=1, done=2):
    win = Window(attempted=done, failed=0, done=done, end_to_end={})
    return spec.MetricContext(env=None, window=win, capture=capture,
                              chips=chips)


def _read(name, ctx):
    return spec.reader(name)(ctx)


def _synthetic(monkeypatch, cap=tracing.PROFILED_CAP, late_ns=0):
    """A 1000 ns window; card 0 runs the copy [10, 70) inside
    model.place and kernels [100, 300) and [400, 600), so it idles
    [0, 10), [70, 100), [300, 400), [600, 1000): 54%. On the calling
    thread model.place [-100, 80), model.issue [80, 350) with a host.gc
    [320, 340) inside it, a host.gc [700, 800) outside any span; on
    another thread a model.issue [400, 500). ``late_ns``: the device's
    timestamps read that much late."""
    sink = tracing.ProfilerSink(cap)
    monkeypatch.setattr(tracing, "_profiled", sink)
    me = threading.get_native_id()
    for rec in [
        ("model.place", "model", me, 0, {"bytes": 9}, -100, 80),
        ("host.gc", "runtime", me, 1, {"generation": 0}, 320, 340),
        ("model.issue", "model", me, 0, {"reps": 3}, 80, 350),
        ("model.issue", "model", me + 1, 0, {"reps": 3}, 400, 500),
        ("host.gc", "runtime", me, 0, {"generation": 2}, 700, 800),
    ]:
        sink.record(tracing.ProfiledSpan(*rec))
    ops = [DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 10, 70),
           DeviceOp("stencil_fused_kernel", 0, 100, 300),
           DeviceOp("stencil_fused_kernel", 0, 400, 600)]
    ops = [DeviceOp(o.name, o.device, o.start_ns + late_ns,
                    o.end_ns + late_ns) for o in ops]
    return sink, Capture(0, 1000, ops, [])


@pytest.mark.parametrize("late_ns", [0, 300])
def test_readers_on_a_synthetic_window(monkeypatch, late_ns):
    _, cap = _synthetic(monkeypatch, late_ns=late_ns)
    # issue self time: (320 - 80) + (350 - 340) here, 100 on the other
    # thread: 350 ns over 2 outputs.
    assert _read("issue_ms.mpx", _ctx(cap)) == pytest.approx(175e-6)
    # Read 300 ns late, the copy [310, 370) bounds the device's offset to
    # [-100 - 310, 80 - 370]: -290 is taken, the operations move to
    # [20, 80), [110, 310), [410, 610), and the shares come out the same.
    # Idle under model.*: place [0, 10) 10 + [70, 80) 10, issue [80,
    # 100) 20 + [300, 320) 20 + [340, 350) 10 = 70 of 1000.
    assert _read("idle_program_pct.mpx", _ctx(cap)) == pytest.approx(7.0)
    # idle under host.gc: [320, 340) 20 + [700, 800) 100 = 120.
    assert _read("idle_gc_pct.mpx", _ctx(cap)) == pytest.approx(12.0)
    # A second card with no operation is idle all through: under model.*
    # 80 + 250 = 330 there, so (70 + 330) / 2 of 1000.
    assert _read("idle_program_pct.mpx", _ctx(cap, chips=2)) == (
        pytest.approx(20.0))
    assert _read("idle_gc_pct.mpx", _ctx(cap, chips=2)) == (
        pytest.approx((120 + 120) / 2 / 10))
    if not late_ns:
        assert _read("device_idle_pct.mpx", _ctx(cap)) == (
            pytest.approx(54.0))


def test_alignment_follows_the_offset_from_copy_to_copy():
    """Two copies, the device's clock 460 to 500 ns late at the first and
    0 ns at the second: each copy's offset is the one nearest the last
    that keeps it inside its model.place, and moves the operations that
    follow it."""
    me = threading.get_native_id()
    spans = [tracing.ProfiledSpan("model.place", "model", me, 0, {}, 0, 100),
             tracing.ProfiledSpan("model.place", "model", me, 0, {}, 1000,
                                  1100)]
    ops = [DeviceOp("Memcpy HtoD", 0, 500, 560),
           DeviceOp("stencil_fused_kernel", 0, 600, 700),
           DeviceOp("Memcpy HtoD", 0, 1010, 1070),
           DeviceOp("stencil_fused_kernel", 0, 1080, 1200)]
    got = program_spans.aligned(Capture(0, 2000, ops, []), spans)
    # bounds [-500, -460] then [-10, 30]: offsets -460, then -10.
    assert [(o.start_ns, o.end_ns) for o in got.ops] == [
        (40, 100), (140, 240), (1000, 1060), (1070, 1190)]
    # No copy to tie the clocks by, or one that cannot fit its span.
    assert program_spans.aligned(Capture(0, 2000, ops[1::2], []),
                                 spans) is None
    short = [spans[0]._replace(end_ns=10), spans[1]]
    assert program_spans.aligned(Capture(0, 2000, ops, []), short) is None


def test_readers_find_nothing_without_a_capture_or_the_sink(monkeypatch):
    _, cap = _synthetic(monkeypatch)
    for name in READERS:
        assert _read(name, _ctx(None)) is None
    monkeypatch.delattr(tracing, "profiled_spans")
    for name in READERS:  # an older program: nothing to read, no raise
        assert _read(name, _ctx(cap)) is None


# -- (e) the cap -----------------------------------------------------------


def test_an_overfilled_sink_counts_its_drops_and_the_readers_give_none(
        monkeypatch):
    sink, cap = _synthetic(monkeypatch, cap=5)
    assert sink.dropped == 0 and tracing.profiled_dropped(0, 1000) == 0
    assert _read("idle_gc_pct.mpx", _ctx(cap)) is not None
    sink.record(tracing.ProfiledSpan("model.place", "model", 0, 0, {},
                                     900, 950))
    assert sink.dropped == 1
    assert len(tracing.profiled_spans(-1000, 2000)) == 5
    assert tracing.profiled_dropped(0, 1000) == 1
    assert tracing.profiled_dropped(200, 1000) == 1  # may overlap
    for name in READERS:
        assert _read(name, _ctx(cap)) is None


def test_the_cap_holds_under_the_profiler(monkeypatch):
    monkeypatch.setattr(tracing, "_profiled", tracing.ProfilerSink(8))
    with _cpu_profile():
        for i in range(20):
            with tracing.span("s", "t", profiler_only=True, i=i):
                pass
    recs = tracing.profiled_spans(0, 1 << 62)
    assert [r.args["i"] for r in recs] == list(range(12, 20))
    assert tracing._profiled.dropped == 12


def test_appends_from_several_threads_are_all_kept():
    def work():
        for _ in range(200):
            with tracing.span("w", "t", profiler_only=True):
                pass

    with _cpu_profile():
        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    recs = [r for r in tracing.profiled_spans(0, 1 << 62) if r.name == "w"]
    assert len(recs) == 800 and len({r.tid for r in recs}) == 4
    assert tracing.profiled_dropped(0, 1 << 62) == 0


# -- the operators' captures ---------------------------------------------


def _x_events(path):
    return [e for e in json.load(open(path))["traceEvents"]
            if e.get("ph") == "X"]


def test_profile_trace_holds_the_programs_spans_in_its_window(tmp_path):
    src = tmp_path / "in.raw"
    _img(3).tofile(src)
    cfg, _ = tconfig.parse_args([str(src), str(W), str(H), "4", "rgb",
                                 "--backend", "pallas",
                                 "--output", str(tmp_path / "out.raw")])
    tdriver.run_job(cfg, devices=[CPU], profile_dir=str(tmp_path / "p"))
    (trace,) = (tmp_path / "p").glob("trace_*.json")
    ev = _x_events(trace)
    window = [e for e in ev if e["name"] == "iterate"]
    assert len(window) == 1
    lo, hi = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    ours = [e for e in ev if e["name"].startswith("model.")]
    assert [e["name"] for e in ours] == ["model.place", "model.issue"]
    for e in ours:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, (e, lo, hi)
        assert e["cat"] == "model"
    # On the profiler's own host track and timebase: the profiler's
    # events of the window's launch lie inside model.issue.
    issue = ours[1]
    assert issue["tid"] == threading.get_native_id()
    inside = [e for e in ev if e.get("cat") == "cpu_op"
              and issue["ts"] <= e["ts"] <= issue["ts"] + issue["dur"]]
    assert inside


def test_debug_prof_capture_holds_the_programs_spans(tmp_path):
    stop = threading.Event()

    def issue():
        while not stop.is_set():
            with tracing.span("model.issue", "model", profiler_only=True):
                time.sleep(0.001)

    th = threading.Thread(target=issue)
    th.start()
    try:
        run = oprof.capture(0.2, str(tmp_path))
    finally:
        stop.set()
        th.join(timeout=30)
    trace = tmp_path / run["run"] / oprof.TRACE_FILE
    names = [e["name"] for e in _x_events(trace)]
    assert "model.issue" in names
