"""The benchmark's edge cell (``rgb5040edge.job.r100``): the upstream's
``edge_detection`` filter ([[1,4,1],[4,8,4],[1,4,1]] / 28) on its largest
RGB image, through the job path, and what traces it.

* The port's kernel path (``IteratedConv2D("edge", backend="pallas")``,
  on the CPU the kernels' plain versions) against the benchmark's plain
  reference (``benchmark/reference/stencil.py``), byte for byte, at reps
  that straddle K1's schedule of fused launches of 8 reps and single-rep
  tails. The reference divides by 28 once in float32 and truncates: that
  is exact for every sum this filter can make, so it is the upstream's
  integer semantics.
* The cell on the CPU at a small size: correct, and its float16 control
  not correct.
* K1's body choice for every registered filter, pinned: the cell
  measures the direct plan's register body ``regs_direct``; the shared
  tile's choice (``int32`` for the direct plans) is unchanged.
* K1's reps by body (``cuda_stencil.body_rep_counts``), the
  ``model.issue`` span's ``plan``, ``bodies`` and ``body_reps``, and
  the reader ``benchmark/metrics/direct_rep_us.mpx.py`` on a synthetic
  capture.

Tolerance: exact bytes (integer plans).
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import control
from benchmark.harness import spec
from benchmark.harness import cell as bcell
from benchmark.harness.trace import Capture, DeviceOp
from benchmark.reference import stencil as reference
from tpu_stencil_torch import filters as tfilters
from tpu_stencil_torch import obs
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.obs import tracing
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering as tlowering

torch.set_num_threads(1)

CELL = "rgb5040edge.job.r100"
CONFIG = "waterfall-rgb-1920x5040-edge"
JOB_CELLS = ("rgb2520.job.r100", "grey5040.job.r100")
BENCH = spec.load()
SMALL = {"width": 48, "height": 40}
CPU = torch.device("cpu")
JOB_METRICS = ["kernel_roofline_pct.mpx", "device_idle_pct.mpx",
               "copy_ms.mpx", "issue_ms.mpx", "idle_program_pct.mpx",
               "idle_gc_pct.mpx"]


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    cs.reset_launch_counts()
    yield
    obs.reset()
    cs.reset_launch_counts()


def _filter():
    return spec.config(BENCH, CONFIG)["filter"]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _plan(name):
    return tlowering.plan_filter(tfilters.get_filter(name))


# ---------------------------------------------------------------------------
# The configuration and the port against the reference
# ---------------------------------------------------------------------------


def test_the_configuration_is_the_ports_edge_filter():
    cfg = spec.config(BENCH, CONFIG)
    assert (cfg["width"], cfg["height"], cfg["channels"]) == (1920, 5040, 3)
    assert cfg["boundary"] == "zero" and cfg["reduced"] == []
    f = tfilters.get_filter(cfg["filter"]["name"])
    np.testing.assert_array_equal(f.taps, np.asarray(cfg["filter"]["taps"]))
    assert f.divisor == cfg["filter"]["divisor"] == 28
    plan = tlowering.plan_filter(f)
    assert plan.kind == "direct_int" and plan.shift is None
    assert cs.plan_supported(plan, 3)


@pytest.mark.parametrize("reps", [1, 7, 8, 9, 17])
@pytest.mark.parametrize("shape", [(37, 29), (40, 48), (33, 51, 3),
                                   (40, 48, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_kernel_path_equals_the_reference(shape, reps):
    f = _filter()
    img = _img(shape, 1000 + reps + sum(shape))
    model = IteratedConv2D(f["name"], backend="pallas", device=CPU)
    assert model.resolved_backend(shape[:2], 1 if len(shape) == 2 else 3) \
        == "pallas"
    got = model(img, reps).numpy()
    want = reference.iterate(img, f["taps"], f["divisor"], reps)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_the_float32_divide_by_28_is_exact():
    """Every sum the filter makes (0 to 255 x 28 on uint8 pixels) divides
    in float32 and truncates to its integer quotient."""
    s = torch.arange(0, 255 * 28 + 1, dtype=torch.int32)
    q = torch.trunc(s.to(torch.float32) / 28.0)
    np.testing.assert_array_equal(q.to(torch.int64).numpy(),
                                  np.arange(0, 255 * 28 + 1) // 28)
    f = _filter()
    assert s.max().item() == 255 * sum(map(sum, f["taps"]))
    assert f["divisor"] == 28


def test_the_job_runs_k1s_direct_register_body_at_the_cells_shape():
    cfg = spec.config(BENCH, CONFIG)
    model = IteratedConv2D(cfg["filter"]["name"], backend="pallas",
                           boundary=cfg["boundary"], device=CPU)
    shape = (cfg["height"], cfg["width"])
    assert model.resolved_config(shape, 3) == ("pallas", "fused")
    loop = model.rep_loop(shape, 3)
    assert loop.launches(100)[0].body == "regs_direct"
    assert (loop.kernel, loop.rows, loop.wc) == ("stencil_fused", 5040, 5760)
    assert cs.launch_schedule(100, loop.fuse) == [8] * 12 + [1] * 4
    # the single-rep tail too: 960 blocks at fuse 1, more than the SMs
    assert {cs.k1_launch(model.plan, loop.rows, loop.wc, 3, d).body
            for d in (8, 1)} == {"regs_direct"}
    assert {r.body for r in loop.launches(100)} == {"regs_direct"}


def test_the_job_runs_k1s_int32_body_at_the_cells_shape():
    # where the job forces a tile height: the shared tile's int32 body,
    # fused and in the single-rep tail
    cfg = spec.config(BENCH, CONFIG)
    model = IteratedConv2D(cfg["filter"]["name"], backend="pallas",
                           boundary=cfg["boundary"],
                           block_h=cs.DEFAULT_BLOCK_H, device=CPU)
    shape = (cfg["height"], cfg["width"])
    assert model.resolved_config(shape, 3) == ("pallas", "fused")
    loop = model.rep_loop(shape, 3)
    assert loop.launches(100)[0].body == "int32"
    assert (loop.kernel, loop.rows, loop.wc, loop.block_h) == (
        "stencil_fused", 5040, 5760, cs.DEFAULT_BLOCK_H)
    assert {cs.k1_launch(model.plan, loop.rows, loop.wc, 3, d,
                         loop.block_h).body
            for d in (loop.fuse, 1)} == {"int32"}
    assert {r.body for r in loop.launches(100)} == {"int32"}


# ---------------------------------------------------------------------------
# The cell on the CPU
# ---------------------------------------------------------------------------


def test_the_cell_is_correct_at_a_small_size():
    out = bcell.run_cell(CELL, 2 ** 31 + 22, 0.3, False, ["cpu"],
                         time.perf_counter(), config_override=SMALL)
    assert out.correct, out.checks
    assert out.checks["mismatched_bytes"]["value"] == 0
    assert out.checks["outputs_compared"]["value"] >= 1
    assert set(out.metrics) == {"setup_s", "mpx_per_s"}


@pytest.mark.parametrize("accumulate", ["float16", "bfloat16"])
def test_the_lower_precision_control_is_not_correct(accumulate):
    checks = control.control_checks(CELL, 2 ** 31 + 22, accumulate, "cpu",
                                    config_override=SMALL)
    assert checks["outputs_compared"]["value"] >= 1
    assert checks["mismatched_bytes"]["value"] > checks[
        "mismatched_bytes"]["limit"]


def test_the_spec_gives_each_job_cell_its_metrics():
    for cell in JOB_CELLS + (CELL,):
        assert [m["name"] for m in spec.end_to_end_for(BENCH, cell)] == [
            "setup_s", "mpx_per_s"]
    for cell in JOB_CELLS:
        assert [m["name"] for m in spec.per_layer_for(BENCH, cell)] == (
            JOB_METRICS)
    assert [m["name"] for m in spec.per_layer_for(BENCH, CELL)] == (
        JOB_METRICS + ["direct_rep_us.mpx"])
    for m in spec.per_layer_for(BENCH, CELL):
        assert callable(spec.reader(m["name"]))
    w = spec.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "job.r100", 1)


# ---------------------------------------------------------------------------
# K1's body per filter
# ---------------------------------------------------------------------------

# (rows, W*C, channels): the three job cells and a small RGB canvas.
LAUNCHES = [(2520, 5760, 3), (5040, 1920, 1), (5040, 5760, 3), (37, 87, 3)]
# filter: (fused_body, k1_launch's body at fuse 8 and 1 on each of LAUNCHES,
# then at fuse 8 with a forced tile height of 16 on the edge cell's).
BODIES = {
    "box": ("acc16", ["acc16"] * 8 + ["acc16"]),
    "edge": ("regs_direct", ["regs_direct"] * 8 + ["int32"]),
    "gaussian": ("regs", ["regs"] * 7 + ["swar"] + ["swar"]),
    "gaussian5": ("regs", ["regs"] * 7 + ["swar"] + ["swar"]),
    "gaussian7": ("acc16", ["acc16"] * 8 + ["acc16"]),
    "gaussian9": ("int32", ["int32"] * 8 + ["int32"]),
    "identity": ("swar", ["swar"] * 8 + ["swar"]),
    "soft_blur": ("regs_direct", ["regs_direct"] * 8 + ["int32"]),
}


def test_every_registered_filter_is_pinned():
    assert set(tfilters.FILTERS.keys()) <= set(BODIES)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_k1s_body_choice_per_filter(name):
    plan = _plan(name)
    fused, launches = BODIES[name]
    assert cs.fused_body(plan) == fused
    got = [cs.k1_launch(plan, rows, wc, ch, fz).body
           for rows, wc, ch in LAUNCHES for fz in (8, 1)]
    got.append(cs.k1_launch(plan, 5040, 5760, 3, 8, 16).body)
    assert got == launches


# filter: the shared tile's body, which K2, K3 and every K1 launch that a
# register body cannot take (or, under regs, loses) run.
TILE_BODIES = {"box": "acc16", "edge": "int32", "gaussian": "swar",
               "gaussian5": "swar", "gaussian7": "acc16",
               "gaussian9": "int32", "identity": "swar",
               "soft_blur": "int32"}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_k1s_body_choice_is_unchanged(name):
    # the shared tile's choice for every filter, the direct plans' too
    plan = _plan(name)
    assert cs.tile_body(plan) == TILE_BODIES[name]
    assert cs.k1_launch(plan, 5040, 5760, 3, 8, 16).body == TILE_BODIES[name]
    for kernel, rows in (("stencil_resident", 64), ("stencil_valid", 16)):
        rec = cs.describe_launch(kernel, plan, rows, 96, 3, fuse=2)
        assert rec["body"] == TILE_BODIES[name]


# The cells' images (H, W) and a 64x64 frame in the frames layout, whose
# single-rep regs grid leaves SMs idle.
ONE_PLACE = [(2520, 1920), (5040, 1920), (65, 64)]


class _Recorder:
    """A K1 library stub that keeps (body, tile_h, tile_w, fuse) of each
    launch as the C entry receives them."""

    def __init__(self):
        self.launches = []

    def stencil_fused_launch(self, src, dst, params, geom, fuse, body,
                             stream):
        import ctypes

        g = ctypes.cast(geom, ctypes.POINTER(cs._Geometry)).contents
        self.launches.append((body, g.tile_h, g.tile_w, fuse))
        return 0


@pytest.mark.parametrize("depth", [8, 1])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("rows,w", ONE_PLACE)
@pytest.mark.parametrize("name", sorted(tfilters.FILTERS))
def test_one_record_decides_k1s_launch(name, rows, w, c, depth, stub_launch,
                                        monkeypatch):
    # the record's body and tile are what the library receives and what
    # describe_launch reports
    plan = _plan(name)
    lib = _Recorder()
    monkeypatch.setattr(cs, "_fused_lib", lambda: lib)
    launch = cs.k1_launch(plan, rows, w * c, c, depth)
    cs.stencil_fused(torch.empty((rows, w * c), **META), plan, c, depth)
    assert lib.launches == [(cs.K1_BODIES.index(launch.body), launch.tile_h,
                             launch.tile_w, depth)]
    rec = cs.describe_launch("stencil_fused", plan, rows, w * c, c,
                             fuse=depth)
    assert rec["body"] == launch.body


# ---------------------------------------------------------------------------
# K1's reps by body, and the model.issue span
# ---------------------------------------------------------------------------


class _FakeLib:
    def stencil_fused_launch(self, *args):
        return 0


class _Stream:
    cuda_stream = 0


@pytest.fixture
def stub_launch(monkeypatch):
    """K1's launch stubbed out, so that a tensor on the meta device takes
    the card's path (its choices and counters) and launches nothing."""
    monkeypatch.setattr(cs, "_fused_lib", lambda: _FakeLib())
    monkeypatch.setattr(cs, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: id(self))


META = dict(dtype=torch.uint8, device="meta")


def test_body_rep_counts_move_by_a_calls_reps_and_reset(stub_launch):
    assert cs.body_rep_counts() == {}
    # edge at the cell's shape: all 16 launches in regs_direct
    cs.iterate(torch.empty((5040, 1920, 3), **META), 100, _plan("edge"))
    assert cs.body_rep_counts() == {"regs_direct": 100}
    assert cs.body_launch_counts() == {"regs_direct": 16}
    # on a small image: edge's 16 launches in regs_direct, gaussian's 12
    # fused launches in regs and 4 single reps on a one-block grid in the
    # shared tile
    cs.iterate(torch.empty((64, 48, 3), **META), 100, _plan("edge"))
    cs.iterate(torch.empty((64, 48, 3), **META), 100, _plan("gaussian"))
    cs.iterate(torch.empty((64, 48), **META), 9, _plan("box"), fuse=4)
    assert cs.body_rep_counts() == {"regs_direct": 200, "regs": 96,
                                    "swar": 4, "acc16": 9}
    assert cs.body_launch_counts() == {"regs_direct": 32, "regs": 12,
                                       "swar": 4, "acc16": 3}
    assert sum(cs.body_launch_counts().values()) == (
        cs.launch_counts()["stencil_fused"])
    cs.reset_launch_counts()
    assert cs.body_rep_counts() == {} and cs.body_launch_counts() == {}


def test_body_rep_counts_hold_under_several_threads(stub_launch):
    plan = _plan("edge")
    x = torch.empty((16, 16), **META)

    def work():
        for _ in range(50):
            cs.iterate(x, 9, plan)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert sum(cs.body_rep_counts().values()) == 4 * 50 * 9
    assert sum(cs.body_launch_counts().values()) == (
        cs.launch_counts()["stencil_fused"])


def _issue_spans():
    return [r for r in tracing.profiled_spans(0, 1 << 62)
            if r.name == "model.issue"]


@pytest.mark.parametrize("name,plan,bodies,body_reps", [
    ("edge", "direct_int", {"regs_direct": 16}, {"regs_direct": 100}),
    ("gaussian", "sep_int", {"regs": 12, "swar": 4},
     {"regs": 96, "swar": 4}),
])
def test_model_issue_carries_the_plan_and_its_bodies(stub_launch, name,
                                                     plan, bodies,
                                                     body_reps):
    model = IteratedConv2D(name, backend="pallas", device=CPU)
    x = torch.empty((64, 48, 3), **META)
    cs.iterate(x, 3, model.plan)  # counters already moved before the call
    model.run_on(x, 100)  # no profiler: no span
    assert tracing.profiled_spans(0, 1 << 62) == []
    with profile(activities=[ProfilerActivity.CPU]):
        model.run_on(x, 100)
    (span,) = _issue_spans()
    assert span.args == {"kernel": "stencil_fused", "reps": 100,
                         "launches": 16, "plan": plan, "bodies": bodies,
                         "body_reps": body_reps}


def test_model_issue_on_the_cpu_names_the_plan_and_no_body():
    model = IteratedConv2D("edge", backend="pallas", device=CPU)
    img = _img((40, 48, 3), 7)
    with profile(activities=[ProfilerActivity.CPU]):
        model(img, 9)
    (span,) = _issue_spans()
    assert span.args == {"kernel": "pallas", "reps": 9, "launches": 0,
                         "plan": "direct_int", "bodies": {},
                         "body_reps": {}}


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


def _ctx(capture):
    win = bcell.Window(attempted=2, failed=0, done=2, end_to_end={})
    return spec.MetricContext(env=None, window=win, capture=capture,
                              chips=1)


def _read(capture):
    return spec.reader("direct_rep_us.mpx")(_ctx(capture))


def _synthetic(monkeypatch, args):
    """A 100 us window: two model.issue spans with ``args``, stencil
    kernels of 30 + 50 us and a copy of 10 us on the card."""
    sink = tracing.ProfilerSink()
    monkeypatch.setattr(tracing, "_profiled", sink)
    me = threading.get_native_id()
    for s, e in ((1_000, 5_000), (50_000, 54_000)):
        sink.record(tracing.ProfiledSpan("model.issue", "model", me, 0,
                                         dict(args), s, e))
    sink.record(tracing.ProfiledSpan("model.place", "model", me, 0,
                                     {"bytes": 9}, 0, 1_000))
    ops = [DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 0, 10_000),
           DeviceOp("void stencil_fused_kernel<3, 0>(...)", 0, 10_000,
                    40_000),
           DeviceOp("void stencil_fused_kernel<3, 0>(...)", 0, 50_000,
                    100_000)]
    return Capture(0, 100_000, ops, [])


def test_the_reader_gives_the_direct_plans_device_time_a_rep(monkeypatch):
    cap = _synthetic(monkeypatch, {"plan": "direct_int",
                                   "body_reps": {"int32": 96, "swar": 4}})
    # 80 us of stencil kernels over 2 x 100 reps.
    assert _read(cap) == pytest.approx(0.4)


@pytest.mark.parametrize("args", [
    {"plan": "sep_int", "body_reps": {"regs": 96, "swar": 4}},
    {"plan": "direct_int", "body_reps": {}},
    {"kernel": "stencil_fused", "reps": 100, "launches": 16},  # the parent
], ids=["separable", "no_reps", "no_args"])
def test_the_reader_finds_nothing_without_direct_reps(monkeypatch, args):
    assert _read(_synthetic(monkeypatch, args)) is None


def test_the_reader_finds_nothing_without_a_capture_or_the_sink(
        monkeypatch):
    cap = _synthetic(monkeypatch, {"plan": "direct_int",
                                   "body_reps": {"int32": 100}})
    assert _read(None) is None
    monkeypatch.delattr(tracing, "profiled_spans")
    assert _read(cap) is None
