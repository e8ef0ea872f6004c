"""The observability core of the port against the JAX package's.

Span tracing, the phase registry, the Chrome export, the breakdown table
and the text exposition: a traced job of the port must record the span
names of the JAX package's job in the same order, one ``iterate.rep`` per
rep, the same breakdown rows, and a registry with the same metric keys
(apart from the ``introspect_*`` and device-memory gauges, whose
instruments differ by design, and the sharded runner's ``overlap_mode``
gauge, which comes with ``--overlap``); the exposition text round-trips
exactly. Inputs: seeded 64x48 grey and RGB raw files; outputs compared
byte for byte.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax

from tpu_stencil import config as jconfig
from tpu_stencil import driver as jdriver
from tpu_stencil import obs as jobs
from tpu_stencil_torch import cli as tcli
from tpu_stencil_torch import config as tconfig
from tpu_stencil_torch import driver as tdriver
from tpu_stencil_torch import obs

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 48, 64


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _src(tmp_path, channels=3, seed=17):
    shape = (H, W) + ((3,) if channels == 3 else ())
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    path = tmp_path / f"in{channels}.raw"
    img.tofile(path)
    return str(path)


def _both(tmp_path, argv, mesh=False, traced=True, **kw):
    """Run the port's job and the JAX package's on the same argv, each
    with its own tracer when ``traced``; returns (port, jax) tracers or
    snapshots after asserting equal bytes."""
    tcfg, _ = tconfig.parse_args(argv + ["--output", str(tmp_path / "t.raw")])
    jcfg, _ = jconfig.parse_args(argv + ["--output", str(tmp_path / "j.raw")])
    if traced:
        obs.enable()
        jobs.enable()
    tdriver.run_job(tcfg, devices=[CPU] * (4 if mesh else 1), **kw)
    jdriver.run_job(jcfg, devices=(jax.devices()[:4] if mesh
                                   else jax.devices("cpu")[:1]), **kw)
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()
    return obs.get_tracer(), jobs.get_tracer()


# -- span API ----------------------------------------------------------


def test_span_is_noop_when_disabled():
    assert not obs.enabled()
    with obs.span("anything", "driver") as s:
        assert s.fence(7) == 7
        t = torch.zeros(3)
        assert s.fence([[t, t]]) == [[t, t]]
    assert obs.get_tracer() is None


def test_spans_record_nesting_and_threads():
    obs.enable()
    with obs.span("outer", "t"):
        with obs.span("inner", "t"):
            pass

    def worker():
        with obs.span("other_thread", "t"):
            pass

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    recs = {r.name: r for r in obs.get_tracer().spans()}
    assert recs["outer"].depth == 0 and recs["inner"].depth == 1
    assert recs["other_thread"].depth == 0
    assert recs["other_thread"].tid != recs["outer"].tid
    assert recs["outer"].t0 <= recs["inner"].t0 <= recs["inner"].t1
    assert recs["inner"].t1 <= recs["outer"].t1


def test_phase_records_metrics_even_untraced():
    with obs.phase("unit_test_phase"):
        pass
    snap = obs.snapshot()
    assert snap["histograms"]["phase_unit_test_phase_seconds"]["count"] == 1
    assert obs.get_tracer() is None


def test_devices_of_a_grid():
    from tpu_stencil_torch.obs.tracing import devices_of

    t = torch.zeros(2)
    assert devices_of([[t, t], [t]]) == [CPU] * 3
    assert devices_of((t, [t])) == [CPU] * 2 and devices_of(7) == []


# -- the job, traced, against the JAX package's ---------------------------


@pytest.mark.parametrize("extra", [
    ["--backend", "pallas"], ["--backend", "pallas", "--schedule", "deep"],
    ["--backend", "xla"],
])
@pytest.mark.parametrize("channels", [1, 3])
def test_traced_job_span_names_match_jax(tmp_path, channels, extra):
    argv = [_src(tmp_path, channels), str(W), str(H), "5",
            "rgb" if channels == 3 else "grey", *extra]
    tt, jt = _both(tmp_path, argv)
    names = [r.name for r in tt.spans()]
    assert names == [r.name for r in jt.spans()]
    assert names.count("iterate.rep") == 5
    reps = [r.args["rep"] for r in tt.spans() if r.name == "iterate.rep"]
    assert reps == list(range(5))
    assert ([r["name"] for r in obs.breakdown.aggregate(tt)]
            == [r["name"] for r in jobs.breakdown.aggregate(jt)]
            == ["load", "place", "compile", "iterate", "iterate.rep",
                "fetch", "store"])


def test_traced_checkpoint_chunks_number_reps_globally(tmp_path):
    argv = [_src(tmp_path), str(W), str(H), "5", "rgb", "--backend", "xla"]
    tt, jt = _both(tmp_path, argv, checkpoint_every=2)
    assert [r.name for r in tt.spans()] == [r.name for r in jt.spans()]
    assert [r.args["rep"] for r in tt.spans()
            if r.name == "iterate.rep"] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_sharded_trace_has_phase_probes(tmp_path, backend):
    argv = [_src(tmp_path, 1), str(W), str(H), "3", "grey", "--mesh", "2x2",
            "--backend", backend]
    tt, jt = _both(tmp_path, argv, mesh=True)
    names = [r.name for r in tt.spans()]
    # The JAX runner's per-edge exchange spans come with --overlap.
    jnames = [r.name for r in jt.spans()
              if not r.name.startswith("sharded.exchange_edge")]
    assert names == jnames
    assert {"sharded.probe_compile", "sharded.halo_exchange",
            "sharded.interior_compute"} <= set(names)
    assert names.count("iterate.rep") == 3
    rows = [r["name"] for r in obs.breakdown.aggregate(tt)]
    jrows = [r["name"] for r in jobs.breakdown.aggregate(jt)
             if not r["name"].startswith("sharded.exchange_edge")]
    assert rows == jrows


def _keys(snap, drop=()):
    out = set()
    for section in ("counters", "gauges", "histograms"):
        for name in snap[section]:
            if not name.startswith(("introspect_", "device_") + tuple(drop)):
                out.add((section, name))
    return out


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_metric_keys_match_jax(tmp_path, mesh, traced):
    argv = [_src(tmp_path), str(W), str(H), "3", "rgb", "--backend",
            "pallas"] + (["--mesh", "2x2"] if mesh else [])
    _both(tmp_path, argv, mesh=mesh, traced=traced)
    tkeys = _keys(obs.snapshot())
    jkeys = _keys(jobs.snapshot(), drop=("overlap_mode",))
    assert tkeys == jkeys
    phases = {n for s, n in tkeys if s == "histograms"}
    want = {"load", "compile", "iterate", "store"} | (
        set() if mesh else {"place", "fetch"})
    assert phases == {f"phase_{p}_seconds" for p in want}


def test_exposition_roundtrips_driver_registry_exactly(tmp_path):
    argv = [_src(tmp_path), str(W), str(H), "2", "rgb", "--backend", "xla"]
    _both(tmp_path, argv, traced=False)
    snap = obs.snapshot()
    assert snap["counters"]["jobs_total"] == 1
    for ph in ("load", "place", "compile", "iterate", "fetch", "store"):
        assert snap["histograms"][f"phase_{ph}_seconds"]["count"] == 1
    text = obs.exposition.render_text(snap, prefix="tpu_stencil_driver")
    assert obs.exposition.parse_text(text, prefix="tpu_stencil_driver") == snap
    # One text for one snapshot in both packages, and each parses the
    # other's.
    assert jobs.exposition.render_text(snap, prefix="tpu_stencil_driver") == text
    jsnap = jobs.snapshot()
    jtext = jobs.exposition.render_text(jsnap, prefix="tpu_stencil_driver")
    assert obs.exposition.parse_text(jtext, prefix="tpu_stencil_driver") == jsnap


def test_cli_trace_breakdown_and_metrics_text(tmp_path, capsys):
    src = _src(tmp_path)
    trace = tmp_path / "t.json"
    mpath = tmp_path / "m.txt"
    rc = tcli.main([src, str(W), str(H), "3", "rgb", "--platform", "cpu",
                    "--backend", "pallas", "--trace", str(trace),
                    "--breakdown", "--metrics-text", str(mpath),
                    "--output", str(tmp_path / "o.raw")])
    assert rc == 0
    out = capsys.readouterr().out
    for name in ("load", "place", "compile", "iterate", "fetch", "store",
                 "total", "HBM GB/s", "kernel schedule: fused",
                 "Execution time:", f"wrote trace {trace}"):
        assert name in out
    assert out.index("total ") < out.index("Execution time:")
    doc = json.load(open(trace))
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    for e in evs:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(e)
    assert sum(e["name"] == "iterate.rep" for e in evs) == 3
    parsed = obs.exposition.parse_text(mpath.read_text(),
                                       prefix="tpu_stencil_driver")
    assert parsed["counters"]["jobs_total"] == 1
    assert not obs.enabled() and not obs.introspect.enabled()


def test_resilience_table_only_when_something_fired():
    assert obs.breakdown.render_resilience(obs.snapshot()) == ""
    obs.registry().counter("resilience_fallbacks_total").inc()
    snap = obs.snapshot()
    assert (obs.breakdown.render_resilience(snap)
            == jobs.breakdown.render_resilience(snap))
    assert "schedule/backend demotions" in obs.breakdown.render_resilience(
        snap)
