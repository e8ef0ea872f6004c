"""The port's ``serve`` CLI, load generator, perf sentry and ``perf``
subcommand against the JAX package's.

``python -m tpu_stencil_torch serve`` runs here with ``--platform cpu``
(the kernels' plain versions under ``--backend pallas``): the self-test
in a fresh process, every load model of the load generator (closed,
open, ``--rate-fps``, ``--burst``, ``--zipf``, ``--ramp``), the versioned
``--stats-json``, and ``--perf-log``, whose record must have the JAX
package's format and be gated by either package's sentry. The sentry's
own tests mirror ``tests/test_introspect.py`` and ``tests/test_bench.py``
(those that need no ``tools/`` import), each run through both packages
on the same records.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_stencil.obs import sentry as jsentry
from tpu_stencil_torch import cli
from tpu_stencil_torch import obs
from tpu_stencil_torch.obs import sentry
from tpu_stencil_torch.serve import cli as serve_cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--platform", "cpu", "--shapes", "10x8,12x9", "--reps", "2",
         "--max-batch", "4"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv(sentry.ENV_HISTORY, str(tmp_path / "default.jsonl"))
    obs.reset()
    yield
    obs.reset()


def _stats(capsys, argv):
    assert serve_cli.main(argv + ["--stats-json", "-"]) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):out.rindex("}") + 1]), out


# -- the serve subcommand -----------------------------------------------


def test_serve_self_test_subprocess_with_trace_and_metrics(tmp_path):
    trace, mtext = tmp_path / "t.json", tmp_path / "m.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", "serve", "--self-test",
         "--platform", "cpu", "--trace", str(trace), "--metrics-text",
         str(mtext)],
        capture_output=True, text=True, timeout=580, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "serve self-test OK: 5 requests exact" in proc.stdout
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]
             if e.get("ph") == "X"}
    assert {"serve.execute", "serve.drain", "serve.cache_hit"} <= names
    from tpu_stencil_torch.obs import exposition

    snap = exposition.parse_text(mtext.read_text(),
                                 prefix="tpu_stencil_serve")
    assert snap["counters"]["completed_total"] == 5


def test_cli_dispatches_serve_and_perf_ahead_of_the_job_parser(capsys,
                                                                tmp_path):
    assert cli.main(["serve", "--self-test", "--platform", "cpu"]) == 0
    assert "serve self-test OK" in capsys.readouterr().out
    assert cli.main(["perf", "report", "--history",
                     str(tmp_path / "none.jsonl")]) == 0
    assert "(empty perf history)" in capsys.readouterr().out


def test_closed_loop_report(capsys):
    report, out = _stats(capsys, SMALL + ["--requests", "8",
                                          "--concurrency", "3"])
    assert report["mode"] == "closed" and report["completed"] == 8
    assert report["stats"]["counters"]["completed_total"] == 8
    assert report["p99_s"] >= report["p50_s"] > 0
    assert report["slowest_trace_id"]
    assert "served 8/8 requests" in out and "cache=" in out


def test_open_loop_report(capsys):
    report, _ = _stats(capsys, SMALL + ["--mode", "open", "--rate",
                                        "2000", "--requests", "8"])
    assert report["mode"] == "open"
    assert report["completed"] + report["rejected"] == 8


def test_rate_fps_report(capsys):
    report, out = _stats(capsys, SMALL + ["--rate-fps", "500",
                                          "--requests", "6"])
    assert report["mode"] == "open" and report["requested_fps"] == 500.0
    assert report["achieved_fps"] > 0 and "frame rate: requested" in out


def test_burst_report(capsys):
    report, _ = _stats(capsys, SMALL + ["--mode", "open", "--rate", "5000",
                                        "--burst", "4", "--requests", "8",
                                        "--channels", "1,3"])
    assert report["burst"] == 4 and report["completed"] == 8


def test_zipf_report(capsys):
    report, out = _stats(capsys, SMALL + ["--zipf", "1.1", "--zipf-keys",
                                          "3", "--requests", "10"])
    assert report["zipf"] == 1.1 and report["zipf_keys"] == 3
    assert 1 <= report["distinct_keys_offered"] <= 3
    assert report["cache_hit_ratio"] is None  # no result cache here
    assert "zipf keyspace" in out


def test_ramp_report(capsys):
    report, out = _stats(capsys, SMALL + ["--ramp", "200:400:0.05",
                                          "--ramp-phases", "2"])
    phases = report["ramp"]["phases"]
    assert len(phases) == 2 and report["mode"] == "open"
    assert report["requests"] == sum(p["requests"] for p in phases)
    assert "ramp 200->400 fps" in out


def test_verify_golden_and_per_request(capsys):
    report, out = _stats(capsys, SMALL + ["--requests", "4", "--verify",
                                          "golden", "--per-request",
                                          "--backend", "pallas"])
    assert report["verify"] == "golden"
    assert report["verify_failures_total"] == 0
    assert len(report["per_request"]) == 4
    assert "X-Trace-Id" in out and "verify (golden): 0 failure(s)" in out


@pytest.mark.parametrize("argv,match", [
    (["--ramp", "1:2"], "--ramp"),
    (["--ramp", "1:2:3", "--rate-fps", "5"], "exclusive"),
    (["--verify", "crc"], "--verify crc needs --http"),
    (["--tenant", "a"], "--tenant needs --http"),
    (["--channels", "2"], "--channels"),
    (["--zipf", "-1"], "--zipf"),
    (["--rate-fps", "0"], "--rate-fps"),
])
def test_usage_errors_as_the_jax_package(capsys, argv, match):
    from tpu_stencil.serve import cli as jserve_cli

    for main in (serve_cli.main, jserve_cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--platform", "cpu"])
        assert e.value.code == 2
        assert match in capsys.readouterr().err


def test_perf_log_record_has_the_jax_format(capsys, tmp_path):
    hist = tmp_path / "h.jsonl"
    for _ in range(3):
        assert serve_cli.main(SMALL + ["--requests", "4", "--concurrency",
                                       "2", "--perf-log", str(hist)]) == 0
    out = capsys.readouterr().out
    assert "perf history += serve.p50_s.closed.c2.reps2" in out
    mine = sentry.load(str(hist))
    assert len(mine) == 3 and jsentry.load(str(hist)) == mine
    rec = mine[-1]
    # The JAX package's record, field for field.
    want = jsentry.make_record(
        metric=rec["metric"], value=rec["value"], filter_name="gaussian",
        shape="10x8,12x9", backend="auto", platform="cpu", source="serve",
        extra=rec["extra"])
    assert set(rec) == set(want)
    assert {k: rec[k] for k in jsentry.KEY_FIELDS} == {
        k: want[k] for k in jsentry.KEY_FIELDS}
    assert set(rec["extra"]) == {"requests", "throughput_rps"}
    # Either package gates the series the port wrote.
    slow = dict(rec, value=rec["value"] * 100)
    assert sentry.check(slow, path=str(hist))["status"] == "regression"
    assert jsentry.check(slow, path=str(hist))["status"] == "regression"


def test_perf_log_default_path_is_the_env_override(capsys, tmp_path):
    assert serve_cli.main(SMALL + ["--requests", "2", "--perf-log"]) == 0
    assert str(tmp_path / "default.jsonl") in capsys.readouterr().out
    assert len(sentry.load()) == 1


# -- the sentry, both packages on the same records ----------------------


@pytest.fixture(params=["port", "jax"])
def mod(request):
    return sentry if request.param == "port" else jsentry


def _rec(mod, value, *, shape="64x48", backend="xla", fuse=None, **kw):
    return mod.make_record(
        metric="compute_seconds", value=value, filter_name="gaussian",
        shape=shape, backend=backend, platform="cpu", fuse=fuse, **kw)


def test_sentry_records_are_identical_but_for_the_time():
    a, b = _rec(sentry, 1.5, fuse=8), _rec(jsentry, 1.5, fuse=8)
    a.pop("ts_unix"), b.pop("ts_unix")
    assert a == b
    assert sentry.KEY_FIELDS == jsentry.KEY_FIELDS
    assert (sentry.SCHEMA_VERSION, sentry.DEFAULT_K, sentry.MIN_SAMPLES,
            sentry.DEFAULT_THRESHOLD) == (
        jsentry.SCHEMA_VERSION, jsentry.DEFAULT_K, jsentry.MIN_SAMPLES,
        jsentry.DEFAULT_THRESHOLD)


def test_sentry_empty_and_short_history_degrade(mod):
    assert mod.baseline([], mod.record_key(_rec(mod, 1.0))) is None
    v = mod.check(_rec(mod, 1.0), history=[])
    assert v["status"] == "no-baseline" and v["baseline"] is None
    v = mod.check(_rec(mod, 5.0), history=[_rec(mod, 1.0)])
    assert v["status"] == "no-baseline"


def test_sentry_regression_ok_and_improvement(mod):
    hist = [_rec(mod, 1.00), _rec(mod, 1.02), _rec(mod, 0.98)]
    assert mod.check(_rec(mod, 2.0), history=hist)["status"] == "regression"
    assert mod.check(_rec(mod, 1.05), history=hist)["status"] == "ok"
    assert mod.check(_rec(mod, 0.5),
                     history=hist)["status"] == "improvement"


def test_sentry_key_separates_series(mod):
    hist = [_rec(mod, 1.0, fuse=16), _rec(mod, 1.0, fuse=16)]
    assert mod.check(_rec(mod, 3.0), history=hist)["status"] == "no-baseline"
    assert mod.check(_rec(mod, 3.0, fuse=16),
                     history=hist)["status"] == "regression"


def test_sentry_baseline_is_median_of_last_k(mod):
    hist = [_rec(mod, 9.0)] + [_rec(mod, 1.0)] * 5
    assert mod.baseline(hist, mod.record_key(_rec(mod, 1.0)), k=5) == 1.0


def test_sentry_load_skips_corrupt_lines(tmp_path, mod):
    p = tmp_path / "h.jsonl"
    good = json.dumps(_rec(mod, 1.0))
    p.write_text(f"{good}\nnot json at all\n{{\"value\": null}}\n{good}\n")
    assert len(mod.load(str(p))) == 2


def test_sentry_record_from_capture_fields_and_fallback(mod):
    cap = {"metric": "1920x2520_rgb_40reps_compute_wall_clock",
           "value": 0.8, "backend": "pallas", "platform": "gpu",
           "shape": "1920x2520", "reps": 40, "hbm_gbps": 600.0,
           "pallas_block_h": 64, "pallas_fuse": 16}
    rec = mod.record_from_capture(cap)
    assert rec["per_rep_s"] == pytest.approx(0.02)
    assert rec["block_h"] == 64 and rec["fuse"] == 16
    assert rec["extra"]["hbm_gbps"] == 600.0
    old = {"metric": "1920x2520_rgb_40reps_compute_wall_clock",
           "value": 0.8, "backend": "xla", "platform": "gpu"}
    rec = mod.record_from_capture(old)
    assert rec["shape"] == "1920x2520" and rec["per_rep_s"] == 0.02
    assert rec["block_h"] is None
    with pytest.raises(ValueError):
        mod.record_from_capture({"metric": "x", "value": None})


@pytest.mark.parametrize("cap", [
    # A multichip capture (mesh and overlap as provenance).
    {"metric": "48x64_rgb_40reps_mesh2x2_overlap-split_compute_wall_clock",
     "value": 0.04, "unit": "s", "schema_version": 1, "mesh": "2x2",
     "n_devices": 4, "overlap": "split", "shape": "48x64", "reps": 40,
     "filter": "gaussian", "dtype": "uint8", "backend": "xla",
     "platform": "cpu"},
    # A stream capture (seconds a frame, the depth in the metric name).
    {"metric": "48x64_rgb_40reps_stream_depth2_wall_per_frame",
     "value": 0.002, "unit": "s", "schema_version": 1,
     "pipeline_depth": 2, "n_frames": 4, "frames_per_second": 500.0,
     "shape": "48x64", "reps": 40, "filter": "gaussian", "dtype": "uint8",
     "backend": "xla", "platform": "cpu"},
    # A per-schedule capture (its own series, its geometry in the key).
    {"metric": "48x64_rgb_40reps_sched-deep_compute_wall_clock",
     "value": 0.01, "unit": "s", "schema_version": 1, "shape": "48x64",
     "reps": 40, "filter": "gaussian", "dtype": "uint8",
     "backend": "pallas", "platform": "cpu", "pallas_schedule": "deep",
     "pallas_block_h": None, "pallas_fuse": None},
], ids=["mesh", "stream", "schedule"])
def test_sentry_gates_capture_series_like_the_jax_package(tmp_path, cap):
    hist = str(tmp_path / "hist.jsonl")
    a, b = sentry.record_from_capture(cap), jsentry.record_from_capture(cap)
    a.pop("ts_unix"), b.pop("ts_unix")
    assert a == b
    # Two logged runs (one per package), then a 2x slower one gates in
    # both.
    sentry.append(sentry.record_from_capture(cap), hist)
    jsentry.append(jsentry.record_from_capture(cap), hist)
    slow = dict(cap, value=cap["value"] * 2)
    for m in (sentry, jsentry):
        verdict = m.check(m.record_from_capture(slow), path=hist)
        assert verdict["status"] == "regression" and verdict["n_history"] == 2


def test_sentry_cli_round_trip(tmp_path, capsys):
    h = str(tmp_path / "hist.jsonl")
    base = ["--history", h, "--shape", "64x48"]
    assert sentry.main(["log"] + base + ["--value", "0.010"]) == 0
    assert jsentry.main(["log"] + base + ["--value", "0.011"]) == 0
    assert sentry.main(["check"] + base + ["--value", "0.021"]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert sentry.main(["check"] + base + ["--value", "0.0105"]) == 0
    assert "OK" in capsys.readouterr().out
    assert sentry.main(["report", "--history", h]) == 0
    mine = capsys.readouterr().out
    assert jsentry.main(["report", "--history", h]) == 0
    assert capsys.readouterr().out == mine and "64x48" in mine


def test_sentry_cli_no_baseline_exits_zero(tmp_path, capsys):
    h = str(tmp_path / "empty.jsonl")
    assert sentry.main(["check", "--history", h, "--shape", "8x8",
                        "--value", "1.0", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "no-baseline"


def test_sentry_cli_from_bench_file(tmp_path, capsys):
    h = str(tmp_path / "hist.jsonl")
    cap = {"metric": "48x64_rgb_40reps_compute_wall_clock", "value": 0.01,
           "unit": "s", "backend": "xla", "platform": "cpu",
           "shape": "48x64", "reps": 40, "schema_version": 1}
    f = tmp_path / "bench_out.json"
    lines = [dict(cap, value=0.010), dict(cap, value=0.011)]
    f.write_text("\n".join(
        [json.dumps({"metric": "phase.compile.seconds", "value": 9.0,
                     "phase": "compile"})]
        + [json.dumps(ln) for ln in lines]) + "\n")
    assert sentry.main(["log", "--history", h, "--from-bench", str(f)]) == 0
    assert sentry.main(["log", "--history", h, "--from-bench", str(f)]) == 0
    assert [r["value"] for r in sentry.load(h)] == [0.011, 0.011]
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps(dict(cap, value=0.03)) + "\n")
    assert sentry.main(
        ["check", "--history", h, "--from-bench", str(slow)]) == 1
    with pytest.raises(SystemExit):
        sentry.main(["log", "--history", h, "--from-bench",
                     str(tmp_path / "missing.json")])
    capsys.readouterr()


def test_perf_subcommand_subprocess(tmp_path):
    h = tmp_path / "h.jsonl"
    for v in ("0.010", "0.011", "0.030"):
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_stencil_torch", "perf", "check",
             "--history", str(h), "--shape", "8x8", "--value", v, "--log"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 1 and "REGRESSION" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_stencil_torch", "perf", "report",
         "--history", str(h)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0 and "compute_seconds|gaussian|8x8" in \
        proc.stdout
