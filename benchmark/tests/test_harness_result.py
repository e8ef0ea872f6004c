"""The run's last line, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.harness import cell, spec
from benchmark.tests.conftest import SMALL

ROOT = spec.ROOT


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_lines_schema(trace):
    out = cell.run_cell("rgb2520.job.r100", 2 ** 31 + 7, 0.3, trace,
                        ["cpu"], time.perf_counter(), config_override=SMALL)
    line = json.loads(json.dumps(cell.result_line(out, 1, "cpu")))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in line["checks"].values():
        assert {"value", "limit"} <= set(c)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == {"setup_s", "mpx_per_s"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "rgb2520.job.r100", "--seed", "1", "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=240)


def test_no_card_no_result():
    r = _run(ROOT)
    assert r.returncode not in (0,) and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
