"""``BENCHMARK.json`` against the rules its readers hold it to, and every
file it names found by its name."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m["name"] for m in spec.end_to_end_for(BENCH, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = spec.per_layer_for(BENCH, cell)
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert _line(c["source"]) and c["source"].startswith("https://")
    assert c["file"].startswith("benchmark/configs/")
    cfg = spec.config(BENCH, c["name"])
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for key in ("width", "height", "channels", "filter", "boundary",
                "source", "assumed"):
        assert key in cfg
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    traffic = spec.traffic(w["traffic"])
    assert traffic["chips"] == w["chips"]
    kind = spec.kind(traffic["kind"])
    for fn in ("setup", "window", "close"):
        assert callable(getattr(kind, fn))
    for m in spec.per_layer_for(BENCH, cell):
        assert callable(spec.reader(m["name"]))


def test_every_file_is_valid_data():
    """Every traffic file names a kind there is a driver of; every
    configuration file parses."""
    root = spec.HERE
    for p in (root / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        assert (root / "kinds" / f"{t['kind']}.py").exists(), p
        for key in ("reps", "ring", "chips", "samples", "why"):
            assert key in t, (p, key)
    for p in (root / "configs").glob("*.json"):
        json.loads(p.read_text())
