"""``BENCHMARK.json`` and the files it names, each found by its name:

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a kind of traffic: ``benchmark/kinds/<kind>.py`` (``setup``, ``window``,
  ``close``);
* a per-layer metric: ``benchmark/metrics/<name>.py`` (``read(ctx)``).

Adding one is adding its file and its entry; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]   # benchmark/
ROOT = HERE.parent                           # the checkout


def _root(root) -> Path:
    return ROOT if root is None else Path(root)


def load(root=None) -> dict:
    with open(_root(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root=None) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(_root(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root=None) -> dict:
    with open(_root(root) / "benchmark" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def kind(name: str):
    """The driver module of a kind of traffic."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(name: str, root=None) -> Callable:
    """The ``read(ctx)`` of a per-layer metric (its file name may hold
    dots, so it is loaded by path)."""
    path = _root(root) / "benchmark" / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics._" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    if s is None:
        raise KeyError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end_for(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, workload)]


def per_layer_for(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_for(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


@dataclasses.dataclass
class MetricContext:
    """What a per-layer reader reads: the run's inputs, its window's
    counts, the profiler's capture (None when nothing was traced) and
    the cell's chips."""

    env: object
    window: object
    capture: Optional[object]
    chips: int

    def item(self) -> dict:
        """One output's work: (h, w, c), reps and the filter's taps."""
        c = self.env.config
        return {"h": c["height"], "w": c["width"], "c": c["channels"],
                "reps": self.env.traffic["reps"],
                "taps": c["filter"]["taps"]}
