"""One run of one cell: set-up, the measured window, the check, the result.

:func:`run_cell` is what ``benchmark/run.py`` calls once it has found a
card; the tests call it on the CPU at small sizes. Everything that
belongs to one configuration, traffic mix, kind or per-layer metric is a
file found by its name (:mod:`.spec`).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.harness import inputs, spec
from benchmark.harness.trace import Capture, Tracer
from benchmark.reference import stencil as reference

# Modules no process of the benchmark may hold, by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_stencil")


class Sampler:
    """Which outputs the check keeps: the first of each ring slot, then a
    seeded reservoir of ``k`` more, so every output of the window has the
    same chance whatever their number.

    A kept output is not copied: the sampler keeps its host buffer and
    hands back another to take the next output, a spare from ``spares``
    (``ring + k`` of them, which a kind allocates in set-up) or the
    buffer of the sample it displaces. So keeping costs the window no
    copy. A caller that never writes a buffer again needs no spares."""

    def __init__(self, seed: int, ring: int, k: int) -> None:
        self._rng = np.random.default_rng([seed, 0x5A3])
        self.ring = ring
        self.k = k
        self.spares: list = []
        self.first: Dict[int, object] = {}
        self.reservoir: List[Tuple[int, object]] = []

    def offer(self, index: int, out):
        """Output ``index`` (of ring slot ``index % ring``) is in the host
        buffer ``out``. Returns the buffer for the next output: ``out``
        when it is not kept, else a spare (None when there is none) or
        the displaced sample's."""
        if index < self.ring:
            self.first[index] = out
            return self._spare()
        n = index - self.ring
        if n < self.k:
            self.reservoir.append((index, out))
            return self._spare()
        j = int(self._rng.integers(0, n + 1))
        if j < self.k:
            displaced = self.reservoir[j][1]
            self.reservoir[j] = (index, out)
            return displaced
        return out

    def _spare(self):
        return self.spares.pop() if self.spares else None

    def samples(self) -> List[Tuple[int, np.ndarray]]:
        kept = sorted(self.first.items()) + sorted(self.reservoir,
                                                   key=lambda t: t[0])
        return [(i, np.asarray(buf)) for i, buf in kept]


@dataclasses.dataclass
class Env:
    """What a kind's driver is given."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    devices: list            # torch devices, one per chip of the cell
    tracer: Tracer
    ring: List[np.ndarray]   # the seeded inputs
    sampler: Sampler


@dataclasses.dataclass
class Window:
    """What a kind's window reports."""

    attempted: int            # jobs, requests or frames offered
    failed: int               # of those: shed, failed or never answered
    done: int                 # outputs whose bytes reached the host in it
    end_to_end: Dict[str, float]
    missing: int = 0          # outputs the check wanted and never got


@dataclasses.dataclass
class Outcome:
    """One run's numbers, before they are printed."""

    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    memory_peak_bytes: int
    checks: Dict[str, dict]
    capture: Optional[Capture]
    breakdown: Optional[dict]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def memory_peak(devices) -> int:
    import torch

    return max((int(torch.cuda.max_memory_allocated(d)) for d in devices
                if d.type == "cuda"), default=0)


def check(env: Env, reps: int, device) -> Dict[str, dict]:
    """The reference over each sampled output's input: mismatched bytes
    (an exact comparison, limit 0) and outputs the check wanted and never
    got (limit 0)."""
    filt = env.config["filter"]
    refs: Dict[int, np.ndarray] = {}
    bad = 0
    compared = 0
    for index, got in env.sampler.samples():
        slot = index % len(env.ring)
        if slot not in refs:
            refs[slot] = reference.iterate(env.ring[slot], filt["taps"],
                                           filt["divisor"], reps, device)
        want = refs[slot]
        compared += 1
        if got.shape != want.shape:
            bad += want.size
        else:
            bad += int(np.count_nonzero(got != want))
    return {"mismatched_bytes": {"value": bad, "limit": 0, "op": "<="},
            "outputs_compared": {"value": compared, "limit": 1, "op": ">="}}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             devices: Sequence, t_process_start: float,
             config_override: Optional[dict] = None,
             root=None, bench: Optional[dict] = None) -> Outcome:
    """Set up the cell, run its window, check it, read its metrics.

    ``t_process_start``: ``time.perf_counter()``'s reading of the
    process's start (``setup_s`` runs from it to the window).
    ``config_override``: keys replaced in the configuration (the tests'
    small sizes). ``bench``: the parsed ``BENCHMARK.json`` to use in
    place of the file (the tests' cells of kinds it has no cell of)."""
    import torch

    if bench is None:
        bench = spec.load(root)
    cell = spec.cell(bench, workload)
    config = dict(spec.config(bench, cell["config"], root))
    config.update(config_override or {})
    traffic = spec.traffic(cell["traffic"], root)
    kind = spec.kind(traffic["kind"])
    seed = int(seed) % (1 << 64)
    cuda = any(torch.device(d).type == "cuda" for d in devices)
    devices = [torch.device(d) for d in devices]
    tracer = Tracer(trace, cuda)
    env = Env(config, traffic, seed, seconds, devices, tracer,
              inputs.ring(config, seed, traffic["ring"]),
              Sampler(seed, traffic["ring"], traffic["samples"]))
    state = kind.setup(env)
    try:
        setup_s = time.perf_counter() - t_process_start
        with tracer.window():
            win = kind.window(env, state)
        peak = memory_peak(devices)
    finally:
        kind.close(env, state)
        del state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    capture = tracer.collect()
    checks = check(env, traffic["reps"], devices[0])
    checks["missing_outputs"] = {"value": win.missing, "limit": 0,
                                 "op": "<="}
    correct = (checks["mismatched_bytes"]["value"] == 0
               and checks["outputs_compared"]["value"] >= 1
               and win.missing == 0)
    units = spec.units(bench)
    if trace:
        ctx = spec.MetricContext(env=env, window=win, capture=capture,
                                 chips=cell["chips"])
        metrics = {}
        for m in spec.per_layer_for(bench, workload):
            value = spec.reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in spec.end_to_end_for(bench, workload):
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": win.end_to_end[m["name"]],
                                      "unit": units[m["name"]]}
    breakdown = None
    if capture is not None:
        breakdown = {"device_ops": capture.top_ops(),
                     "idle_gaps": capture.idle_gaps()}
    return Outcome(correct, win.attempted, win.failed, metrics, peak, checks,
                   capture, breakdown)


def result_line(out: Outcome, chips: int, kind: str) -> dict:
    """The run's last line: the result's keys, ``breakdown`` for a
    traced run, and last the check's numbers beside their limits.
    ``kind``: the card's name, as ``torch.cuda.get_device_name`` gives it."""
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if out.capture is not None:
        device["busy_s"] = out.capture.mean_busy_s(chips)
        device["window_s"] = out.capture.window_s
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics, "device": device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = out.checks
    return line
