"""In-process time series: a sampler thread over a registry snapshot (the
port's copy of the JAX package's ``obs/timeseries.py``, names unchanged so
one dashboard reads both packages).

The serving tiers only ever had monotonic counters and point-in-time
gauges — fine for "how many since boot", useless for "how are we doing
*right now*". This module closes that gap with zero external infra:

* :class:`TimeSeriesRing` — a bounded ring of trimmed registry
  snapshots (counter values, gauge values, histogram count/sum/bucket
  vectors), each stamped with a monotonic and a wall clock.
* :class:`Sampler` — a daemon thread that calls a snapshot function on
  a fixed interval and appends to the ring; ``on_sample`` hooks let the
  SLO engine evaluate on every tick without a second thread.
* :meth:`TimeSeriesRing.window` — the ``/debug/timeseries`` payload:
  windowed counter deltas and per-second rates, gauge last/min/max,
  histogram windowed throughput and a bucket-delta p99 estimate.

Everything is stdlib-only and allocation-light: one registry snapshot
per tick (the same dict ``/metrics`` renders), trimmed to numbers.
Counters absent from the oldest in-window sample baseline at 0 — a
counter minted mid-window still deltas correctly from nothing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

#: Version stamp on every ``/debug/timeseries`` payload. Bump on any
#: breaking change to the JSON shape.
SCHEMA_VERSION = 1

#: How much history the ring retains, in seconds. The ring capacity is
#: derived from this and the sampling interval; the default (10 min at
#: 1 s ticks) costs well under a megabyte for a serving registry.
RETENTION_S = 600.0

_INF = "+Inf"


def _le_key(le: str) -> float:
    return float("inf") if le == _INF else float(le)


def quantile_from_bucket_deltas(deltas: Dict[str, int], q: float) -> float:
    """Conservative quantile from windowed cumulative-bucket deltas:
    the upper bound of the first bucket whose cumulative share reaches
    ``q``. Returns 0.0 on an empty window; the ``+Inf`` bucket reports
    as the largest finite boundary (the estimate is a floor for true
    tail values beyond it, which is the honest direction for alerting).
    """
    if not deltas:
        return 0.0
    les = sorted(deltas, key=_le_key)
    total = deltas[les[-1]]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_finite = 0.0
    for le in les:
        bound = _le_key(le)
        if deltas[le] >= rank:
            return prev_finite if bound == float("inf") else bound
        if bound != float("inf"):
            prev_finite = bound
    return prev_finite


def _trim(snapshot: dict) -> dict:
    """Reduce a full registry snapshot to the per-sample record the
    ring stores: counters verbatim, gauge current values, and for each
    histogram only the fields that subtract (count/sum/buckets)."""
    hists = {}
    for name, h in snapshot.get("histograms", {}).items():
        rec = {"count": h.get("count", 0), "sum": h.get("sum", 0.0)}
        b = h.get("buckets")
        if b:
            rec["buckets"] = dict(b)
        hists[name] = rec
    return {
        "counters": dict(snapshot.get("counters", {})),
        "gauges": {
            k: g["value"] for k, g in snapshot.get("gauges", {}).items()
        },
        "histograms": hists,
    }


class TimeSeriesRing:
    """Bounded ring of trimmed registry samples with windowed queries."""

    def __init__(self, interval_s: float,
                 retention_s: float = RETENTION_S) -> None:
        self.interval_s = float(interval_s)
        cap = max(4, int(retention_s / max(self.interval_s, 1e-3)) + 1)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=cap)

    def append(self, snapshot: dict, *, t_mono: Optional[float] = None,
               ts_unix: Optional[float] = None) -> None:
        rec = _trim(snapshot)
        rec["t_mono"] = time.monotonic() if t_mono is None else t_mono
        rec["ts_unix"] = time.time() if ts_unix is None else ts_unix
        with self._lock:
            self._ring.append(rec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def _in_window(self, window_s: float) -> List[dict]:
        with self._lock:
            samples = list(self._ring)
        if not samples:
            return []
        cutoff = samples[-1]["t_mono"] - float(window_s)
        kept = [s for s in samples if s["t_mono"] >= cutoff]
        # Keep one sample just *before* the window edge as the delta
        # baseline, so a 60 s window spans ~60 s of deltas rather than
        # 60 s minus one tick.
        idx = len(samples) - len(kept)
        if idx > 0:
            kept.insert(0, samples[idx - 1])
        return kept

    def window(self, window_s: float) -> dict:
        """The ``/debug/timeseries`` payload body for one process."""
        kept = self._in_window(window_s)
        out = {
            "schema_version": SCHEMA_VERSION,
            "interval_s": self.interval_s,
            "window_s": float(window_s),
            "samples": len(kept),
            "span_s": 0.0,
            "ts_unix": 0.0,
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        if not kept:
            return out
        first, last = kept[0], kept[-1]
        span = max(last["t_mono"] - first["t_mono"], 0.0)
        out["span_s"] = span
        out["ts_unix"] = last["ts_unix"]
        rate_div = span if span > 0 else None

        for name, v in sorted(last["counters"].items()):
            delta = v - first["counters"].get(name, 0)
            out["counters"][name] = {
                "delta": delta,
                "rate_per_s": (delta / rate_div) if rate_div else 0.0,
            }
        gnames = set()
        for s in kept:
            gnames.update(s["gauges"])
        for name in sorted(gnames):
            vals = [s["gauges"][name] for s in kept if name in s["gauges"]]
            out["gauges"][name] = {
                "last": vals[-1], "min": min(vals), "max": max(vals),
            }
        for name, h in sorted(last["histograms"].items()):
            h0 = first["histograms"].get(name, {})
            cdelta = h["count"] - h0.get("count", 0)
            sdelta = h["sum"] - h0.get("sum", 0.0)
            rec = {
                "count_delta": cdelta,
                "rate_per_s": (cdelta / rate_div) if rate_div else 0.0,
                "mean_s": (sdelta / cdelta) if cdelta > 0 else 0.0,
            }
            deltas = self.bucket_deltas(name, window_s, _kept=kept)
            if deltas is not None:
                rec["p99_est_s"] = quantile_from_bucket_deltas(deltas, 0.99)
            out["histograms"][name] = rec
        return out

    def bucket_deltas(self, hist_name: str, window_s: float,
                      _kept: Optional[List[dict]] = None
                      ) -> Optional[Dict[str, int]]:
        """Windowed cumulative-bucket deltas for one histogram, or
        ``None`` when the histogram (or its buckets) is absent. The SLO
        latency objective and the windowed-p99 estimate both feed from
        here."""
        kept = self._in_window(window_s) if _kept is None else _kept
        if not kept:
            return None
        last = kept[-1]["histograms"].get(hist_name)
        if last is None or "buckets" not in last:
            return None
        base = kept[0]["histograms"].get(hist_name, {}).get("buckets", {})
        return {
            le: v - base.get(le, 0) for le, v in last["buckets"].items()
        }

    def counter_delta(self, names, window_s: float) -> int:
        """Summed windowed delta over one or more counter names
        (absent counters contribute 0 — never a KeyError mid-deploy)."""
        kept = self._in_window(window_s)
        if not kept:
            return 0
        first, last = kept[0], kept[-1]
        total = 0
        for n in ([names] if isinstance(names, str) else names):
            total += last["counters"].get(n, 0) - first["counters"].get(n, 0)
        return total


class Sampler:
    """Daemon thread that feeds a :class:`TimeSeriesRing` on a fixed
    interval. ``on_sample`` callbacks (the SLO engine) run after each
    append, on the sampler thread; a callback raising is swallowed —
    telemetry must never take the serving path down."""

    def __init__(self, snapshot_fn: Callable[[], dict],
                 interval_s: float = 1.0,
                 retention_s: float = RETENTION_S) -> None:
        self._snapshot_fn = snapshot_fn
        self.interval_s = float(interval_s)
        self.ring = TimeSeriesRing(self.interval_s, retention_s)
        self.on_sample: List[Callable[[TimeSeriesRing], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> None:
        """One synchronous tick (also the unit-test entry point)."""
        try:
            snap = self._snapshot_fn()
        except Exception:
            return
        self.ring.append(snap)
        for cb in list(self.on_sample):
            try:
                cb(self.ring)
            except Exception:
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def start(self) -> None:
        if self._thread is not None:
            return
        self.sample_once()  # a fresh process answers its first scrape
        self._thread = threading.Thread(
            target=self._run, name="tpu-stencil-torch-ts-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
