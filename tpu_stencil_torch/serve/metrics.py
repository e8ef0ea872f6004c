"""Thread-safe metrics registry for the serving engine.

The port's copy of the JAX package's ``serve/metrics.py`` (``Counter``,
``Gauge``, ``Histogram``, ``Registry``), semantics unchanged: the
driver-side registry of :mod:`tpu_stencil_torch.obs` is one, and the
serving slice's engine will keep another.

The observability layer the reference program never needed (one process,
one image, one timer): a serving loop fields a stream of heterogeneous
requests, so the interesting numbers are *distributions* (queue wait,
batch latency) and *rates* (requests, rejections, padded-pixel waste),
not a single wall-clock. Everything is in-process and dependency-free:
``Registry.snapshot()`` returns a plain dict (the ``serve.stats()`` /
``--stats-json`` schema, documented in docs/SERVING.md).

Histograms keep a bounded deterministic reservoir: past ``cap``
observations each new sample evicts a pseudo-randomly chosen slot
(seeded ``random.Random``), so percentile queries stay O(cap log cap)
and memory stays bounded no matter how long the server runs — the same
never-unbounded discipline as the request queue.

Every histogram also maintains fixed cumulative buckets
(:data:`DEFAULT_BUCKETS`, ``le``-keyed like OpenMetrics) next to the
reservoir: bucket counts subtract cleanly between two snapshots, so the
time-series sampler (``obs.timeseries``) can compute
*windowed* tail quantiles and the SLO engine can count
slower-than-threshold requests over a sliding window — reservoirs can
do neither. When an observation lands while a trace context is bound
(:mod:`tpu_stencil_torch.obs.context`), the bucket keeps the latest
``(trace_id, value)`` pair as its **exemplar**: the ``/metrics``
exposition attaches it to the bucket line, so a populated tail bucket
links straight to ``/debug/trace/<id>``.
"""

from __future__ import annotations

import random
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from tpu_stencil_torch.obs.context import current as _ctx_current

#: Default cumulative bucket boundaries (seconds for the latency
#: histograms; generic log-spaced bounds otherwise — the ``+Inf``
#: bucket makes them total either way). Chosen to straddle the serve
#: tiers' latency range: sub-ms cache hits to multi-second cold
#: compiles.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: The label value of the catch-all bucket (OpenMetrics spelling).
INF_LE = "+Inf"


class Counter:
    """Monotonic counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (e.g. queue depth). Tracks its high-water mark
    so a snapshot taken after a burst still shows how deep the queue got."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._peak = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._peak:
                self._peak = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def peak(self) -> float:
        with self._lock:
            return self._peak


class Histogram:
    """Latency/size distribution with bounded memory.

    Keeps every observation up to ``cap``, then reservoir-replaces
    (deterministic seed: snapshots are reproducible for a given
    observation sequence). ``count``/``sum`` stay exact regardless.
    """

    def __init__(self, cap: int = 8192,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self._lock = threading.Lock()
        self._cap = cap
        self._values: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._rng = random.Random(0)
        self._buckets: Tuple[float, ...] = tuple(
            sorted({float(b) for b in buckets})
        )
        # The bucket label strings, computed once (repr round-trips
        # floats exactly, so snapshot keys survive the exposition's
        # parse round-trip verbatim); the final slot is +Inf.
        self._les: Tuple[str, ...] = tuple(
            repr(b) for b in self._buckets
        ) + (INF_LE,)
        self._bucket_counts: List[int] = [0] * len(self._les)
        # Per-bucket exemplar: the LATEST (trace_id, value) that landed
        # in the bucket while a trace context was bound — last writer
        # wins, so a tail bucket always names a recent straggler.
        self._exemplars: Dict[int, Tuple[str, float]] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        # The bound trace context (if any) is the exemplar source; read
        # outside the lock — one contextvar get, no allocation.
        ctx = _ctx_current()
        tid = ctx.trace_id if ctx is not None else ""
        # Cumulative le semantics: the first boundary >= v owns the
        # observation (inclusive upper bound, like OpenMetrics).
        idx = bisect_left(self._buckets, v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            self._bucket_counts[idx] += 1
            if tid:
                self._exemplars[idx] = (tid, v)
            if len(self._values) < self._cap:
                self._values.append(v)
            else:
                # Classic reservoir sampling: keep each of the n seen so
                # far with probability cap/n.
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._values[j] = v

    @staticmethod
    def _nearest_rank(vals: List[float], p: float) -> float:
        k = min(len(vals) - 1, max(0, int(round(p / 100.0 * (len(vals) - 1)))))
        return vals[k]

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the reservoir. Pinned edge cases
        (tests/test_serve.py): empty histogram -> 0.0 (a scrape before
        first traffic must render, not raise); a single sample is every
        percentile; past ``cap`` the rank is over the reservoir while
        count/sum/max stay exact."""
        with self._lock:
            if not self._values:
                return 0.0
            vals = sorted(self._values)
        return self._nearest_rank(vals, p)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict[str, float]:
        """One consistent view: every field reads under a single lock
        acquisition, so a snapshot taken mid-burst can never pair rep
        k's count with rep k+1's sum/max (the old per-property reads
        could, and read ``max`` with no lock at all)."""
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
            vals = sorted(self._values)
            per_bucket = list(self._bucket_counts)
            exemplars = dict(self._exemplars)
        cum = 0
        buckets: Dict[str, int] = {}
        for le, n in zip(self._les, per_bucket):
            cum += n
            buckets[le] = cum
        snap = {
            "count": count,
            "sum": total,
            "mean": (total / count) if count else 0.0,
            "p50": self._nearest_rank(vals, 50) if vals else 0.0,
            "p99": self._nearest_rank(vals, 99) if vals else 0.0,
            "max": mx,
            "buckets": buckets,
        }
        if exemplars:
            # Keyed by bucket le; absent entirely when no traced
            # observation has landed yet (the exposition renders —
            # and its parser rebuilds — exactly what is here).
            snap["exemplars"] = {
                self._les[i]: {"trace_id": t, "value": v}
                for i, (t, v) in sorted(exemplars.items())
            }
        return snap


class Registry:
    """Named metric store; creation is idempotent per (kind, name)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, cap: int = 8192,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(
                name, Histogram(cap, buckets or DEFAULT_BUCKETS)
            )

    def snapshot(self) -> dict:
        """The ``serve.stats()`` schema: plain JSON-serializable dict."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {
                k: {"value": g.value, "peak": g.peak}
                for k, g in sorted(gauges.items())
            },
            "histograms": {
                k: h.snapshot() for k, h in sorted(histograms.items())
            },
        }
