"""SLO burn-rate engine over the in-process time series (the port's copy
of the JAX package's ``obs/slo.py``: the same objectives, gauges and
event names).

Declarative objectives evaluated on every sampler tick, using the
multi-window burn-rate discipline from SRE practice: an alert fires
only when BOTH a fast window (catches an acute spike) and a slow
window (proves it is sustained, not one bad second) burn the error
budget faster than their thresholds. The burn rate is

    observed_bad_fraction / budget

so burn 1.0 means "spending the budget exactly as fast as allowed",
6.0 means "the whole budget gone in 1/6 of the period".

Objective kinds:

* ``error_ratio`` / ``ratio`` — windowed ``bad_delta / total_delta``
  over counter names (a zero-traffic window burns nothing).
* ``latency`` — fraction of requests slower than ``threshold_s``,
  computed from windowed histogram bucket deltas (the threshold maps
  to the smallest bucket boundary >= it; the fixed-bucket histograms
  in :mod:`tpu_stencil_torch.serve.metrics` exist exactly for this).

On an ok->breach transition the engine emits a structured
``slo.breach`` event line, triggers a flight-recorder dump named
``slo_burn`` (carrying the most recent traced request's id, so the
alert links straight to ``/debug/trace/<id>`` and the spool), bumps
``slo_breaches_total`` and flips the ``degraded`` gauge that
``/healthz`` surfaces as ``200 degraded`` — still routable, visibly
unhealthy, and distinct from draining's 503. Recovery (fast burn back
under 1.0) emits ``slo.recover`` and clears the state.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Tuple

from tpu_stencil_torch.obs import events as _events
from tpu_stencil_torch.obs import flight as _flight
from tpu_stencil_torch.obs.timeseries import TimeSeriesRing, _le_key


@dataclass(frozen=True)
class Objective:
    """One declarative objective. ``budget`` is the allowed bad
    fraction (0.05 = 5% of requests may be bad before burn 1.0)."""

    name: str
    kind: str = "error_ratio"          # error_ratio | ratio | latency
    bad: Tuple[str, ...] = ()          # counter names (bad events)
    total: Tuple[str, ...] = ()        # counter names (all events)
    histogram: str = ""                # latency kind: histogram name
    threshold_s: float = 0.0           # latency kind: slow threshold
    budget: float = 0.05
    min_events: int = 1                # ignore windows thinner than this

    def burn(self, ring: TimeSeriesRing, window_s: float) -> float:
        if self.budget <= 0:
            return 0.0
        if self.kind == "latency":
            deltas = ring.bucket_deltas(self.histogram, window_s)
            if not deltas:
                return 0.0
            les = sorted(deltas, key=_le_key)
            total = deltas[les[-1]]
            if total < self.min_events:
                return 0.0
            # Requests <= the smallest boundary >= threshold are fast;
            # the remainder (including +Inf) are slow.
            fast = 0
            for le in les:
                if _le_key(le) >= self.threshold_s:
                    fast = deltas[le]
                    break
            bad_frac = (total - fast) / total
            return bad_frac / self.budget
        bad = ring.counter_delta(self.bad, window_s)
        total = ring.counter_delta(self.total, window_s)
        if total < self.min_events:
            return 0.0
        return (bad / total) / self.budget


class SloEngine:
    """Evaluates objectives on sampler ticks; owns the degraded bit."""

    def __init__(self, objectives, registry, *, tier: str = "",
                 fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                 fast_burn: float = 6.0, slow_burn: float = 3.0) -> None:
        self.objectives = list(objectives)
        self._registry = registry
        self._tier = tier
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._lock = threading.Lock()
        self._breached: Dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        self._last: Dict[str, Dict[str, float]] = {}
        self._breaches = registry.counter("slo_breaches_total")
        self._degraded = registry.gauge("degraded")
        self._degraded.set(0)

    # -- evaluation ---------------------------------------------------

    def evaluate(self, ring: TimeSeriesRing) -> None:
        """One tick: recompute burns, publish gauges, drive breach /
        recovery transitions. Runs on the sampler thread."""
        for o in self.objectives:
            fast = o.burn(ring, self.fast_window_s)
            slow = o.burn(ring, self.slow_window_s)
            self._registry.gauge(f"slo_{o.name}_fast_burn_rate").set(fast)
            self._registry.gauge(f"slo_{o.name}_slow_burn_rate").set(slow)
            with self._lock:
                was = self._breached[o.name]
                self._last[o.name] = {"fast": fast, "slow": slow}
                now = (fast >= self.fast_burn and slow >= self.slow_burn) \
                    if not was else (fast >= 1.0)
                self._breached[o.name] = now
            if now and not was:
                self._on_breach(o, fast, slow)
            elif was and not now:
                _events.emit("slo.recover", tier=self._tier,
                             objective=o.name, fast_burn=round(fast, 3),
                             slow_burn=round(slow, 3))
        self._degraded.set(1 if self.degraded() else 0)

    def _on_breach(self, o: Objective, fast: float, slow: float) -> None:
        self._breaches.inc()
        # A recent traced request gives the alert its link into
        # /debug/trace/<id> and the flight spool.
        tid = ""
        try:
            rec = _flight.get()
            for span in reversed(rec.snapshot()) if rec else ():
                t = getattr(span, "trace_id", "")
                if t:
                    tid = t
                    break
        except Exception:
            pass
        _events.emit("slo.breach", trace_id=tid, tier=self._tier,
                     verdict="degraded", objective=o.name,
                     fast_burn=round(fast, 3), slow_burn=round(slow, 3),
                     fast_window_s=self.fast_window_s,
                     slow_window_s=self.slow_window_s, budget=o.budget)
        try:
            _flight.trigger(
                "slo_burn", trace_id=tid, tier=self._tier,
                objective=o.name, fast_burn=round(fast, 3),
                slow_burn=round(slow, 3),
            )
        except Exception:
            pass

    # -- views --------------------------------------------------------

    def degraded(self) -> bool:
        with self._lock:
            return any(self._breached.values())

    def statusz(self) -> dict:
        with self._lock:
            return {
                "degraded": any(self._breached.values()),
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "fast_burn_threshold": self.fast_burn,
                "slow_burn_threshold": self.slow_burn,
                "objectives": {
                    o.name: {
                        "kind": o.kind,
                        "budget": o.budget,
                        "breached": self._breached[o.name],
                        "fast_burn": round(
                            self._last.get(o.name, {}).get("fast", 0.0), 4),
                        "slow_burn": round(
                            self._last.get(o.name, {}).get("slow", 0.0), 4),
                    }
                    for o in self.objectives
                },
            }


def default_net_objectives(cfg) -> list:
    """The net tier's stock objectives, derived from NetConfig knobs.
    ``slo_error_budget <= 0`` disables the engine entirely (handled by
    the caller); ``slo_latency_p99_s`` adds the latency objective only
    when set."""
    responses = tuple(
        f"responses_{c}xx_total" for c in (2, 3, 4, 5)
    )
    objs = [
        Objective(
            name="error_ratio",
            kind="error_ratio",
            bad=("responses_5xx_total",),
            total=responses,
            budget=cfg.slo_error_budget,
        ),
        Objective(
            name="witness_mismatch",
            kind="ratio",
            bad=("fleet_integrity_witness_mismatch_total",),
            total=("fleet_integrity_witness_total",),
            budget=max(cfg.slo_error_budget, 0.01),
        ),
    ]
    if getattr(cfg, "slo_latency_p99_s", 0.0) > 0:
        objs.append(Objective(
            name="latency_p99",
            kind="latency",
            histogram="request_latency_seconds",
            threshold_s=cfg.slo_latency_p99_s,
            budget=0.01,
        ))
    return objs


def default_fed_objectives(cfg) -> list:
    """The federation tier watches its own response mix (member health
    is each member's own engine's job)."""
    responses = tuple(
        f"responses_{c}xx_total" for c in (2, 3, 4, 5)
    )
    return [
        Objective(
            name="error_ratio",
            kind="error_ratio",
            bad=("responses_5xx_total",),
            total=responses,
            budget=cfg.slo_error_budget,
        ),
    ]
