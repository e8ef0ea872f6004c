"""Replica quarantine: the state machine between witness verdicts and
routing (the port's copy of the JAX package's ``integrity/quarantine.py``,
names and semantics unchanged).

A replica that fails witness re-execution is returning wrong bytes with a
200 and a healthy heartbeat. Quarantine is the drain discipline applied
to earned distrust:

* **trip**: K witness mismatches within a sliding window
  (``quarantine_after`` / ``quarantine_window_s``) move the replica to
  QUARANTINED: out of placement like a draining host, counted in
  ``integrity_quarantines_total`` and visible to a scrape as
  ``replica_quarantined_dev<i>``. One mismatch never trips it.
* **re-verify**: while quarantined, a background prober
  (:class:`QuarantineProber`) submits a small seeded probe frame directly
  to the replica (on a card, 2 reps of K1 on the replica's device) and
  referees it against the independent NumPy golden model.
  ``readmit_after`` consecutive clean probes re-admit it
  (``integrity_readmits_total``); a dirty probe resets the streak.
* **operator override**: ``POST /admin/quarantine?replica=i`` trips it
  by hand; ``action=clear`` releases it without probes.

The board is torch-free and engine-agnostic (the prober holds the
fleet); the net tier feeds witness verdicts in through
:meth:`tpu_stencil_torch.net.router.Router.record_witness`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

import numpy as np


class QuarantineBoard:
    """Per-replica quarantine state: witness verdicts in, routable out."""

    def __init__(self, registry, quarantine_after: int = 3,
                 window_s: float = 60.0, readmit_after: int = 3) -> None:
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}"
            )
        if readmit_after < 1:
            raise ValueError(
                f"readmit_after must be >= 1, got {readmit_after}"
            )
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.registry = registry
        self.quarantine_after = int(quarantine_after)
        self.window_s = float(window_s)
        self.readmit_after = int(readmit_after)
        self._lock = threading.Lock()
        self._mismatch_t: Dict[int, "collections.deque"] = {}
        self._quarantined: Dict[int, str] = {}  # idx -> reason
        self._clean_probes: Dict[int, int] = {}
        self._m_quarantines = registry.counter("integrity_quarantines_total")
        self._m_readmits = registry.counter("integrity_readmits_total")
        registry.gauge("replicas_quarantined").set(0)

    # -- verdicts ------------------------------------------------------

    def record_witness(self, idx: int, ok: bool) -> bool:
        """File one witness verdict against replica ``idx``; True when
        this verdict just tripped quarantine. Verdicts against a replica
        already quarantined are ignored (probes are the only road back)."""
        if ok:
            return False
        now = time.monotonic()
        with self._lock:
            if idx in self._quarantined:
                return False
            times = self._mismatch_t.setdefault(
                idx, collections.deque(maxlen=self.quarantine_after)
            )
            times.append(now)
            tripped = (len(times) >= self.quarantine_after
                       and times[0] >= now - self.window_s)
        if tripped:
            self.quarantine(
                idx,
                f"{self.quarantine_after} witness mismatches within "
                f"{self.window_s:g}s",
            )
        return tripped

    def quarantine(self, idx: int, reason: str) -> bool:
        """Move ``idx`` to QUARANTINED (idempotent); True on a fresh
        transition. Also the operator path (``/admin/quarantine``)."""
        with self._lock:
            if idx in self._quarantined:
                return False
            self._quarantined[idx] = reason
            self._clean_probes[idx] = 0
            self._mismatch_t.pop(idx, None)
            n = len(self._quarantined)
        self._m_quarantines.inc()
        self.registry.gauge(f"replica_quarantined_dev{idx}").set(1)
        self.registry.gauge("replicas_quarantined").set(n)
        from tpu_stencil_torch.obs import context as _obs_ctx
        from tpu_stencil_torch.obs import flight as _obs_flight
        from tpu_stencil_torch.obs import span as _obs_span

        with _obs_span("integrity.quarantine", "integrity",
                       replica=idx, reason=reason):
            pass  # zero-duration marker: the quarantine moment
        # The black box and event line of the transition: trace-scoped
        # under a bound trace context, else the ring's recent spans.
        ctx = _obs_ctx.current()
        _obs_flight.trigger(
            "quarantine", trace_id=ctx.trace_id if ctx else "",
            tier="net", replica=idx, reason=reason,
        )
        return True

    def release(self, idx: int, how: str) -> bool:
        """Back into routing (probe re-admission or operator clear); True
        when the replica was quarantined."""
        with self._lock:
            if self._quarantined.pop(idx, None) is None:
                return False
            self._clean_probes.pop(idx, None)
            n = len(self._quarantined)
        if how == "probes":
            self._m_readmits.inc()
        self.registry.gauge(f"replica_quarantined_dev{idx}").set(0)
        self.registry.gauge("replicas_quarantined").set(n)
        return True

    def record_probe(self, idx: int, ok: bool) -> bool:
        """File one re-verify probe verdict; True when it completed the
        clean streak and re-admitted the replica. A dirty probe resets the
        streak: re-admission takes ``readmit_after`` consecutive clean
        probes, not a ratio."""
        with self._lock:
            if idx not in self._quarantined:
                return False
            if not ok:
                self._clean_probes[idx] = 0
                return False
            self._clean_probes[idx] += 1
            done = self._clean_probes[idx] >= self.readmit_after
        if done:
            self.release(idx, "probes")
        return done

    # -- views ---------------------------------------------------------

    def is_quarantined(self, idx: int) -> bool:
        with self._lock:
            return idx in self._quarantined

    def quarantined(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._quarantined)

    def statusz(self) -> dict:
        with self._lock:
            return {
                "quarantined": {
                    str(i): reason
                    for i, reason in sorted(self._quarantined.items())
                },
                "clean_probes": {
                    str(i): n
                    for i, n in sorted(self._clean_probes.items())
                    if i in self._quarantined
                },
                "quarantine_after": self.quarantine_after,
                "window_s": self.window_s,
                "readmit_after": self.readmit_after,
            }


class QuarantineProber:
    """Background re-verify probes of quarantined replicas.

    A daemon thread: every ``interval_s`` each quarantined replica gets
    one seeded probe frame submitted directly to its engine (quarantine
    took it out of routing, so the router cannot carry the probe) and
    refereed against the NumPy golden model, the one comparator that
    shares no code with any device path. The probe is 24x32 grey at 2
    reps: on a card, two K1 launches on the replica's device."""

    PROBE_SHAPE = (24, 32)
    PROBE_REPS = 2

    def __init__(self, fleet, board: QuarantineBoard, filter_name: str,
                 interval_s: float, registry) -> None:
        self._fleet = fleet
        self._board = board
        self._filter = filter_name
        self._interval = float(interval_s)
        self._registry = registry
        self._img = np.random.default_rng(777).integers(
            0, 256, size=self.PROBE_SHAPE, dtype=np.uint8
        )
        self._want: Optional[np.ndarray] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe_once(self, idx: int) -> bool:
        """One probe of replica ``idx``; True when it completed the clean
        streak and re-admitted the replica. A probe that errors or times
        out counts dirty."""
        self._registry.counter("integrity_probes_total").inc()
        try:
            got = self._fleet.replicas[idx].submit(
                self._img, self.PROBE_REPS
            ).result(timeout=60.0)
            if self._want is None:
                from tpu_stencil_torch import filters
                from tpu_stencil_torch.ops import stencil

                self._want = stencil.reference_stencil_numpy(
                    self._img, filters.get_filter(self._filter),
                    self.PROBE_REPS,
                )
            ok = bool(np.array_equal(np.asarray(got), self._want))
        except Exception:
            ok = False
        if not ok:
            self._registry.counter("integrity_probe_failures_total").inc()
        return self._board.record_probe(idx, ok)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                for idx in sorted(self._board.quarantined()):
                    if self._stop.is_set():
                        return
                    self.probe_once(idx)
            except Exception:
                # The prober must never die: a broken probe pass is a
                # dirty probe, not the end of re-admission.
                pass

    def start(self) -> "QuarantineProber":
        if self._thread is None and self._interval > 0:
            self._thread = threading.Thread(
                target=self._loop, name="tpu-stencil-torch-quarantine-probe",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


__all__ = ["QuarantineBoard", "QuarantineProber"]
