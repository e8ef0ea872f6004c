"""Capacity planner: live federation signals → typed resize decisions
(the port's copy of the JAX package's ``ctrl/planner.py``: one signal
sequence gives one decision sequence in both packages).

The decide half of the control loop.  Inputs are the signals the
stack already exports — ``/debug/capacity``'s merged ``headroom_rps``
and ``time_to_saturation_s`` plus the hottest member's slot fraction
(the net edge's derived-Retry-After math inverted: the same queue-delay
and inflight-bytes state that prices a retry also prices a host), and the
member states from ``/statusz``.  Output is exactly one
:class:`Decision` per poll.

**Hysteresis, mirrored from the SLO engine**
(:mod:`~tpu_stencil_torch.obs.slo`): pressure *enters* only when every
sample in the fast window and a majority of the slow window agree, and
once entered it *holds* until the fast window's mean utilization drops
below the (lower) hold threshold — the fast window is the trigger, the
slow window the confirmation, and the asymmetric exit keeps one
borderline sample from flapping the fleet.  Scale-in is the slow
symmetric case: every slow-window sample idle.  Each actuation arms a
cooldown measured in *samples* (polls), so decisions stay deterministic
under synthetic signal feeds in tests.

**Replacement bypasses hysteresis.**  A dead owned host or a
preempted member is a discrete event, not a trend: the planner
answers REPLACE immediately, cooldown or not — capacity already left
the fleet and waiting a window would double the loss.

Clock-free and scrape-free: the planner is a pure
``observe(signal) -> Decision`` state machine; the CLI owns the HTTP.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Tuple

from tpu_stencil_torch.config import CtrlConfig
from tpu_stencil_torch.obs import span as _obs_span
from tpu_stencil_torch.serve.metrics import Registry

#: Decision actions — the full typed vocabulary.
HOLD = "hold"
SCALE_OUT = "scale_out"
SCALE_IN = "scale_in"
REPLACE = "replace"


@dataclasses.dataclass(frozen=True)
class CapacitySignal:
    """One poll's worth of federation capacity state.

    ``utilization`` is the hottest member's busy-slot fraction
    (``/debug/capacity`` → ``utilization.max_member_slot_fraction``),
    ``headroom_rps`` / ``time_to_saturation_s`` the merged headroom
    terms; any of the three may be None when the scrape failed or no
    member was fresh — an unknown sample is evidence of *nothing*
    (neither pressure nor idleness), so a flapping scrape cannot drive
    a resize.  ``dead_hosts`` counts owned hosts whose process is gone
    without a drain (the actuator's reconcile pass); ``preempted_hosts``
    counts owned members sitting in a pinned drain (a preemption
    notice) that still lack a replacement."""

    utilization: Optional[float] = None
    headroom_rps: Optional[float] = None
    time_to_saturation_s: Optional[float] = None
    routable_hosts: int = 0
    dead_hosts: int = 0
    preempted_hosts: int = 0


@dataclasses.dataclass(frozen=True)
class Decision:
    """One typed planner verdict: ``action`` is one of :data:`HOLD`,
    :data:`SCALE_OUT`, :data:`SCALE_IN`, :data:`REPLACE`; ``count`` is
    how many hosts the action moves (0 for HOLD); ``reason`` is the
    human-readable evidence line that lands in logs and spans."""

    action: str
    reason: str
    count: int = 0


class CapacityPlanner:
    """The hysteresis state machine.  Call :meth:`observe` once per
    poll with the current :class:`CapacitySignal` and the number of
    owned hosts; it returns exactly one :class:`Decision`."""

    def __init__(self, cfg: CtrlConfig,
                 registry: Optional[Registry] = None) -> None:
        self.cfg = cfg
        self.registry = registry or Registry()
        # Per-sample (pressured, idle) flags.  A sample with unknown
        # utilization contributes (False, False): no evidence.
        self._fast: Deque[Tuple[bool, bool]] = collections.deque(
            maxlen=cfg.fast_samples
        )
        self._slow: Deque[Tuple[bool, bool]] = collections.deque(
            maxlen=cfg.slow_samples
        )
        # Raw utilization for the hold-exit check (None = unknown).
        self._fast_util: Deque[Optional[float]] = collections.deque(
            maxlen=cfg.fast_samples
        )
        self._pressure = False  # the held (entered) pressure state
        self._cooldown = 0      # samples left before the next resize
        m = self.registry
        self._m_decisions = m.counter("ctrl_decisions_total")
        self._m_out = m.counter("ctrl_scale_out_total")
        self._m_in = m.counter("ctrl_scale_in_total")
        self._m_replace = m.counter("ctrl_replace_total")
        self._g_pressure = m.gauge("ctrl_pressure")
        self._g_pressure.set(0)

    # -- per-sample classification ------------------------------------

    def _classify(self, sig: CapacitySignal) -> Tuple[bool, bool]:
        """(pressured, idle) for one sample.  Pressure = hot
        utilization OR saturation forecast inside the horizon; idle =
        cold utilization AND no saturation forecast in sight."""
        cfg = self.cfg
        if sig.utilization is None:
            return False, False
        sat_soon = (
            cfg.saturation_horizon_s > 0
            and sig.time_to_saturation_s is not None
            and sig.time_to_saturation_s <= cfg.saturation_horizon_s
        )
        pressured = sig.utilization >= cfg.scale_out_utilization or sat_soon
        idle = sig.utilization <= cfg.scale_in_utilization and not sat_soon
        return pressured, idle

    # -- the state machine --------------------------------------------

    def observe(self, sig: CapacitySignal, owned_hosts: int) -> Decision:
        with _obs_span("ctrl.plan", "ctrl"):
            d = self._observe(sig, owned_hosts)
        self._m_decisions.inc()
        if d.action == SCALE_OUT:
            self._m_out.inc()
        elif d.action == SCALE_IN:
            self._m_in.inc()
        elif d.action == REPLACE:
            self._m_replace.inc(d.count)
        self._g_pressure.set(1 if self._pressure else 0)
        return d

    def _observe(self, sig: CapacitySignal, owned_hosts: int) -> Decision:
        cfg = self.cfg
        flags = self._classify(sig)
        self._fast.append(flags)
        self._slow.append(flags)
        self._fast_util.append(sig.utilization)

        # 1. Replacement first: lost capacity is a discrete event, not
        #    a trend — bypass windows AND cooldown.
        lost = sig.dead_hosts + sig.preempted_hosts
        if lost > 0:
            return Decision(
                REPLACE,
                f"{sig.dead_hosts} dead + {sig.preempted_hosts} "
                f"preempted owned host(s) need replacement",
                count=lost,
            )

        # 2. Floor repair: below min_hosts is a deficit, not a trend.
        if owned_hosts < cfg.min_hosts:
            return Decision(
                SCALE_OUT,
                f"{owned_hosts} owned host(s) below the "
                f"min_hosts={cfg.min_hosts} floor",
                count=cfg.min_hosts - owned_hosts,
            )

        # 3. Pressure enter/hold (the SLO engine's discipline).
        if not self._pressure:
            fast_full = len(self._fast) == self._fast.maxlen
            slow_full = len(self._slow) == self._slow.maxlen
            fast_all = fast_full and all(p for p, _ in self._fast)
            slow_major = slow_full and (
                sum(1 for p, _ in self._slow if p) * 2 > len(self._slow)
            )
            self._pressure = fast_all and slow_major
        else:
            known = [u for u in self._fast_util if u is not None]
            if known and (sum(known) / len(known)) < cfg.hold_utilization:
                self._pressure = False

        # 4. Cooldown gates RESIZES only (replacement already passed).
        if self._cooldown > 0:
            self._cooldown -= 1
            return Decision(HOLD, "cooldown: settling after a resize")

        if self._pressure:
            if owned_hosts >= cfg.max_hosts:
                return Decision(
                    HOLD,
                    f"pressure held but the fleet is at "
                    f"max_hosts={cfg.max_hosts}",
                )
            self._cooldown = cfg.cooldown_samples
            return Decision(
                SCALE_OUT,
                f"pressure: fast window all-pressured, utilization "
                f"{sig.utilization if sig.utilization is not None else '?'} "
                f">= {cfg.scale_out_utilization} or saturation within "
                f"{cfg.saturation_horizon_s:g}s",
                count=1,
            )

        # 5. Scale-in: every slow-window sample idle (the slow
        #    symmetric exit — growth is eager, shrink is reluctant).
        slow_full = len(self._slow) == self._slow.maxlen
        if (slow_full and all(i for _, i in self._slow)
                and owned_hosts > cfg.min_hosts):
            self._cooldown = cfg.cooldown_samples
            return Decision(
                SCALE_IN,
                f"idle: every sample in the slow window under "
                f"utilization {cfg.scale_in_utilization}",
                count=1,
            )

        return Decision(HOLD, "no window agrees on a resize")
