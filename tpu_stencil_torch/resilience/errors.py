"""The typed failure vocabulary of the resilience layer.

The port's counterpart of the JAX package's ``resilience/errors.py``:
every error a layer raises on purpose is a class here, so callers can
assert "failed typed" instead of matching messages.
"""

from __future__ import annotations

from typing import Optional


class ResilienceError(RuntimeError):
    """Base class of every typed failure the resilience layer raises."""


class DeadlineExceeded(ResilienceError):
    """A deadline expired before the work was served. Permanent by
    classification: retrying the same expired request can only expire
    again."""


class WorkerCrashed(ResilienceError):
    """The serve engine's worker thread died from an unhandled exception.
    Every queued and in-flight future fails with this (they would
    otherwise wait forever), and later submits are rejected with it: a
    crashed server stays typed-dead until it is constructed anew."""


class HostUnavailable(ResilienceError):
    """A federation member host cannot take traffic right now: its circuit
    breaker is open after consecutive transport failures, every routable
    member's forward attempt failed, or no routable member remains at all
    (:mod:`tpu_stencil_torch.fed`). Transient by classification: breakers
    half-open after their cooldown and the membership heartbeat re-admits
    recovering hosts, so a later attempt may land (the federation
    frontend answers 503 + Retry-After). ``host`` names the member when
    the failure is host-scoped (None when no member is routable)."""

    def __init__(self, msg: str, host: Optional[str] = None) -> None:
        super().__init__(msg)
        self.host = host


class InjectedFault(ResilienceError):
    """A fault fired by the injection harness (:mod:`.faults`).

    ``point``/``index`` name the injection site and the call index that
    fired."""

    point: Optional[str] = None
    index: Optional[int] = None


class InjectedOOM(InjectedFault):
    """An injected resource-exhaustion failure. The message carries the
    ``RESOURCE_EXHAUSTED`` token of the JAX package's, so an injection
    spec reads the same in both packages; the fallback ladder demotes on
    it (:func:`tpu_stencil_torch.resilience.fallback.demotable`)."""

    def __init__(self, msg: str = "") -> None:
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected VMEM/HBM OOM{': ' if msg else ''}"
            f"{msg}"
        )


class FatalInjectedFault(BaseException):
    """An injected failure that deliberately escapes ``except Exception``
    handlers: the stand-in for a worker thread dying outright. A
    ``BaseException`` on purpose, so per-batch catch-alls cannot absorb
    it."""

    point: Optional[str] = None
    index: Optional[int] = None


class DispatchTimeout(ResilienceError):
    """Device work did not finish within the watchdog window
    (:func:`tpu_stencil_torch.resilience.deadline.fence`): a hang turned
    into a typed error. The queued work itself cannot be cancelled (the
    watchdog abandons a daemon thread parked in the synchronize); what
    the timeout buys is that the caller gets control back, typed."""

    def __init__(self, label: str, seconds: float) -> None:
        super().__init__(
            f"device dispatch {label!r} still pending after {seconds:g}s "
            "watchdog window (hung device?)"
        )
        self.label = label
        self.seconds = seconds


class CollectiveTimeout(DispatchTimeout):
    """A sharded run's dispatch timed out: a device fence of the window,
    or a wait on a cross-process strip exchange (a wedged peer blocks the
    host there). ``edges`` carries the per-edge exchange-probe verdicts
    (``{"n": "ok (1.2ms)"|"timeout"|"error: ...", "s": ..., "w": ...,
    "e": ...}``, :meth:`~tpu_stencil_torch.parallel.sharded.
    ShardedRunner.diagnose_edges`) when a post-mortem could run: which
    edge's ghost traffic is wedged, beside the healthy edges' latencies.
    Across processes it stays empty (the probes would exchange with ranks
    that did not time out)."""

    def __init__(self, label: str, seconds: float,
                 edges: Optional[dict] = None) -> None:
        super().__init__(label, seconds)
        self.edges = dict(edges or {})
        if self.edges:
            self.args = (
                f"{self.args[0]} (per-edge exchange probes: {self.edges})",
            )
