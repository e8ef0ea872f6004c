"""Phase-level span tracing: perf_counter spans with device fence points.

The port's counterpart of the JAX package's ``obs/tracing.py``, with the
same names and semantics:

* **off unless enabled**: :func:`span` / :class:`phase` read one global;
  with no sink installed they return a shared no-op object (no
  allocation, no clock read, no lock). ``--trace``/``--breakdown`` (or
  :func:`enable`) install a :class:`Tracer`.
* **fence points**: PyTorch returns before the card finishes, so a span
  that launches device work must drain it before closing, or the time
  lands in whoever waits next. ``Span.fence(x)`` synchronizes the CUDA
  device of a tensor, or every device of a tile grid, and returns ``x``;
  CPU tensors need no fence (their ops run synchronously).
* **thread-safe**: each thread keeps its own span stack (nesting depth)
  and appends under one lock; the Chrome export draws one track per
  thread.

:class:`phase` additionally observes its duration into the process-wide
registry (:func:`registry`) as a ``phase_<name>_seconds`` histogram, so
the text exposition has driver-side distributions even with tracing off.
"""

from __future__ import annotations

import contextlib as _contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from tpu_stencil_torch.obs.context import current as _ctx_current
from tpu_stencil_torch.utils.timing import Timer, fence as _fence_devices


@dataclasses.dataclass
class SpanRecord:
    """One closed span (times are ``perf_counter`` seconds)."""

    name: str
    cat: str           # layer: driver | sharded | resilience | ...
    t0: float
    t1: float
    tid: int           # thread ident (one trace track per thread)
    tname: str         # thread name at record time
    depth: int         # nesting depth on its thread at open time
    args: Dict
    # Request correlation (obs.context): the bound trace context at close
    # time, empty for spans outside any request scope.
    trace_id: str = ""
    span_id: str = ""

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def devices_of(x) -> list:
    """The devices of a tensor, or of every tensor in a (nested) list or
    tuple of them (a tile grid); nothing for other values."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x.device]
    if isinstance(x, (list, tuple)):
        return [d for item in x for d in devices_of(item)]
    return []


def fence(x):
    """Wait until the device work that produces ``x`` (a tensor or a tile
    grid) has finished: one synchronize per distinct CUDA device. Returns
    ``x``."""
    _fence_devices(devices_of(x))
    return x


# Per-thread nesting stack, shared by every sink (tracer and flight
# recorder must agree on depth, so the stack cannot live on either).
_stack_tls = threading.local()


def _stack() -> list:
    st = getattr(_stack_tls, "stack", None)
    if st is None:
        st = _stack_tls.stack = []
    return st


class Tracer:
    """Thread-safe span sink. Construct via :func:`enable`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[SpanRecord] = []
        self.t_origin = time.perf_counter()

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def spans(self) -> List[SpanRecord]:
        """Snapshot of all closed spans, in completion order."""
        with self._lock:
            return list(self._records)


class Span:
    """Context manager recording one span on the active sinks (the
    installed :class:`Tracer` and/or the flight recorder). Exceptions
    propagate; the span still closes (a failed phase is still time
    spent)."""

    __slots__ = ("name", "cat", "args", "_tracer", "_flight",
                 "_t0", "_depth")

    def __init__(self, tracer, flight, name: str, cat: str, args: Dict):
        self._tracer = tracer
        self._flight = flight
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self) -> "Span":
        stack = _stack()
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def fence(self, x):
        """Drain the device work that produces ``x`` inside this span, so
        it is attributed here and not to whoever waits next. Returns
        ``x``."""
        return fence(x)

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        _stack().pop()
        th = threading.current_thread()
        ctx = _ctx_current()
        rec = SpanRecord(
            name=self.name, cat=self.cat, t0=self._t0, t1=t1,
            tid=th.ident or 0, tname=th.name, depth=self._depth,
            args=self.args,
            trace_id=ctx.trace_id if ctx is not None else "",
            span_id=ctx.span_id if ctx is not None else "",
        )
        if self._tracer is not None:
            self._tracer.record(rec)
        if self._flight is not None:
            self._flight.record(rec)


class _NullSpan:
    """Shared no-op span: the whole disabled-tracing code path.

    ``fence`` still drains device work: call sites use it where the fence
    is load-bearing for the surrounding measurement (keeping the warm-up
    out of the timed window), so tracing state never changes what runs,
    only whether a record is kept."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def fence(self, x):
        return fence(x)


_NULL = _NullSpan()
_tracer: Optional[Tracer] = None
# The flight-recorder sink (obs.flight installs itself via _set_flight).
_flight = None
_registry = None


def enable() -> Tracer:
    """Install a fresh process-wide tracer; returns it."""
    global _tracer
    _tracer = Tracer()
    return _tracer


def disable() -> None:
    """Remove the tracer: span()/phase() drop back to the no-op path."""
    global _tracer
    _tracer = None


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def sinks_active() -> bool:
    """True when a span sink (the tracer or the flight recorder) is
    installed: the guard for per-frame record work."""
    return _tracer is not None or _flight is not None


def _set_flight(recorder) -> None:
    """Install (or clear) the flight-recorder sink; called only by
    :mod:`tpu_stencil_torch.obs.flight`."""
    global _flight
    _flight = recorder


def emit_span(name: str, cat: str, t0: float, t1: float,
              trace_id: str = "", span_id: str = "", **args) -> None:
    """Record one already-closed span directly, with an explicit trace
    id. No-op when no sink is installed."""
    t, f = _tracer, _flight
    if t is None and f is None:
        return
    th = threading.current_thread()
    rec = SpanRecord(
        name=name, cat=cat, t0=t0, t1=t1, tid=th.ident or 0,
        tname=th.name, depth=0, args=args,
        trace_id=trace_id, span_id=span_id,
    )
    if t is not None:
        t.record(rec)
    if f is not None:
        f.record(rec)


def registry():
    """The process-wide driver-side metrics registry (counters and
    ``phase_*_seconds`` histograms): a
    :class:`tpu_stencil_torch.serve.metrics.Registry`."""
    global _registry
    if _registry is None:
        from tpu_stencil_torch.serve.metrics import Registry

        _registry = Registry()
    return _registry


def snapshot() -> dict:
    """``registry().snapshot()``."""
    return registry().snapshot()


def reset() -> None:
    """Drop the tracer AND the accumulated metrics (tests)."""
    global _tracer, _registry
    _tracer = None
    _registry = None


@_contextlib.contextmanager
def scratch_registry():
    """Divert the process-wide registry to a throwaway, and silence the
    tracer and the flight recorder, for the duration: measurement probes
    must not land in the run's own exposition or trace. The previous
    registry, tracer and recorder are restored on exit."""
    global _registry, _tracer, _flight
    from tpu_stencil_torch.serve.metrics import Registry

    prev_registry, prev_tracer, prev_flight = _registry, _tracer, _flight
    _registry = Registry()
    _tracer = None
    _flight = None
    try:
        yield _registry
    finally:
        _registry = prev_registry
        _tracer = prev_tracer
        _flight = prev_flight


def span(name: str, cat: str = "", **args):
    """A recorded span when a sink is installed, a shared no-op
    otherwise."""
    t = _tracer
    f = _flight
    if t is None and f is None:
        return _NULL
    return Span(t, f, name, cat, args)


class phase:
    """Time one named pipeline phase.

    Always observes the duration into ``registry()`` as a
    ``phase_<name>_seconds`` histogram (per phase, not per rep);
    additionally emits a trace span when tracing is enabled. Wraps
    :class:`tpu_stencil_torch.utils.timing.Timer`.
    """

    __slots__ = ("name", "cat", "args", "_span", "_timer")

    def __init__(self, name: str, cat: str = "driver", **args):
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self):
        self._span = span(self.name, self.cat, **self.args)
        self._span.__enter__()
        self._timer = Timer(label=self.name).__enter__()
        return self._span

    def __exit__(self, *exc) -> None:
        self._timer.__exit__(*exc)
        registry().histogram(f"phase_{self.name}_seconds").observe(
            self._timer.elapsed
        )
        self._span.__exit__(*exc)
