"""Phase-level span tracing: perf_counter spans with device fence points.

The port's counterpart of the JAX package's ``obs/tracing.py``, with the
same names and semantics:

* **off unless enabled**: :func:`span` / :class:`phase` read three
  globals; with no sink active they return a shared no-op object (no
  allocation, no clock read, no lock). ``--trace``/``--breakdown`` (or
  :func:`enable`) install a :class:`Tracer`.
* **three sinks**: the :class:`Tracer`, the flight recorder
  (:mod:`~tpu_stencil_torch.obs.flight`), and the profiler sink, which is
  active exactly while a ``torch.profiler`` collects (torch's own
  ``_is_profiler_enabled`` flag). The first two stamp ``perf_counter``
  seconds; the profiler sink stamps ``time.time_ns()``, Unix-epoch ns,
  the base of the profiler's host events and of Kineto's device
  operations, so a program span lies on the device timeline (up to that
  timeline's own drift from the host's, which
  ``benchmark/harness/program_spans.aligned`` takes out).
  :func:`profiled_spans` reads it for a window, and the Chrome traces of
  ``--profile`` and ``/debug/prof`` carry its records
  (:func:`~tpu_stencil_torch.obs.export.add_profiled_spans`). A
  ``profiler_only`` span (the job path's ``model.place`` and
  ``model.issue``, and ``host.gc``, one span per garbage collection) goes
  to the profiler sink alone, so the ``--trace`` span list stays the JAX
  package's.
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

import collections
import contextlib as _contextlib
import dataclasses
import gc
import threading
import time
from typing import Dict, List, NamedTuple, Optional

# Its module global _is_profiler_enabled is set while a torch.profiler
# collects: the profiler sink is active exactly then.
from torch.autograd import profiler as _torch_profiler

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


def _profiled_depth() -> int:
    """Spans of the profiler sink open on this thread."""
    return getattr(_stack_tls, "profiled", 0)


class ProfiledSpan(NamedTuple):
    """One closed span of the profiler sink: a plain tuple, no dict of
    its own. Stamps are ``time.time_ns()``, the profiler's base."""

    name: str
    cat: str
    tid: int       # the thread's native id (the profiler's host tid)
    depth: int     # profiler-sink spans open on the thread at open time
    args: Dict
    start_ns: int
    end_ns: int


#: Records the profiler sink keeps; past it the oldest go, counted.
PROFILED_CAP = 1 << 17


class ProfilerSink:
    """The last :data:`PROFILED_CAP` closed spans recorded while a
    ``torch.profiler`` collected, and how many older ones were dropped.

    Appends from any thread; the lock is reentrant because a garbage
    collection, which records ``host.gc``, may run inside a record."""

    def __init__(self, cap: int = PROFILED_CAP) -> None:
        self._lock = threading.RLock()
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self.dropped = 0

    def record(self, rec: ProfiledSpan) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def spans(self, start_ns: int, end_ns: int) -> List[ProfiledSpan]:
        """The kept records that overlap [start_ns, end_ns], by start."""
        with self._lock:
            recs = list(self._ring)
        return sorted((r for r in recs
                       if r.end_ns >= start_ns and r.start_ns <= end_ns),
                      key=lambda r: r.start_ns)

    def dropped_in(self, start_ns: int, end_ns: int) -> int:
        """The dropped count when a dropped record may overlap
        [start_ns, end_ns], else 0. Records are kept in the order they
        close, so every dropped one closed before the oldest kept one."""
        with self._lock:
            if not self.dropped:
                return 0
            oldest_end = self._ring[0].end_ns if self._ring else end_ns
        return self.dropped if oldest_end >= start_ns else 0


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
    installed :class:`Tracer`, the flight recorder and the profiler
    sink). Exceptions propagate; the span still closes (a failed phase is
    still time spent). ``args`` may be added to until it closes."""

    __slots__ = ("name", "cat", "args", "_tracer", "_flight", "_profiled",
                 "_t0", "_depth", "_t0_ns", "_profiled_depth")

    recording = True

    def __init__(self, tracer, flight, name: str, cat: str, args: Dict,
                 profiled: bool = False):
        self._tracer = tracer
        self._flight = flight
        self._profiled = profiled
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self) -> "Span":
        if self._tracer is not None or self._flight is not None:
            stack = _stack()
            self._depth = len(stack)
            stack.append(self.name)
        self._t0 = time.perf_counter()
        if self._profiled:
            self._profiled_depth = _profiled_depth()
            _stack_tls.profiled = self._profiled_depth + 1
            self._t0_ns = time.time_ns()
        return self

    def fence(self, x):
        """Drain the device work that produces ``x`` inside this span, so
        it is attributed here and not to whoever waits next. Returns
        ``x``."""
        return fence(x)

    def __exit__(self, *exc) -> None:
        t1_ns = time.time_ns() if self._profiled else 0
        t1 = time.perf_counter()
        th = threading.current_thread()
        if self._profiled:
            _stack_tls.profiled = self._profiled_depth
            _profiled.record(ProfiledSpan(
                self.name, self.cat, th.native_id or 0,
                self._profiled_depth, self.args, self._t0_ns, t1_ns))
        if self._tracer is None and self._flight is None:
            return
        _stack().pop()
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

    recording = False

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
# The profiler sink: always there, recorded into only while a
# torch.profiler collects.
_profiled = ProfilerSink()


def profiling() -> bool:
    """True while a ``torch.profiler`` collects (the profiler sink is
    active): one module-global read, the guard for a hot path's
    profiler-only spans."""
    return _torch_profiler._is_profiler_enabled


def profiled_spans(start_ns: int, end_ns: int) -> List[ProfiledSpan]:
    """The profiler sink's records that overlap [start_ns, end_ns]
    (``time.time_ns()`` stamps), by start."""
    return _profiled.spans(start_ns, end_ns)


def profiled_dropped(start_ns: int, end_ns: int) -> int:
    """How many records the profiler sink dropped past its cap, when a
    dropped one may overlap [start_ns, end_ns]; 0 when the window's
    records are whole."""
    return _profiled.dropped_in(start_ns, end_ns)


# The open collection's start stamp (0: none, or not profiled). The
# interpreter runs one collection at a time.
_gc_t0_ns = 0


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: one ``host.gc`` span a collection, while
    profiling; returns at once otherwise."""
    global _gc_t0_ns
    if phase == "start":
        if _torch_profiler._is_profiler_enabled:
            _gc_t0_ns = time.time_ns()
        return
    t0, _gc_t0_ns = _gc_t0_ns, 0
    if not t0:
        return
    _profiled.record(ProfiledSpan(
        "host.gc", "runtime", threading.get_native_id(), _profiled_depth(),
        {"generation": info.get("generation"),
         "collected": info.get("collected")}, t0, time.time_ns()))


gc.callbacks.append(_on_gc)


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
    """Drop the tracer, the accumulated metrics and the profiler sink's
    records (tests)."""
    global _tracer, _registry, _profiled
    _tracer = None
    _registry = None
    _profiled = ProfilerSink()


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


def span(name: str, cat: str = "", profiler_only: bool = False, **args):
    """A recorded span when a sink is active, a shared no-op otherwise.
    ``profiler_only``: recorded into the profiler sink alone (a no-op
    unless a ``torch.profiler`` collects)."""
    p = _torch_profiler._is_profiler_enabled
    if profiler_only:
        return Span(None, None, name, cat, args, True) if p else _NULL
    t = _tracer
    f = _flight
    if t is None and f is None and not p:
        return _NULL
    return Span(t, f, name, cat, args, p)


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
