"""The program's own spans in a traced window, laid against the device's
operations.

The port keeps the spans it records while a ``torch.profiler`` collects
(``tpu_stencil_torch.obs.tracing.profiled_spans``), stamped on the
profiler's base, Unix-epoch ns, as the capture's bounds and host spans
are. Here they are read for the capture's window and cut into the
stretches where one span is the innermost open one on its thread.
A program without that sink, or one whose sink dropped records inside
the window, gives nothing to read.

The profiler's device timestamps are not held to its host timestamps:
on an H100 they were seen to drift from them by about 100 ppm for
seconds at a time and then jump back, up to 0.8 ms apart in a 40 s
window. :func:`aligned` ties the two by causality before a device
interval is laid against a host span.
"""

from __future__ import annotations

import bisect
import threading
from typing import List, Optional, Sequence, Tuple

from benchmark.harness.trace import Capture, DeviceOp

MODEL = "model."      # the job path's spans: model.place, model.issue
PLACE = "model.place"
ISSUE = "model.issue"
GC = "host.gc"        # one span per garbage collection

Interval = Tuple[int, int]


def window_spans(capture) -> Optional[list]:
    """The program's spans that overlap ``capture``'s window; None when
    there is no capture, no sink in the program, a drop inside the
    window, or no span at all."""
    if capture is None:
        return None
    try:
        from tpu_stencil_torch.obs import tracing

        read, dropped = tracing.profiled_spans, tracing.profiled_dropped
    except (ImportError, AttributeError):
        return None
    if dropped(capture.start_ns, capture.end_ns):
        return None
    return read(capture.start_ns, capture.end_ns) or None


def innermost(spans: Sequence, lo: int, hi: int
              ) -> List[Tuple[int, int, str]]:
    """(start, end, name) stretches of [lo, hi] in which the span ``name``
    is the innermost one open, for the spans of one thread (nested, as
    context managers nest them); stretches with no span open are left
    out. A span's stretches sum to its self time."""
    out: List[Tuple[int, int, str]] = []

    def emit(s: int, e: int, name: str) -> None:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e, name))

    stack: list = []
    t = lo
    for sp in sorted(spans, key=lambda r: (r.start_ns, -r.end_ns)):
        while stack and stack[-1].end_ns <= sp.start_ns:
            top = stack.pop()
            emit(t, top.end_ns, top.name)
            t = max(t, top.end_ns)
        if stack:
            emit(t, sp.start_ns, stack[-1].name)
        t = max(t, sp.start_ns)
        stack.append(sp)
    while stack:
        top = stack.pop()
        emit(t, top.end_ns, top.name)
        t = max(t, top.end_ns)
    return out


def thread_spans(spans: Sequence, tid: Optional[int] = None) -> list:
    """The spans of thread ``tid``'s native id (default: this thread's,
    which ran the window: ``run_cell`` runs the window and the readers
    on one thread)."""
    tid = threading.get_native_id() if tid is None else tid
    return [r for r in spans if r.tid == tid]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(capture, device: int) -> List[Interval]:
    """The stretches of the window in which ``device`` ran nothing."""
    out: List[Interval] = []
    t = capture.start_ns
    for s, e in capture.busy_intervals(device) + [(capture.end_ns,
                                                    capture.end_ns)]:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    return out


def aligned(capture, spans: Sequence) -> Optional[Capture]:
    """``capture`` with its device operations moved onto the host's
    clock; None when the window has no copies to tie them by.

    A ``model.place`` span issues one host-to-card copy and waits for
    it, so the copy runs inside the span: the calling thread's spans and
    the window's copies, paired in order, bound the device's offset from
    the host at each copy to [place start - copy start, place end - copy
    end]. The offset taken at each copy is the one nearest the last
    within its bounds (0 before the first), and it moves the device's
    operations from that copy's start to the next's."""
    places = sorted((r for r in thread_spans(spans) if r.name == PLACE),
                    key=lambda r: r.start_ns)
    copies = sorted((op for op in capture.ops if op.kind == "h2d"),
                    key=lambda op: op.start_ns)
    if not copies or not 0 <= len(places) - len(copies) <= 1:
        return None
    starts, offsets = [], []
    offset = 0
    for place, copy in zip(places, copies):
        lo = place.start_ns - copy.start_ns
        hi = place.end_ns - copy.end_ns
        if lo > hi:
            return None
        offset = min(max(offset, lo), hi)
        starts.append(copy.start_ns)
        offsets.append(offset)
    ops = []
    for op in capture.ops:
        i = max(0, bisect.bisect_right(starts, op.start_ns) - 1)
        s = max(op.start_ns + offsets[i], capture.start_ns)
        e = min(op.end_ns + offsets[i], capture.end_ns)
        if e > s:
            ops.append(DeviceOp(op.name, op.device, s, e))
    return Capture(capture.start_ns, capture.end_ns, ops, capture.spans)


def idle_pct(ctx, match) -> Optional[float]:
    """:func:`idle_pct_under` of the traced window, its device operations
    :func:`aligned`; None when there is nothing to read."""
    spans = window_spans(ctx.capture)
    if spans is None or ctx.capture.window_s <= 0:
        return None
    capture = aligned(ctx.capture, spans)
    if capture is None:
        return None
    return idle_pct_under(capture, spans, ctx.chips, match)


def idle_pct_under(capture, spans: Sequence, chips: int, match) -> float:
    """The share of the window, in %, in which a card was idle and the
    innermost open span on the calling thread satisfied ``match(name)``,
    averaged over the cell's ``chips`` cards (a card with no operation
    is idle all through)."""
    lo, hi = capture.start_ns, capture.end_ns
    under = [(s, e) for s, e, name in innermost(thread_spans(spans), lo, hi)
             if match(name)]
    devices = capture.devices()
    idle = sum(overlap_ns(idle_intervals(capture, d), under)
               for d in devices)
    idle += (chips - len(devices)) * sum(e - s for s, e in under)
    return 100.0 * idle / chips / (hi - lo)


def self_ns(spans: Sequence, name: str, lo: int, hi: int) -> int:
    """Self time inside [lo, hi] of the spans called ``name``, summed
    over every thread: their time less what spans inside them (a
    ``host.gc`` among them) cover."""
    total = 0
    for tid in {r.tid for r in spans}:
        total += sum(e - s for s, e, n in
                     innermost(thread_spans(spans, tid), lo, hi)
                     if n == name)
    return total
