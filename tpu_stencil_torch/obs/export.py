"""Chrome trace-event JSON export (Perfetto/chrome://tracing loadable).

The port's counterpart of the JAX package's ``obs/export.py``: span
records become complete ("X") events, ``ts``/``dur`` in microseconds
relative to the tracer's origin, one ``tid`` track per recording thread
(metadata events name the process and each thread). With several
processes every rank's events are gathered (:func:`merged_events`, its
``pid`` the rank) and rank 0 writes the one merged file.

:func:`add_profiled_spans` puts the profiler sink's spans into a Chrome
trace that ``torch.profiler`` wrote, on that trace's own timebase.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from tpu_stencil_torch.obs import tracing as _tracing
from tpu_stencil_torch.obs.tracing import Tracer


def chrome_events(tracer: Tracer, pid: int = 0,
                  trace_id: Optional[str] = None) -> List[dict]:
    """This process's spans as Chrome trace events (metadata included).
    ``trace_id`` filters to one request's spans (the
    :mod:`~tpu_stencil_torch.obs.context` correlation id; batch-scope
    spans carrying the id in their ``trace_ids`` arg match too)."""
    from tpu_stencil_torch.obs import flight as _flight

    events: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": f"tpu_stencil_torch p{pid}"},
    }]
    # Stable small tids in first-seen order: Perfetto sorts tracks by tid,
    # so the main thread (first recorder) stays on top.
    tids: dict = {}
    for rec in tracer.spans():
        if trace_id is not None and not _flight.matches(rec, trace_id):
            continue
        tid = tids.get(rec.tid)
        if tid is None:
            tid = tids[rec.tid] = len(tids)
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": rec.tname},
            })
        args = dict(rec.args, depth=rec.depth)
        if rec.trace_id:
            args["trace_id"] = rec.trace_id
            args["span_id"] = rec.span_id
        events.append({
            "name": rec.name,
            "cat": rec.cat or "tpu_stencil_torch",
            "ph": "X",
            "ts": round((rec.t0 - tracer.t_origin) * 1e6, 3),
            "dur": round(rec.seconds * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return events


def merged_events(tracer: Tracer,
                  trace_id: Optional[str] = None) -> List[dict]:
    """Every process's events (``pid`` = its rank), gathered to every
    process; one process: this tracer's. ``trace_id`` filters on each
    process before the gather. A collective: every process calls it."""
    from tpu_stencil_torch.parallel import distributed

    local = chrome_events(tracer, pid=distributed.process_index(),
                          trace_id=trace_id)
    if distributed.process_count() == 1:
        return local
    merged: List[dict] = []
    for blob in distributed.allgather_bytes(json.dumps(local).encode()):
        merged.extend(json.loads(blob.decode()))
    return merged


def write_chrome_trace(path: str, tracer: Tracer,
                       trace_id: Optional[str] = None) -> Optional[str]:
    """Write the merged trace to ``path`` (``trace_id``: one request's
    cross-thread view instead of the whole run): every process joins the
    gather, rank 0 writes. Returns ``path`` on rank 0, None elsewhere."""
    from tpu_stencil_torch.parallel import distributed

    events = merged_events(tracer, trace_id=trace_id)
    if distributed.process_index() != 0:
        return None
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
        fh.write("\n")
    return path


def add_profiled_spans(path: str, start_ns: int, end_ns: int) -> int:
    """Add the profiler sink's spans that overlap [start_ns, end_ns]
    (``time.time_ns()`` stamps) to the ``torch.profiler`` Chrome trace at
    ``path``, as complete events on this process's host tracks: ``ts`` is
    microseconds past the trace's ``baseTimeNanoseconds`` (0 when it has
    none), as the profiler's own events are. Returns how many were
    added."""
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    added = [{
        "ph": "X", "name": r.name, "cat": r.cat or "tpu_stencil_torch",
        "pid": pid, "tid": r.tid, "ts": (r.start_ns - base) / 1e3,
        "dur": (r.end_ns - r.start_ns) / 1e3,
        "args": dict(r.args, depth=r.depth),
    } for r in _tracing.profiled_spans(start_ns, end_ns)]
    trace.setdefault("traceEvents", []).extend(added)
    with open(path, "w") as fh:
        json.dump(trace, fh, default=str)
    return len(added)
