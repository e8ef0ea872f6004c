"""Always-on flight recorder: a ring of recent spans + anomaly dumps.

The port's copy of the JAX package's ``obs/flight.py`` (ring, spool, dump
triggers), semantics unchanged; its environment variable carries the
port's prefix. The serving and streaming slices install it.

``--trace`` is opt-in and perturbs execution (per-rep fenced launches),
so the exact anomalies the resilience/integrity layers manufacture —
hedge losers, breaker opens, witness mismatches, quarantines, p99
stragglers — vanish without a record. The flight recorder is the
request-level black box:

* **recording, not off** — :class:`FlightRecorder` is a fixed-size
  lock-light ring of :class:`~tpu_stencil_torch.obs.tracing.SpanRecord`;
  once :func:`install`'d (the serving frontends do it at start), every
  closing span lands in the ring via the same one-global read the
  tracer uses (``tracing._flight``). Appends are one short lock and
  one slot store — bounded overhead on the serve hot path (asserted by
  a tier-1 timing test, like the disabled-tracer bound) and recording
  never changes results (the bit-exactness fuzz stays green).
* **anomaly dumps** — :func:`trigger` fires on request latency over a
  configurable threshold, ``DeadlineExceeded``, breaker open, witness
  mismatch, and quarantine: the trace's spans (or the recent ring,
  when no trace id is in scope) dump as one JSON file into a capped
  ``flightrec/`` spool, and a structured event line
  (:mod:`tpu_stencil_torch.obs.events`) records the trigger.
* **lookup** — ``GET /debug/flightrec`` lists/fetches dumps;
  ``GET /debug/trace/<trace_id>`` assembles the live ring (plus the
  tracer, when enabled) into a span tree, and the federation fans the
  lookup to its members for the cross-process view.

``TPU_STENCIL_TORCH_FLIGHTREC_DIR`` overrides the configured spool directory
(the test/ops redirect); the spool keeps at most :data:`SPOOL_CAP`
dumps — oldest pruned first, the same never-unbounded discipline as
every other buffer in the repo.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from tpu_stencil_torch.obs import events as _events
from tpu_stencil_torch.obs import tracing as _tracing
from tpu_stencil_torch.obs.tracing import SpanRecord

#: Ring capacity: ~a few hundred requests' worth of spans at the serve
#: tiers' ~5 spans/request — enough history that a p99 straggler's
#: spans are still in the ring when its dump trigger fires.
DEFAULT_CAPACITY = 2048

#: Max dump files kept in the spool (oldest pruned first).
SPOOL_CAP = 64

#: When a trigger has no trace id in scope (e.g. a breaker opened on a
#: thread with no bound context), dump this many most-recent records.
RECENT_DUMP_SPANS = 256

ENV_SPOOL = "TPU_STENCIL_TORCH_FLIGHTREC_DIR"

_SAFE_FILE_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)

# "No silent caps": dumps pruned past SPOOL_CAP are counted, surfaced
# (``flightrec_dropped_total`` on /statusz and /metrics), and the FIRST
# drop emits one event line — after that the counter carries the story
# without turning the event log into a drop firehose.
_drop_lock = threading.Lock()
_dropped_total = 0
_drop_event_emitted = False


def dropped_total() -> int:
    """Dump files this process has pruned out of the spool cap."""
    with _drop_lock:
        return _dropped_total


def resolve_spool(configured: Optional[str]) -> Optional[str]:
    """The effective spool directory: the env override wins (tests and
    ops redirect a whole process without touching its flags)."""
    return os.environ.get(ENV_SPOOL) or configured


def effective_spool(configured: Optional[str] = None) -> Optional[str]:
    """Where dumps for THIS process actually land: env override, else
    the installed recorder's spool (the first installer's — the
    process has ONE recorder, so a second frontend's differing
    ``flightrec_dir`` does not move it), else ``configured``. The
    ``/debug/flightrec`` endpoints and ``/statusz`` read this, so a
    listing can never point somewhere dumps are not written."""
    env = os.environ.get(ENV_SPOOL)
    if env:
        return env
    if _recorder is not None and _recorder.spool_dir is not None:
        return _recorder.spool_dir
    return configured


def matches(rec: SpanRecord, trace_id: str) -> bool:
    """Does ``rec`` belong to ``trace_id``? Either directly (the bound
    context at close time) or via a batch-scope ``trace_ids`` arg (a
    serve dispatch span covers requests from several traces)."""
    if rec.trace_id == trace_id:
        return True
    ids = rec.args.get("trace_ids")
    return bool(ids) and trace_id in ids


def span_dict(rec: SpanRecord) -> dict:
    """One record as the JSON shape the dumps and ``/debug/trace``
    share."""
    return {
        "name": rec.name,
        "cat": rec.cat,
        "t0": rec.t0,
        "t1": rec.t1,
        "seconds": rec.seconds,
        "tid": rec.tid,
        "tname": rec.tname,
        "depth": rec.depth,
        "trace_id": rec.trace_id,
        "span_id": rec.span_id,
        "args": {k: _jsonable(v) for k, v in rec.args.items()},
    }


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def build_tree(spans: List[dict]) -> List[dict]:
    """Nest span dicts into per-thread trees by depth + interval
    containment: a span is a child of the nearest shallower span on
    its thread whose interval contains it. Returns the roots (each
    node gains a ``children`` list), ordered by start time."""
    roots: List[dict] = []
    stacks: dict = {}  # tid -> stack of open nodes
    for s in sorted(spans, key=lambda d: (d["t0"], -d["t1"])):
        node = dict(s, children=[])
        stack = stacks.setdefault(s["tid"], [])
        while stack and not (
            stack[-1]["depth"] < node["depth"]
            and stack[-1]["t0"] <= node["t0"]
            and node["t1"] <= stack[-1]["t1"] + 1e-9
        ):
            stack.pop()
        if stack:
            stack[-1]["children"].append(node)
        else:
            roots.append(node)
        stack.append(node)
    return roots


class FlightRecorder:
    """The per-process ring + spool. Construct via :func:`install`."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 spool_dir: Optional[str] = None) -> None:
        self._cap = max(16, int(capacity))
        self._ring: List[Optional[SpanRecord]] = [None] * self._cap
        self._n = 0
        self._lock = threading.Lock()
        self._dump_seq = 0
        self.spool_dir = spool_dir

    # -- the hot path --------------------------------------------------

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._ring[self._n % self._cap] = rec
            self._n += 1

    # -- views ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self._cap)

    def snapshot(self) -> List[SpanRecord]:
        """The ring's live records, oldest first."""
        with self._lock:
            n = self._n
            if n <= self._cap:
                return [r for r in self._ring[:n]]
            i = n % self._cap
            return list(self._ring[i:]) + list(self._ring[:i])

    def spans_for(self, trace_id: str) -> List[SpanRecord]:
        return [r for r in self.snapshot() if matches(r, trace_id)]

    # -- dumps ---------------------------------------------------------

    def dump(self, trigger: str, trace_id: str = "", tier: str = "",
             **info) -> Optional[str]:
        """Write one anomaly dump into the spool; returns the path
        (None when no spool directory is configured). With a trace id
        that has closed spans in the ring, the dump holds that trace's
        spans (``scope: trace``); otherwise the most recent
        :data:`RECENT_DUMP_SPANS` records (``scope: recent``)."""
        spool = resolve_spool(self.spool_dir)
        if not spool:
            return None
        scope = "trace"
        recs = self.spans_for(trace_id) if trace_id else []
        if not recs:
            # No closed span carries this trace yet (the edge span
            # that fired the trigger is typically still OPEN — the
            # fed tier's whole record of a request can be exactly
            # that one span), or no trace id was in scope at all:
            # dump the recent ring instead — the lead-up is a black
            # box too, and an empty dump defeats the feature.
            recs = self.snapshot()[-RECENT_DUMP_SPANS:]
            scope = "recent"
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        payload = {
            "schema_version": 1,
            "trigger": trigger,
            "trace_id": trace_id,
            "tier": tier,
            "scope": scope,
            "ts_unix": time.time(),
            "info": {k: _jsonable(v) for k, v in info.items()},
            "span_count": len(recs),
            "spans": [span_dict(r) for r in recs],
        }
        safe_tid = "".join(
            c for c in (trace_id or "recent") if c in _SAFE_FILE_CHARS
        )[:64] or "recent"
        name = f"{int(time.time() * 1e3)}-{seq:04d}-{trigger}-{safe_tid}.json"
        os.makedirs(spool, exist_ok=True)
        path = os.path.join(spool, name)
        with open(path, "w") as fh:
            json.dump(payload, fh, sort_keys=True)
            fh.write("\n")
        _prune_spool(spool)
        return path


def _prune_spool(spool: str) -> None:
    """Keep the spool at :data:`SPOOL_CAP` dumps, oldest pruned first
    (the timestamped names sort chronologically, so lexical order is
    age order — no fragile mtime dependence)."""
    global _dropped_total, _drop_event_emitted
    try:
        names = sorted(n for n in os.listdir(spool) if n.endswith(".json"))
    except OSError:
        return
    removed = 0
    for n in names[:-SPOOL_CAP] if len(names) > SPOOL_CAP else ():
        try:
            os.remove(os.path.join(spool, n))
            removed += 1
        except OSError:
            pass
    if removed:
        with _drop_lock:
            _dropped_total += removed
            first, _drop_event_emitted = not _drop_event_emitted, True
        if first:
            _events.emit("flightrec.spool_drop", verdict="capped",
                         spool_cap=SPOOL_CAP, dropped=removed)


# -- the process-wide recorder ----------------------------------------

_recorder: Optional[FlightRecorder] = None


def install(capacity: int = DEFAULT_CAPACITY,
            spool_dir: Optional[str] = None) -> FlightRecorder:
    """Install the process-wide recorder (idempotent: a second caller
    gets the existing one, gaining only a spool directory when the
    first installer had none — two frontends in one process share one
    ring, like one process shares one tracer)."""
    global _recorder
    if _recorder is None:
        _recorder = FlightRecorder(capacity, spool_dir)
        _tracing._set_flight(_recorder)
    elif spool_dir is not None and _recorder.spool_dir is None:
        _recorder.spool_dir = spool_dir
    return _recorder


def get() -> Optional[FlightRecorder]:
    return _recorder


def reset() -> None:
    """Drop the recorder (tests) — span() falls back to tracer-only."""
    global _recorder, _dropped_total, _drop_event_emitted
    _recorder = None
    _tracing._set_flight(None)
    with _drop_lock:
        _dropped_total = 0
        _drop_event_emitted = False


def trigger(name: str, trace_id: str = "", tier: str = "",
            duration_s: Optional[float] = None, **info) -> Optional[str]:
    """The anomaly entry point every trigger site calls: dump the
    trace's spans (when a recorder with a spool is installed) and emit
    one structured event line naming the trigger. Never raises — an
    anomaly's telemetry must not compound the anomaly.

    Reads the LIVE sink (``tracing._flight``), not the installed
    recorder: under ``obs.scratch_registry()`` (measurement probes run
    through the real engines) the sink is diverted to None, and a
    probe's anomaly must leak neither a dump nor an event line into
    the real run's black box — report-what-ran, here too."""
    rec = _tracing._flight
    if rec is None and _recorder is not None:
        return None  # diverted (scratch_registry): fully silent
    path = None
    try:
        if rec is not None:
            path = rec.dump(name, trace_id=trace_id, tier=tier, **info)
    except Exception:
        path = None
    _events.emit(f"flightrec.{name}", trace_id=trace_id, tier=tier,
                 verdict=name, duration_s=duration_s,
                 dump=os.path.basename(path) if path else None, **info)
    return path


def local_trace_spans(trace_id: str) -> List[dict]:
    """This process's closed spans for one trace, as sorted span
    dicts: the flight ring plus the live tracer (one SpanRecord
    instance reaches both sinks, so records dedup by identity). The
    shared collect behind every ``/debug/trace`` surface — net serves
    it directly, fed merges it with its members' answers."""
    recs: List[SpanRecord] = []
    if _recorder is not None:
        recs.extend(_recorder.spans_for(trace_id))
    tracer = _tracing.get_tracer()
    if tracer is not None:
        recs.extend(r for r in tracer.spans() if matches(r, trace_id))
    seen, uniq = set(), []
    for r in recs:
        if id(r) not in seen:
            seen.add(id(r))
            uniq.append(r)
    return sorted((span_dict(r) for r in uniq), key=lambda d: d["t0"])


# -- spool lookup (the /debug/flightrec endpoints) ---------------------


def spool_http_payload(spool_dir: Optional[str],
                       name: Optional[str]) -> Optional[bytes]:
    """The ``GET /debug/flightrec[/<file>]`` payload both HTTP tiers
    serve: the JSON index when ``name`` is None, one dump's raw bytes
    otherwise (None = missing/unsafe name → the handler 404s)."""
    if name is None:
        return json.dumps(spool_index(spool_dir), indent=2).encode()
    return spool_read(spool_dir, name)


def spool_index(spool_dir: Optional[str]) -> List[dict]:
    """The dump listing: one summary per spool file (newest first) —
    everything but the spans, so listing stays cheap."""
    spool = resolve_spool(spool_dir)
    if not spool or not os.path.isdir(spool):
        return []
    out = []
    for name in sorted(os.listdir(spool), reverse=True):
        if not name.endswith(".json"):
            continue
        entry = {"file": name}
        try:
            with open(os.path.join(spool, name)) as fh:
                doc = json.load(fh)
            for k in ("trigger", "trace_id", "tier", "ts_unix",
                      "span_count"):
                entry[k] = doc.get(k)
        except Exception:
            entry["error"] = "unreadable"
        out.append(entry)
    return out


def spool_read(spool_dir: Optional[str], name: str) -> Optional[bytes]:
    """One dump's raw JSON bytes, or None for a missing/unsafe name
    (path traversal in a URL must die here, not in ``open``)."""
    spool = resolve_spool(spool_dir)
    if (not spool or not name.endswith(".json")
            or any(c not in _SAFE_FILE_CHARS for c in name)):
        return None
    path = os.path.join(spool, name)
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError:
        return None
