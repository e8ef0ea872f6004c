"""Structured event log: one-line JSON on a dedicated stream.

The port's copy of the JAX package's ``obs/events.py``, semantics
unchanged; its environment variable carries the port's prefix.

The third leg of request-level observability (next to trace
propagation and the flight recorder): anomaly triggers and tier
transitions emit exactly one JSON line each — trace id, tier, verdict
taxonomy name, duration — so ``grep <trace_id>`` over the event stream
reconstructs a request post-mortem with no endpoint alive.

The stream is stderr by default; ``TPU_STENCIL_TORCH_EVENT_LOG=<path>``
redirects it to an append-only file (the production spelling — one
file per process, greppable after the process is gone), and tests
install an in-memory stream via :func:`set_stream`.

Emission must never perturb serving: :func:`emit` swallows every
exception (a full disk or closed stream costs the event, never the
request), takes one short lock for line atomicity, and is only called
at anomaly/transition sites — never on the per-request hot path.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

ENV_VAR = "TPU_STENCIL_TORCH_EVENT_LOG"

_lock = threading.Lock()
_stream = None            # explicit override (tests / embedders)
_file = None              # cached (path, handle) for the env redirect


def set_stream(stream) -> None:
    """Install an explicit event stream (None reverts to the env/
    stderr resolution)."""
    global _stream
    with _lock:
        _stream = stream


def reset() -> None:
    """Drop the explicit stream and the cached env file handle."""
    global _stream, _file
    with _lock:
        _stream = None
        if _file is not None:
            try:
                _file[1].close()
            except Exception:
                pass
        _file = None


def _resolve_stream():
    """Caller holds ``_lock``. Explicit stream > env file > stderr."""
    global _file
    if _stream is not None:
        return _stream
    path = os.environ.get(ENV_VAR)
    if path:
        if _file is None or _file[0] != path:
            if _file is not None:
                try:
                    _file[1].close()
                except Exception:
                    pass
            _file = (path, open(path, "a"))
        return _file[1]
    return sys.stderr


def emit(event: str, trace_id: str = "", tier: str = "",
         verdict: str = "", duration_s: Optional[float] = None,
         **fields) -> None:
    """Emit one event line. Empty/None core fields are omitted so the
    line stays grep-friendly; extra ``fields`` ride along verbatim
    (JSON-serializable values only — anything else is repr'd)."""
    rec = {"event": event, "ts_unix": round(time.time(), 6)}
    if trace_id:
        rec["trace_id"] = trace_id
    if tier:
        rec["tier"] = tier
    if verdict:
        rec["verdict"] = verdict
    if duration_s is not None:
        rec["duration_s"] = round(float(duration_s), 6)
    for k, v in fields.items():
        if v is None:
            continue
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            v = repr(v)
        rec[k] = v
    try:
        line = json.dumps(rec, sort_keys=True)
        with _lock:
            stream = _resolve_stream()
            stream.write(line + "\n")
            stream.flush()
    except Exception:
        pass  # the event is telemetry; losing it must cost nothing
