"""Request-scoped trace context: ``X-Trace-Id`` / ``X-Span-Id``.

The port's copy of the JAX package's ``obs/context.py``, semantics
unchanged; the serving and streaming slices of the port bind it.

The obs layer could explain a *process* (spans, Chrome export,
``/metrics``) but not a *request*: nothing correlated one
``POST /v1/blur`` across fed → net → replica → device. This module is
the W3C-traceparent-style correlation primitive the whole serving
stack shares:

* **minting** — the outermost edge (fed; net when unfederated; loadgen
  as the client) mints a 16-byte ``trace_id`` and an 8-byte
  ``span_id`` (lower-hex, ``os.urandom`` — no seeded-RNG coupling with
  anything that affects results).
* **propagation** — every hop forwards ``X-Trace-Id`` and mints its
  own ``X-Span-Id`` (the inbound span id becomes the parent), so each
  hedge leg of a federation forward carries its own span id under one
  trace id.
* **binding** — :func:`bind` installs the context in a ``contextvar``
  for the handler's duration; :mod:`tpu_stencil_torch.obs.tracing` reads it
  when a span record closes, so the existing ``obs.span`` vocabulary
  (``fed.request`` → ``net.request`` → ``serve.execute`` → per-phase
  spans) stitches into one cross-process trace with no signature
  changes at the call sites.
* **validation** — inbound header values are untrusted: anything not
  matching :data:`_WIRE_RE` (1-64 URL-safe chars) is discarded and a
  fresh trace minted, so a hostile header can never ride into metric
  names, file names, or log lines.

The stream engine uses the frame index as its trace-id analog
(:func:`frame_context`): ``frame-<i>`` correlates a frame's
read/h2d/compute/d2h/write spans and its flight-recorder dump the way
a trace id correlates a request's hops.

Dependency-free, like the rest of the wire-level obs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import re
from typing import Optional

TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"

#: Wire-format guard for inbound ids: URL-safe, bounded. An inbound
#: value failing this is DISCARDED (fresh mint), never echoed.
_WIRE_RE = re.compile(r"^[0-9A-Za-z_.-]{1,64}$")

_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("tpu_stencil_torch_trace_context", default=None)
)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's view of a request: the shared trace id, this hop's
    span id, and (when the request arrived with one) the parent hop's
    span id."""

    trace_id: str
    span_id: str
    parent_span_id: str = ""


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def valid_id(value) -> bool:
    return isinstance(value, str) and bool(_WIRE_RE.match(value))


def fresh() -> TraceContext:
    """Mint a brand-new trace (the outermost-edge / client case)."""
    return TraceContext(new_trace_id(), new_span_id())


def frame_context(index: int) -> TraceContext:
    """The stream engine's trace-id analog: frame ``index`` as the
    correlation key (``frame-<i>``), one fresh span id per binding."""
    return TraceContext(f"frame-{int(index)}", new_span_id())


def from_headers(headers) -> TraceContext:
    """The inbound edge: adopt a valid ``X-Trace-Id`` (this hop mints
    its own span id; the inbound span id becomes the parent), mint a
    fresh trace otherwise. ``headers`` is any ``.get``-able mapping
    (``email.message.Message``, dict)."""
    tid = headers.get(TRACE_HEADER)
    if not valid_id(tid):
        return fresh()
    parent = headers.get(SPAN_HEADER)
    return TraceContext(
        tid, new_span_id(), parent if valid_id(parent) else ""
    )


def headers_for(ctx: TraceContext,
                span_id: Optional[str] = None) -> dict:
    """The outbound hop's header pair. ``span_id`` overrides the
    context's own (each hedge leg gets its own span id under the one
    trace id)."""
    return {TRACE_HEADER: ctx.trace_id,
            SPAN_HEADER: span_id or ctx.span_id}


def current() -> Optional[TraceContext]:
    return _current.get()


def push(ctx: Optional[TraceContext]):
    """Non-contextmanager binding (for __enter__/__exit__ pairs that
    cannot nest a ``with``); pair with :func:`pop`."""
    return _current.set(ctx)


def pop(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def bind(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the current trace context for the block.
    Binding ``None`` explicitly clears it (an attempt thread must not
    inherit a stale context from thread reuse)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)
