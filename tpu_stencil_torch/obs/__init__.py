"""Observability of the port: span tracing, trace export, metrics text.

The port's counterpart of the JAX package's ``obs`` facade, with the same
metric and span names, so one dashboard reads both packages:

* :mod:`~tpu_stencil_torch.obs.tracing`: the ``span``/``phase`` API,
  perf_counter spans with device fence points (``Span.fence``
  synchronizes the CUDA devices of a tensor or tile grid); a no-op unless
  :func:`enable` has run, the flight recorder is installed or a
  ``torch.profiler`` collects. ``phase`` always feeds the driver
  registry's ``phase_*_seconds`` histograms. Its third sink, the
  profiler sink, keeps every span closed while a profiler collects,
  stamped with ``time.time_ns()`` (the profiler's own base, so a span
  lies on the device timeline), and the profiler-only spans of the job
  path (``model.place``, ``model.issue``) and of the runtime
  (``host.gc``); ``tracing.profiled_spans`` reads a window of it.
* :mod:`~tpu_stencil_torch.obs.context`, :mod:`~.events`,
  :mod:`~.flight`: request correlation ids, the structured event log and
  the flight recorder (ring, spool, dump triggers).
* :mod:`~tpu_stencil_torch.obs.export`: Chrome trace-event JSON of one
  process (``--trace out.json``, loadable in Perfetto), and the profiler
  sink's spans added to the traces of ``--profile`` and ``/debug/prof``.
* :mod:`~tpu_stencil_torch.obs.exposition`: Prometheus-style text of a
  registry snapshot (``--metrics-text``), with its exact parser.
* :mod:`~tpu_stencil_torch.obs.breakdown`: the ``--breakdown`` tables.
* :mod:`~tpu_stencil_torch.obs.introspect`: the kernel instances the
  warm-up launched, and the device-memory gauges.
* :mod:`~tpu_stencil_torch.obs.timeseries`: the in-process time series,
  a sampler thread over a registry snapshot (``/debug/timeseries``).
* :mod:`~tpu_stencil_torch.obs.slo`: declarative objectives with fast and
  slow burn-rate alerting; a breach flips ``/healthz`` to ``degraded``.
* :mod:`~tpu_stencil_torch.obs.prof`: bounded on-demand
  ``torch.profiler`` captures behind ``POST /debug/prof``.

The request ledger (:mod:`~tpu_stencil_torch.obs.ledger`) and the perf
sentry (:mod:`~tpu_stencil_torch.obs.sentry`) are imported by name.
"""

from tpu_stencil_torch.obs.tracing import (
    Span,
    SpanRecord,
    Tracer,
    disable,
    emit_span,
    enable,
    enabled,
    get_tracer,
    phase,
    registry,
    scratch_registry,
    snapshot,
    span,
)
from tpu_stencil_torch.obs import (
    breakdown,
    context,
    events,
    export,
    exposition,
    flight,
    introspect,
    prof,
    slo,
    timeseries,
    tracing,
)


def reset() -> None:
    """Drop the tracer, the accumulated metrics, the flight recorder, the
    event-stream override and the introspection records (tests): one
    teardown for the whole obs subsystem."""
    tracing.reset()
    flight.reset()
    events.reset()
    introspect.reset()


__all__ = [
    "Span",
    "SpanRecord",
    "Tracer",
    "breakdown",
    "context",
    "disable",
    "emit_span",
    "enable",
    "enabled",
    "events",
    "export",
    "exposition",
    "flight",
    "get_tracer",
    "introspect",
    "phase",
    "prof",
    "registry",
    "reset",
    "scratch_registry",
    "slo",
    "snapshot",
    "span",
    "timeseries",
    "tracing",
]
