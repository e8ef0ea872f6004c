"""One reader per per-layer metric (``benchmark/metrics/<name>.py``), each
``read(ctx) -> float | None``: None when it finds nothing to read, and the
harness then leaves the metric out of the line."""
