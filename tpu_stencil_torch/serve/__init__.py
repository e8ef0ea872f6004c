"""Async micro-batching serving of the port (the JAX package's
``serve``): a bounded queue with backpressure, a micro-batching scheduler
over shape buckets, a program cache, a double-buffered worker loop on the
card's streams, and a metrics registry.

>>> from tpu_stencil_torch.serve import StencilServer, ServeConfig
>>> with StencilServer(ServeConfig(max_queue=64)) as server:
...     out = server.submit(img_u8, reps=40).result()

CLI: ``python -m tpu_stencil_torch serve --help`` (synthetic load
generator, ``--self-test``, ``--stats-json``, ``--perf-log``).
"""

from tpu_stencil_torch.config import ServeConfig
from tpu_stencil_torch.serve.engine import (
    GroupItem,
    QueueFull,
    ServerClosed,
    StencilServer,
    get_last_server,
)
from tpu_stencil_torch.serve.metrics import Registry


def stats() -> dict:
    """Metrics snapshot of the most recently constructed live server."""
    server = get_last_server()
    if server is None:
        raise RuntimeError("no StencilServer has been constructed")
    return server.stats()


__all__ = [
    "GroupItem",
    "QueueFull",
    "Registry",
    "ServeConfig",
    "ServerClosed",
    "StencilServer",
    "get_last_server",
    "stats",
]
