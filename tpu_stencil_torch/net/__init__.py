"""The network serving tier of the port (the JAX package's ``net``):

* :mod:`~tpu_stencil_torch.net.fleet`: one
  :class:`~tpu_stencil_torch.serve.engine.StencilServer` per device (or per
  entry of an explicit device list), with shared program-cache warming,
  concurrent drain and rolling single-replica restart.
* :mod:`~tpu_stencil_torch.net.router`: least-outstanding placement, the
  admission layers (drain gate, in-flight-bytes shed, per-replica
  backpressure), continuous batching and quarantine.
* :mod:`~tpu_stencil_torch.net.http`: the stdlib threaded HTTP frontend
  (``POST /v1/blur``, ``/healthz``, ``/metrics``, ``/statusz``, the admin
  and debug endpoints) and :class:`~tpu_stencil_torch.net.http.
  NetFrontend`, the whole tier's lifecycle object.
* :mod:`~tpu_stencil_torch.net.arena`: the ingest staging buffers.
* :mod:`~tpu_stencil_torch.net.cli`: ``python -m tpu_stencil_torch net``
  with the SIGTERM drain.

Every replica serves on the bucket route, so on a card each request's
reps are single-rep K1 launches.

>>> from tpu_stencil_torch.config import NetConfig
>>> from tpu_stencil_torch.net import NetFrontend
>>> with NetFrontend(NetConfig(port=0)) as fe:     # every visible card
...     ...  # POST frames at fe.url
"""

from tpu_stencil_torch.config import NetConfig
from tpu_stencil_torch.net.fleet import ReplicaFleet
from tpu_stencil_torch.net.http import NetFrontend
from tpu_stencil_torch.net.router import Draining, Overloaded, Router

__all__ = [
    "Draining",
    "NetConfig",
    "NetFrontend",
    "Overloaded",
    "ReplicaFleet",
    "Router",
]
