"""The federation front-router tier of the port (the JAX package's ``fed``).

One endpoint over many ``python -m tpu_stencil_torch net`` hosts, built so
that the loss of a *host* is survivable:

* :mod:`~tpu_stencil_torch.fed.membership` — health-checked membership:
  HTTP registration, heartbeat suspicion window
  (healthy → suspect → evicted, never a single-timeout eviction),
  draining hosts removed from routing before their requests fail.
* :mod:`~tpu_stencil_torch.fed.breaker` — per-host circuit breakers:
  consecutive transport failures open (typed ``HostUnavailable``),
  one half-open probe per cooldown closes.
* :mod:`~tpu_stencil_torch.fed.router` — least-outstanding placement,
  hedged requests (observed-p99 trigger, first-response-wins, typed
  cancellation), the federation verdict taxonomy, and federation-scope
  admission with per-tenant quotas and two priority classes
  (``X-Tenant``).
* :mod:`~tpu_stencil_torch.fed.http` — the stdlib threaded HTTP frontend
  (``POST /v1/blur`` with the net tier's wire contract,
  ``/admin/register``, ``/admin/drain``, ``/healthz``, ``/metrics``
  with member scrapes folded in, ``/statusz``).
* :mod:`~tpu_stencil_torch.fed.cli` — ``python -m tpu_stencil_torch fed``
  with the net CLI's SIGTERM drain discipline, per host.

The federation process never touches a device: the hop moves routing
metadata plus the one forwarded body per request. Its members run K1 on
the card.

>>> from tpu_stencil_torch.config import FedConfig
>>> from tpu_stencil_torch.fed import FedFrontend
>>> with FedFrontend(FedConfig(port=0, members=(m.url,))) as fe:
...     ...  # POST frames at fe.url
"""

from tpu_stencil_torch.config import FedConfig
from tpu_stencil_torch.fed.breaker import Breaker, BreakerBoard
from tpu_stencil_torch.fed.http import FedFrontend
from tpu_stencil_torch.fed.membership import Member, Membership, host_id_for
from tpu_stencil_torch.fed.router import FedRouter, TenantQuotaExceeded

__all__ = [
    "Breaker",
    "BreakerBoard",
    "FedConfig",
    "FedFrontend",
    "FedRouter",
    "Member",
    "Membership",
    "TenantQuotaExceeded",
    "host_id_for",
]
