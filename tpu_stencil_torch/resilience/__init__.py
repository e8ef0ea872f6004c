"""Typed failures, fault injection, retry, deadlines and degradation.

The port's counterpart of the JAX package's ``resilience`` package:
:mod:`errors` (the typed vocabulary), :mod:`faults` (named injection
points armed by ``TPU_STENCIL_TORCH_FAULTS`` / ``--faults``), :mod:`retry`
(backoff and the transient/permanent classifier), :mod:`deadline`
(``Deadline`` and the dispatch watchdog ``fence``) and :mod:`fallback`
(the ladder ``pallas[deep] -> pallas -> xla (-> xla@cpu)``). Every
firing, demotion and timeout is counted in the driver registry under the
JAX package's ``resilience_*`` names.
"""

from tpu_stencil_torch.resilience.errors import (
    CollectiveTimeout,
    DeadlineExceeded,
    DispatchTimeout,
    FatalInjectedFault,
    HostUnavailable,
    InjectedFault,
    InjectedOOM,
    ResilienceError,
    WorkerCrashed,
)

__all__ = [
    "CollectiveTimeout",
    "DeadlineExceeded",
    "DispatchTimeout",
    "FatalInjectedFault",
    "HostUnavailable",
    "InjectedFault",
    "InjectedOOM",
    "ResilienceError",
    "WorkerCrashed",
]
