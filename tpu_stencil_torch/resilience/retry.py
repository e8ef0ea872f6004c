"""Shared retry policy: exponential backoff + jitter, one transient-vs-
permanent classifier.

The port's counterpart of the JAX package's ``resilience/retry.py``;
``runtime/bench_sweep.py`` runs every measurement under it.

* **transient** (worth a backoff + retry): allocator pressure (``out of
  memory``, ``RESOURCE_EXHAUSTED``: the next attempt may land after a
  neighbour frees device memory), transport drops (``UNAVAILABLE``,
  connection resets) and I/O errors without a permanent errno.
* **permanent** (retrying burns the backoff budget for nothing):
  capability guards (``NotImplementedError``), shape/validation errors
  (``ValueError``/``TypeError``), expired deadlines, missing files, and a
  kernel that did not build or launch (``KernelBuildError``,
  ``KernelLaunchError``: the same sources and the same arguments fail the
  same way), and a closed or draining server (``ServerClosed``,
  ``Draining``: it never reopens for this process).
* **backpressure** (``QueueFull``) is transient: re-offer later, and so
  is a federation's ``HostUnavailable`` (breakers half-open after their
  cooldown, heartbeats re-admit recovering hosts).
  :func:`reoffer_call` is the closed-loop re-offer shape the serving
  clients share, and a ``retry_after_s`` hint on an error is the floor of
  the next backoff.

Unknown exceptions default to transient. Backoff is exponential with
decorrelating jitter so that clients that failed together do not retry
together. :data:`retries_total` counts the retries of this process, as
does the driver registry's ``resilience_retries_total``.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import random
import time
from typing import Callable, Optional

from tpu_stencil_torch.resilience.errors import (
    DeadlineExceeded,
    HostUnavailable,
)

TRANSIENT = "transient"
PERMANENT = "permanent"

# Message tokens that mark a failure class regardless of exception type.
_TRANSIENT_TOKENS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
    "CANCELLED", "connection reset", "transfer", "temporarily",
    "out of memory",
)
_PERMANENT_TOKENS = (
    "INVALID_ARGUMENT", "UNIMPLEMENTED", "FAILED_PRECONDITION",
)
_PERMANENT_TYPES = (
    NotImplementedError, TypeError, AssertionError, AttributeError,
    KeyError, IndexError, ArithmeticError,
)
# OSError errnos that no retry can fix (the path/permission family);
# everything else (EIO, EAGAIN, EINTR, ...) is worth another attempt.
_PERMANENT_ERRNOS = frozenset(
    getattr(_errno, name) for name in
    ("ENOENT", "EACCES", "EPERM", "EISDIR", "ENOTDIR", "EEXIST", "EROFS")
    if hasattr(_errno, name)
)
# Classified by type NAME, so that this package imports none of the
# packages that raise them.
_PERMANENT_TYPE_NAMES = frozenset({
    "KernelBuildError", "KernelLaunchError", "NoDeviceError",
    "ServerClosed", "Draining",
})
# Backpressure: the serving engine's QueueFull (by name too, since the
# engine imports this module).
_TRANSIENT_TYPE_NAMES = frozenset({"QueueFull"})

retries_total = 0


def classify(exc: BaseException) -> str:
    """``"transient"`` (retry may succeed) or ``"permanent"`` (it
    cannot). See the module docstring for the taxonomy."""
    if isinstance(exc, DeadlineExceeded):
        return PERMANENT  # an expired request can only expire again
    if isinstance(exc, HostUnavailable):
        return TRANSIENT
    if type(exc).__name__ in _TRANSIENT_TYPE_NAMES:
        return TRANSIENT
    if type(exc).__name__ in _PERMANENT_TYPE_NAMES:
        return PERMANENT
    msg = str(exc)
    if any(tok in msg for tok in _PERMANENT_TOKENS):
        return PERMANENT
    if any(tok in msg for tok in _TRANSIENT_TOKENS):
        return TRANSIENT
    if isinstance(exc, OSError):
        return (
            PERMANENT if exc.errno in _PERMANENT_ERRNOS else TRANSIENT
        )
    if isinstance(exc, _PERMANENT_TYPES + (ValueError,)):
        return PERMANENT
    return TRANSIENT


def is_transient(exc: BaseException) -> bool:
    return classify(exc) == TRANSIENT


# Entropy-seeded: processes that failed together must not draw identical
# jitter.
_jitter_rng = random.Random()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter. ``attempts`` counts total tries
    (1 = no retry). Delay before retry k (0-based) is
    ``min(base_delay * multiplier**k, max_delay)`` scaled by a random
    factor in ``[1 - jitter, 1 + jitter]``."""

    attempts: int = 3
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.1

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        if self.jitter > 0.0:
            d *= 1.0 + self.jitter * (2.0 * _jitter_rng.random() - 1.0)
        return max(0.0, d)


DEFAULT_POLICY = RetryPolicy()

# The stream reader's and writer's transient-I/O shape: short backoff (a
# hiccup of a disk or a network file system, not an outage).
IO_POLICY = RetryPolicy(attempts=3, base_delay=0.05, multiplier=2.0,
                        max_delay=1.0)


def _hint_seconds(exc: BaseException) -> Optional[float]:
    """The ``retry_after_s`` hint an error carries (a server's
    Retry-After), or None when it has none or it does not parse."""
    hint = getattr(exc, "retry_after_s", None)
    try:
        return float(hint) if hint is not None else None
    except (TypeError, ValueError):
        return None


def retry_call(
    fn: Callable,
    policy: Optional[RetryPolicy] = None,
    classify_fn: Callable[[BaseException], str] = classify,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    label: str = "",
):
    """Call ``fn()`` under ``policy``: permanent failures raise
    immediately, transient ones back off and retry until the attempt
    budget runs out (the last error raises). ``on_retry(attempt, exc)``
    runs before each backoff; a hook that raises aborts the retry loop
    with its own error, which is how callers impose an overall deadline
    (:class:`~.deadline.Deadline`). An error's ``retry_after_s`` hint is
    the floor of its backoff (counted in
    ``resilience_retry_after_honored_total``); ``label`` names the loop
    in its ``resilience.retry`` spans."""
    global retries_total
    from tpu_stencil_torch import obs

    policy = policy or DEFAULT_POLICY
    attempts = max(1, policy.attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:
            if attempt + 1 >= attempts or classify_fn(e) != TRANSIENT:
                raise
            retries_total += 1
            obs.registry().counter("resilience_retries_total").inc()
            if on_retry is not None:
                on_retry(attempt, e)
            pause = policy.delay(attempt)
            hint = _hint_seconds(e)
            if hint is not None and hint > pause:
                pause = hint
                obs.registry().counter(
                    "resilience_retry_after_honored_total").inc()
            with obs.span("resilience.retry", "resilience", attempt=attempt,
                          label=label, error=type(e).__name__):
                time.sleep(pause)
    raise AssertionError("unreachable")  # the loop returns or raises


def reoffer_call(
    fn: Callable,
    policy: Optional[RetryPolicy] = None,
    give_up_after_s: Optional[float] = 300.0,
    base_delay: float = 0.001,
    max_delay: float = 0.05,
    label: str = "reoffer",
):
    """:func:`retry_call` under the closed-loop re-offer contract of the
    serving clients (``StencilServer.submit_retrying`` and
    ``loadgen.HttpTarget``): backpressure (``QueueFull``) backs off and
    re-offers with an effectively unbounded attempt budget, bounded by
    the wall-clock ``give_up_after_s``; past it the next re-offer raises
    ``TimeoutError('gave up re-offering ...')``, as it does at once when
    a server's Retry-After hint outlasts the budget left. Permanent
    errors raise immediately."""
    from tpu_stencil_torch.resilience.deadline import Deadline

    budget = Deadline.after(give_up_after_s) if give_up_after_s else None

    def on_retry(_attempt: int, exc: BaseException) -> None:
        if budget is None:
            return
        if budget.expired():
            raise TimeoutError(
                f"gave up re-offering after {give_up_after_s}s of "
                f"backpressure"
            ) from exc
        hint = _hint_seconds(exc)
        if hint is not None and hint > budget.remaining():
            raise TimeoutError(
                f"gave up re-offering: the server asked for "
                f"{hint:g}s of backoff but only "
                f"{max(0.0, budget.remaining()):.3g}s of the "
                f"{give_up_after_s}s budget remains"
            ) from exc

    return retry_call(
        fn,
        policy=policy or RetryPolicy(
            attempts=1_000_000, base_delay=base_delay, multiplier=1.0,
            max_delay=max_delay, jitter=0.5,
        ),
        on_retry=on_retry,
        label=label,
    )
