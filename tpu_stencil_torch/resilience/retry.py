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
  same way).

Unknown exceptions default to transient. Backoff is exponential with
decorrelating jitter so that clients that failed together do not retry
together. :data:`retries_total` counts the retries of this process.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import random
import time
from typing import Callable, Optional

from tpu_stencil_torch.resilience.errors import DeadlineExceeded

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
})

retries_total = 0


def classify(exc: BaseException) -> str:
    """``"transient"`` (retry may succeed) or ``"permanent"`` (it
    cannot). See the module docstring for the taxonomy."""
    if isinstance(exc, DeadlineExceeded):
        return PERMANENT  # an expired request can only expire again
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


def retry_call(
    fn: Callable,
    policy: Optional[RetryPolicy] = None,
    classify_fn: Callable[[BaseException], str] = classify,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn()`` under ``policy``: permanent failures raise
    immediately, transient ones back off and retry until the attempt
    budget runs out (the last error raises). ``on_retry(attempt, exc)``
    runs before each backoff; a hook that raises aborts the retry loop
    with its own error, which is how callers impose an overall deadline
    (:class:`~.deadline.Deadline`)."""
    global retries_total
    policy = policy or DEFAULT_POLICY
    attempts = max(1, policy.attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:
            if attempt + 1 >= attempts or classify_fn(e) != TRANSIENT:
                raise
            retries_total += 1
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(policy.delay(attempt))
    raise AssertionError("unreachable")  # the loop returns or raises

