"""The typed failure vocabulary of the resilience layer.

The port's counterpart of the JAX package's ``resilience/errors.py``:
every error a layer raises on purpose is a class here, so callers can
assert "failed typed" instead of matching messages. The classes of parts
not ported yet (fault injection, the dispatch watchdog, remote hosts) come
with those parts.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class of every typed failure the resilience layer raises."""


class DeadlineExceeded(ResilienceError):
    """A deadline expired before the work was served. Permanent by
    classification: retrying the same expired request can only expire
    again."""

