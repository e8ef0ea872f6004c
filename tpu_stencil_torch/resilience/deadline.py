"""Deadlines.

The port's counterpart of ``Deadline`` in the JAX package's
``resilience/deadline.py``: an absolute time budget with cheap
``expired()`` checks at scheduling points. The dispatch watchdog
(``fence``) of that module is not ported yet.
"""

from __future__ import annotations

import time


class Deadline:
    """An absolute wall-clock budget. ``Deadline.after(s)`` starts one;
    ``remaining()``/``expired()`` are lock-free clock reads."""

    __slots__ = ("t_end",)

    def __init__(self, t_end: float) -> None:
        self.t_end = t_end

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.perf_counter() + seconds)

    def remaining(self) -> float:
        return self.t_end - time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() > self.t_end
