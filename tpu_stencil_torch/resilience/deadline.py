"""Deadlines and the dispatch watchdog.

The port's counterpart of the JAX package's ``resilience/deadline.py``:

* :func:`fence`: the watchdog spelling of a device drain. It synchronizes
  the CUDA devices of a tensor or tile grid on a daemon thread and waits
  at most ``timeout_s``; past it, it raises
  :class:`~.errors.DispatchTimeout` naming the fence point and counts
  ``resilience_dispatch_timeouts_total``. The hung work itself cannot be
  cancelled (the daemon thread is abandoned), but the caller gets control
  back, typed. The driver fences its warm-up and every chunk of the timed
  window with it. One drain thread serves every fence of the process
  until a drain hangs (then the next fence starts a new one), so its
  start and its first CUDA call are paid by the warm-up's fence and not
  inside the window.
* :class:`Deadline`: an absolute time budget with cheap ``expired()``
  checks at scheduling points.

``timeout_s=0`` disables the watchdog: the fence is then a plain drain,
no thread. ``TPU_STENCIL_TORCH_DISPATCH_TIMEOUT`` arms every fence that
was not given an explicit value.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

from tpu_stencil_torch.resilience.errors import DispatchTimeout

ENV_VAR = "TPU_STENCIL_TORCH_DISPATCH_TIMEOUT"


def default_timeout() -> float:
    """The env-configured watchdog window in seconds (0 = off)."""
    try:
        return max(0.0, float(os.environ.get(ENV_VAR, "0") or "0"))
    except ValueError:
        return 0.0


def resolve(cfg_timeout_s: Optional[float]) -> float:
    """A config field's effective window: the explicit value when set
    (> 0), else the env default, so ``--dispatch-timeout`` wins and an
    unset flag still honours the operator's env guard."""
    if cfg_timeout_s and cfg_timeout_s > 0:
        return float(cfg_timeout_s)
    return default_timeout()


def _drain(x):
    """Wait for the device work behind ``x``: its ``synchronize()`` when
    it has one (a CUDA event or stream, or a test's stub whose drain
    hangs), else one synchronize per CUDA device of its tensors."""
    sync = getattr(x, "synchronize", None)
    if sync is not None:
        sync()
        return x
    from tpu_stencil_torch.obs.tracing import fence as _fence

    return _fence(x)


class _Drainer:
    """The daemon thread that drains what :func:`fence` hands it, one
    request at a time, for as long as no drain hangs."""

    def __init__(self) -> None:
        self.requests: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._serve,
                         name="tpu-stencil-torch-fence", daemon=True).start()

    def _serve(self) -> None:
        while True:
            x, box, done = self.requests.get()
            try:
                box["value"] = _drain(x)
            except BaseException as e:  # surfaced to the caller
                box["error"] = e
            finally:
                done.set()


_drainer: Optional[_Drainer] = None
_drainer_lock = threading.Lock()


def fence(x, timeout_s: Optional[float] = None, label: str = "dispatch"):
    """Drain ``x`` under a watchdog: returns ``x`` when the device
    finishes within ``timeout_s`` seconds, raises
    :class:`DispatchTimeout` otherwise. ``timeout_s`` None means the env
    default; 0 disables the watchdog (a plain drain, no thread)."""
    global _drainer
    t = default_timeout() if timeout_s is None else timeout_s
    if not t or t <= 0:
        return _drain(x)
    with _drainer_lock:
        if _drainer is None:
            _drainer = _Drainer()
        drainer = _drainer
    done = threading.Event()
    box: dict = {}
    drainer.requests.put((x, box, done))
    if not done.wait(t):
        with _drainer_lock:
            if _drainer is drainer:
                _drainer = None  # stuck in the hung drain: abandoned
        from tpu_stencil_torch import obs

        obs.registry().counter("resilience_dispatch_timeouts_total").inc()
        raise DispatchTimeout(label, t)
    if "error" in box:
        raise box["error"]
    return box["value"]


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
