"""Timing with the reference's headline-metric semantics.

The reference's MPI metric is: barrier, ``MPI_Wtime`` around the
compute/comm loop only (file I/O excluded), then max across ranks
(``mpi/mpi_convolution.c:151-155,242,264-275``). Here the driver opens
each window after a barrier of the processes (:func:`tpu_stencil_torch.
parallel.distributed.barrier`, a no-op with one), a
``torch.cuda.synchronize()`` on every local device of the job fences both
ends of the window (PyTorch returns before the card finishes, so an
unfenced host clock measures the enqueue), a monotonic clock times it,
and :func:`max_across_processes` takes the max over the ranks.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import torch

Devices = Union[None, str, torch.device, Sequence]


def fence(devices: Devices) -> None:
    """Wait until ``devices`` (one device or a sequence, e.g. every
    device of a mesh) have finished all queued work: one synchronize per
    distinct CUDA device (no-op on the CPU, where torch ops run
    synchronously)."""
    if devices is None:
        return
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class Timer:
    """Monotonic stopwatch; ``elapsed`` in seconds.

    ``device``: a device, or a sequence of them (a mesh), fenced on
    entry and on exit, so the window covers exactly the device work
    queued inside it. A block that raises is not fenced on exit: the
    device may be the reason it raised (a watchdog timeout), and a
    synchronize would hang on it.

    ``elapsed`` is live: read inside the ``with`` block it returns the time
    accumulated so far; after exit it is frozen at the block's duration.
    Read before the context is ever entered it raises :class:`RuntimeError`
    (an un-entered timer has no elapsed time). ``label`` names what is
    timed and appears in that error.
    """

    def __init__(self, label: Optional[str] = None,
                 device: Devices = None) -> None:
        self.label = label
        self.device = device
        self._start: Optional[float] = None
        self._frozen: float = -1.0

    def __enter__(self) -> "Timer":
        fence(self.device)
        self._start = time.perf_counter()
        self._frozen = -1.0  # re-entry restarts the stopwatch
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            fence(self.device)
        self._frozen = time.perf_counter() - self._start

    @property
    def elapsed(self) -> float:
        if self._frozen >= 0.0:
            return self._frozen
        if self._start is not None:
            return time.perf_counter() - self._start
        what = f"Timer({self.label!r})" if self.label else "Timer"
        raise RuntimeError(
            f"{what}.elapsed read before the context was entered; "
            "use 'with Timer() as t: ...' and read t.elapsed inside or after"
        )


def max_across_processes(seconds: float) -> float:
    """Max-reduce a host-side scalar across processes — the reference's
    Send/Recv max at ``mpi/mpi_convolution.c:264-275``: an ``all_reduce``
    (MAX) of a CPU float64 tensor, which every process joins. The
    identity with one process."""
    from tpu_stencil_torch.parallel import distributed

    if distributed.process_count() == 1:
        return seconds
    import torch.distributed as dist

    t = torch.tensor([float(seconds)], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())
