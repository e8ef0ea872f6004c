"""Witness sampling: which requests or frames get re-executed, and how.

The port's counterpart of the JAX package's ``integrity/witness.py``. The
sampler is the POLICY half of witness re-execution (the engines own the
EXECUTION half, they know their programs): a seeded, thread-safe
Bernoulli draw per request or frame at ``rate``. Seeded so a chaos run
replays: two samplers with the same seed pick the same indices in the
same order, and the draw sequence is the JAX package's (both draw from
Python's ``random.Random(seed)``).

:func:`device_witness` re-executes through a deliberately different
program: one torch-ops :func:`~tpu_stencil_torch.ops.lowering.padded_step`
per rep on an explicit device, launching none of the hand-written kernels
(K1, K2, K3) whose output it checks. :func:`golden_witness` is the NumPy
golden comparator, which shares no code with any device path: the referee
when the question is "is this device lying", at probe-sized frames.
"""

from __future__ import annotations

import random
import threading
from typing import Optional, Union

import numpy as np
import torch

#: The network tier's default sampling rate: ~4 witnesses per 1024
#: requests — cheap enough to leave on, frequent enough that a replica
#: corrupting every result trips quarantine within ~K/rate requests.
DEFAULT_RATE = 1.0 / 256.0

#: Requests/frames above this rep count are never witnessed: the witness
#: runs one torch-ops step per rep (that is what makes it a different
#: program), so its cost is linear in reps while the served program's
#: device-memory traffic is amortized by the fused and resident kernels;
#: past this bound a witness would cost more than the request it checks.
WITNESS_MAX_REPS = 512


class WitnessSampler:
    """Seeded Bernoulli sampler: ``pick()`` per request/frame."""

    def __init__(self, rate: float, seed: int = 0) -> None:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"witness rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def pick(self) -> bool:
        """Whether THIS request/frame is witnessed. Thread-safe; each call
        at a rate strictly inside (0, 1) consumes exactly one draw, so the
        picked index sequence is a pure function of (seed, call order)."""
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < self.rate


def device_witness(img: Union[np.ndarray, torch.Tensor], filter_name: str,
                   reps: int, boundary: str = "zero",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> np.ndarray:
    """Re-execute ``reps`` reps of ``filter_name`` on ``img`` (H, W[, C])
    uint8 through torch ops, one :func:`lowering.padded_step` per rep on
    ``device`` (None: the card, as :func:`devices.resolve_device` gives
    it, raising when there is none). No hand-written kernel is launched,
    so the bytes agree with a kernel's only if both are right. O(reps)
    launches: callers gate on :data:`WITNESS_MAX_REPS`."""
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.devices import resolve_device
    from tpu_stencil_torch.ops import lowering

    dev = resolve_device() if device is None else torch.device(device)
    plan = lowering.plan_filter(filters.get_filter(filter_name))
    if isinstance(img, torch.Tensor):
        x = img.to(device=dev, dtype=torch.uint8)
    else:
        x = torch.from_numpy(np.array(img, np.uint8)).to(dev)
    for _ in range(int(reps)):
        x = lowering.padded_step(x, plan, boundary)
    return x.cpu().numpy()


def golden_witness(img: np.ndarray, filter_name: str, reps: int,
                   got: np.ndarray, boundary: str = "zero") -> bool:
    """True when ``got`` equals the independent NumPy golden of ``reps``
    filter applications on ``img``: the referee that shares no code with
    any device path. O(H*W*reps) Python loops: probe-sized frames only."""
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import stencil

    want = stencil.reference_stencil_numpy(
        np.asarray(img), filters.get_filter(filter_name), reps,
        boundary=boundary)
    return bool(np.array_equal(np.asarray(got), want))
