"""What the measuring tools share: the device, seeded inputs, timed runs."""

from __future__ import annotations

import statistics
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpu_stencil_torch.devices import NoDeviceError, resolve_device
from tpu_stencil_torch.runtime.autotune import _steady_state_per_rep
from tpu_stencil_torch.utils.timing import fence


def add_common_args(parser, default_reps: int) -> None:
    parser.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="cpu rehearses on the kernels' plain versions; default (or "
             "gpu) runs on the first CUDA device and fails without one")
    parser.add_argument(
        "--reps", type=int, default=default_reps, metavar="N",
        help="base rep count of the two-point differencing (t(2N) - t(N)) "
             f"/ N; default {default_reps}")
    parser.add_argument(
        "--rounds", type=int, default=3, metavar="R",
        help="passes over all candidates, interleaved; each candidate "
             "reports the median of its R readings (default 3)")


def parse_shape(text: str) -> Tuple[int, int]:
    h, sep, w = text.lower().partition("x")
    if not sep or not h.isdigit() or not w.isdigit():
        raise ValueError(f"shape must be HxW, got {text!r}")
    return int(h), int(w)


def device_for(platform: Optional[str], prog: str) -> Optional[torch.device]:
    """The device a tool runs on; without a card and without ``--platform
    cpu`` it prints why and returns None (the tool then exits 2): a tool
    never drops to the CPU on its own."""
    try:
        return resolve_device(platform)
    except NoDeviceError as e:
        print(f"{prog}: error: {e}", file=sys.stderr)
        return None


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"gpu ({torch.cuda.get_device_name(device)})"
    return "cpu (plain versions: a rehearsal, not a measurement)"


def seeded_image(shape, device: torch.device, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    return torch.from_numpy(img).to(device)


def timed(fn: Callable[[int], object], device: torch.device
          ) -> Callable[[int], float]:
    """``run(n) -> seconds`` of ``fn(n)``, fenced on ``device`` at both
    ends."""
    def run(n: int) -> float:
        fence(device)
        t0 = time.perf_counter()
        fn(n)
        fence(device)
        return time.perf_counter() - t0
    return run


def device_timed(fn: Callable[[int], object], device: torch.device
                 ) -> Callable[[int], float]:
    """``run(n) -> seconds`` of ``fn(n)`` on the card's clock: CUDA events
    around the ``n`` launches, issued behind a sleep kernel longer than
    the host takes to issue them, so that the card runs them back to back
    and never waits on the host (a launch shorter than its Python issue
    time would otherwise read as the issue time). On the CPU, the host
    clock (:func:`timed`)."""
    if device.type != "cuda":
        return timed(fn, device)
    issue = {}

    def run(n: int) -> float:
        if n not in issue:  # the host's issue time, measured once
            fence(device)
            t0 = time.perf_counter()
            fn(n)
            issue[n] = time.perf_counter() - t0
            fence(device)
        with torch.cuda.device(device):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int((2 * issue[n] + 2e-4) * SLEEP_CYCLES_PER_S))
            a.record()
            fn(n)
            b.record()
            b.synchronize()
        return a.elapsed_time(b) / 1e3
    return run


# Cycles of torch.cuda._sleep per second: above any card's clock, so that
# a sleep lasts at least as long as asked.
SLEEP_CYCLES_PER_S = 2.0e9


def interleaved_per_rep(runs: dict, rounds: int) -> dict:
    """Steady-state seconds per rep of every ``name -> (run(n), base
    reps)`` in ``runs``: ``rounds`` passes over all of them in turn (so
    that drift of the card's clocks falls on every candidate alike), the
    median of each candidate's readings."""
    readings = {name: [] for name in runs}
    for _ in range(max(1, rounds)):
        for name, (run, base) in runs.items():
            readings[name].append(_steady_state_per_rep(run, base))
    return {name: statistics.median(v) for name, v in readings.items()}
