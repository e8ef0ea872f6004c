"""The traced run: host spans of the benchmark's own, a ``torch.profiler``
capture of the window, and what the device did in it.

Spans are ``record_function`` ranges named ``bench.<name>`` around the
benchmark's calls into the program, so they share the profiler's clock
with the device's operations. With tracing off, :meth:`Tracer.span` costs
one branch and nothing is captured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

PREFIX = "bench."
WINDOW = PREFIX + "window"
STENCIL_KERNEL = re.compile(r"\bstencil_\w+")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    device: int
    start_ns: int
    end_ns: int

    @property
    def kind(self) -> str:
        """'h2d', 'd2h', 'p2p', 'copy' (another memcpy), 'memset' or
        'kernel'."""
        if self.name.startswith("Memcpy"):
            for tag, kind in (("HtoD", "h2d"), ("DtoH", "d2h"),
                              ("PtoP", "p2p")):
                if tag in self.name:
                    return kind
            return "copy"
        if self.name.startswith("Memset"):
            return "memset"
        return "kernel"

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass(frozen=True)
class HostSpan:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Capture:
    """What one traced window holds: its bounds, the device's operations
    inside them (clipped), and the benchmark's host spans."""

    start_ns: int
    end_ns: int
    ops: List[DeviceOp]
    spans: List[HostSpan]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def devices(self) -> List[int]:
        return sorted({op.device for op in self.ops})

    def busy_intervals(self, device: int) -> List[Tuple[int, int]]:
        """The union of the device's operation intervals, merged."""
        iv = sorted((op.start_ns, op.end_ns) for op in self.ops
                    if op.device == device)
        merged: List[List[int]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, device: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(device)) / 1e9

    def mean_busy_s(self, n_devices: int) -> float:
        """Busy seconds averaged over ``n_devices`` cards (a card with no
        operation counts as idle)."""
        return sum(self.busy_s(d) for d in self.devices()) / n_devices

    def seconds(self, kind: str, pattern: Optional[re.Pattern] = None
                ) -> float:
        """Summed device seconds of the operations of ``kind`` (and whose
        name matches ``pattern``), over every card."""
        return sum(op.seconds for op in self.ops if op.kind == kind
                   and (pattern is None or pattern.search(op.name)))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.seconds
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _label(self, t_ns: int) -> str:
        """The innermost benchmark span open at ``t_ns``."""
        best = None
        for sp in self.spans:
            if sp.name != WINDOW and sp.start_ns <= t_ns <= sp.end_ns:
                if best is None or sp.start_ns > best.start_ns:
                    best = sp
        return best.name[len(PREFIX):] if best else "outside_spans"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle gaps of any card in the window, each named by
        what the benchmark's host was doing in its middle."""
        gaps = []
        for d in self.devices():
            t = self.start_ns
            for s, e in self.busy_intervals(d) + [(self.end_ns,
                                                   self.end_ns)]:
                if s > t:
                    gaps.append((s - t, t + (s - t) // 2))
                t = max(t, e)
        gaps.sort(reverse=True)
        return [[self._label(mid), dur / 1e9] for dur, mid in gaps[:n]]


class Tracer:
    """Host spans and the profiler around a run's window."""

    def __init__(self, enabled: bool, cuda: bool) -> None:
        self.enabled = enabled
        self.cuda = cuda
        self._prof = None
        self._window = None
        self.capture: Optional[Capture] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + name)

    @contextlib.contextmanager
    def window(self):
        """Around the measured window: the profiler runs inside it only."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        try:
            with record_function(WINDOW):
                yield
        finally:
            self._prof.stop()

    def collect(self) -> Optional[Capture]:
        """Read the capture once the window has closed (None untraced)."""
        if self._prof is None:
            return None
        import torch

        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        cuda_type = torch.autograd.DeviceType.CUDA
        spans, raw_ops = [], []
        for e in events:
            name = e.name()
            if e.device_type() == cuda_type:
                if e.is_user_annotation() or name.startswith(PREFIX):
                    continue  # the device's mirror of a host span
                raw_ops.append((name, int(e.device_index()),
                                int(e.start_ns()), int(e.end_ns())))
            elif name.startswith(PREFIX):
                spans.append(HostSpan(name, int(e.start_ns()),
                                      int(e.end_ns())))
        window = [s for s in spans if s.name == WINDOW]
        if not window:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = window[0].start_ns, window[0].end_ns
        ops = [DeviceOp(n, d, max(s, w0), min(e, w1))
               for n, d, s, e in raw_ops if e > w0 and s < w1]
        self.capture = Capture(w0, w1, ops, spans)
        return self.capture
