"""The flagship model: N iterated applications of a (k x k) stencil.

The port's counterpart of the JAX package's ``models/blur.py`` and of the
reference's double-buffered repetition loops (the MPI src/dst swap,
``mpi/mpi_convolution.c:156-240``, and the CUDA device-pointer swap,
``cuda/cuda_convolution.cu:66-87``). On the kernel path two uint8 device
buffers ping-pong across reps with no host round trip, and the rep count is
a runtime int: nothing is compiled per rep count.

The model has no learned weights: its parameters are the filter and its
:class:`~tpu_stencil_torch.ops.lowering.StencilPlan`.

Backends (the JAX package's names; ``cuda`` and ``torch`` are aliases):
``pallas`` runs the hand-written kernels (their plain versions for CPU
tensors), ``xla`` the torch-ops lowering, ``reference`` the f32 plan in
torch ops. ``auto`` and ``autotune`` resolve through
:func:`tpu_stencil_torch.runtime.autotune.best_full_config`: on a GPU the
backend, schedule and kernel geometry are measured once per (card, filter,
shape), cached on disk and memoized in the model, and the launch runs the
verdict unless ``schedule``/``block_h``/``fuse`` force it; on the CPU the
answer is torch ops, without a measurement. As in the JAX package,
periodic boundaries, ``direct_f32`` plans and plans the kernels do not take
run the torch-ops lowering, and the model reports that (``xla``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from tpu_stencil_torch import filters as _filters
from tpu_stencil_torch.config import canonical_backend
from tpu_stencil_torch.devices import resolve_device
from tpu_stencil_torch.filters import Filter
from tpu_stencil_torch.obs import tracing as _tracing
from tpu_stencil_torch.ops import cuda_stencil
from tpu_stencil_torch.ops import lowering as _lowering


class IteratedConv2D(torch.nn.Module):
    """Iterated stencil model: a filter plus an iteration schedule.

    >>> model = IteratedConv2D("gaussian", device="cpu")
    >>> out = model(img_u8, repetitions=40)
    """

    def __init__(
        self,
        filt: Union[str, Filter, np.ndarray] = "gaussian",
        backend: str = "auto",
        boundary: str = "zero",
        schedule: Optional[str] = None,
        block_h: Optional[int] = None,
        fuse: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        if isinstance(filt, str):
            filt = _filters.get_filter(filt)
        if boundary not in ("zero", "periodic"):
            raise ValueError(f"unknown boundary {boundary!r}")
        self.filter = _filters.as_filter(
            filt if isinstance(filt, Filter) else np.asarray(filt)
        )
        self.backend = canonical_backend(backend)
        if self.backend not in ("auto", "autotune", "xla", "pallas",
                                "reference"):
            raise ValueError(f"unknown backend {backend!r}")
        self.boundary = boundary
        self.schedule = cuda_stencil.check_schedule(schedule)
        if block_h is not None and block_h < 1:
            raise ValueError(f"block_h must be >= 1, got {block_h}")
        if fuse is not None and fuse < 1:
            raise ValueError(f"fuse must be >= 1, got {fuse}")
        self.block_h = block_h  # forced kernel geometry (None = defaults)
        self.fuse = fuse
        self.device = (resolve_device() if device is None
                       else torch.device(device))
        self.plan = _lowering.plan_filter(self.filter)
        if self.backend == "reference":
            self.plan = _lowering.force_f32_plan(self.plan)
        # (shape, channels) -> the autotuner's (backend, schedule, block_h,
        # fuse): a job never pays the measurement twice, even where the
        # disk cache cannot be written.
        self._resolved: dict = {}

    def _tuned(self, shape: Tuple[int, int], channels: int):
        key = (tuple(shape), channels)
        if key not in self._resolved:
            from tpu_stencil_torch.runtime import autotune

            self._resolved[key] = autotune.best_full_config(
                self.plan, tuple(shape), channels,
                force_schedule=self.schedule,
                block_h=self.block_h, fuse=self.fuse, device=self.device,
            )
        return self._resolved[key]

    def resolved_config(
        self, shape: Tuple[int, int], channels: int
    ) -> Tuple[str, Optional[str]]:
        """The (backend, schedule) that runs for this shape: 'auto' and
        'autotune' consult the autotuner (measuring once per shape on a
        card, memoized here); a kernel run the kernels cannot take
        resolves (and reports) 'xla'. A constructor-forced ``schedule``
        overrides the tuned one whenever the kernels run. ``shape`` is
        (H, W)."""
        if self.boundary != "zero":
            # The kernels are zero-boundary only: never measure or name a
            # backend that cannot run these semantics.
            return ("xla" if self.backend in ("auto", "autotune", "pallas")
                    else self.backend), None
        if self.backend in ("auto", "autotune"):
            backend, schedule = self._tuned(shape, channels)[:2]
            if backend == "pallas" and self.schedule is not None:
                schedule = self.schedule
        else:
            backend, schedule = self.backend, self.schedule
        if backend == "pallas":
            if not cuda_stencil.plan_supported(self.plan, channels):
                return "xla", None
            return "pallas", cuda_stencil.effective_schedule(schedule)
        return backend, None

    def resolved_backend(self, shape: Tuple[int, int], channels: int) -> str:
        return self.resolved_config(shape, channels)[0]

    def resolved_geometry(
        self, shape: Tuple[int, int], channels: int
    ) -> Tuple[Optional[int], Optional[int]]:
        """The (block_h, fuse) the launch uses: constructor-forced values
        win; otherwise the autotuned verdict for this shape (None = the
        kernels' defaults). Shares :meth:`resolved_config`'s memo and
        never re-measures."""
        if self.block_h is not None or self.fuse is not None:
            return self.block_h, self.fuse
        hit = self._resolved.get((tuple(shape), channels))
        if hit is not None:
            return hit[2], hit[3]
        return None, None

    def prepare(self, shape: Tuple[int, int], channels: int) -> None:
        """Resolve the configuration for this shape ('auto'/'autotune'
        measure here, on a cold cache) and build (or load) the kernels it
        will launch, so that neither a measurement nor a build lands in a
        timed window. Launches nothing of the job."""
        if (self.device.type == "cuda" and self.boundary == "zero"
                and self.backend in ("auto", "autotune", "pallas")
                and cuda_stencil.plan_supported(self.plan, channels)):
            # Built before any measurement: a probe times launches, not nvcc.
            cuda_stencil.build_kernels()
        self.resolved_config(shape, channels)

    def _loop_kernel(self, shape: Tuple[int, int], channels: int,
                     n_frames: Optional[int]):
        """(kernel, rows, wc, block_h, fuse) of the rep loop's flat launch
        for ``shape`` (``n_frames``: the frames' tall layout), as
        :func:`cuda_stencil.rep_loop_kernel` chooses it; None off the
        kernels."""
        backend, schedule = self.resolved_config(shape, channels)
        if backend != "pallas":
            return None
        rows = (shape[0] if n_frames is None
                else cuda_stencil.frames_rows(self.plan, shape[0], n_frames))
        wc = shape[1] * channels
        bh, fz = self.resolved_geometry(shape, channels)
        kernel, bh, fz = cuda_stencil.rep_loop_kernel(
            self.plan, rows, wc, channels, bh, fz, schedule, self.device)
        return kernel, rows, wc, bh, fz

    def warm_reps(self, shape: Tuple[int, int], channels: int,
                  calls: Iterable[int],
                  n_frames: Optional[int] = None) -> List[int]:
        """Rep counts, one call of the model each, that between them
        launch every kernel instance the calls ``calls`` (the rep count of
        each call a timed window makes) launch on ``shape``
        (:func:`cuda_stencil.warm_depths`). The driver's warm-up runs
        them on a scratch copy before the window."""
        loop = self._loop_kernel(shape, channels, n_frames)
        return cuda_stencil.warm_depths(
            calls, None if loop is None else loop[4])

    def describe_launches(self, shape: Tuple[int, int], channels: int,
                          depths: Iterable[int],
                          n_frames: Optional[int] = None) -> List[dict]:
        """The kernel instances calls of ``depths`` reps launch on
        ``shape`` (:func:`cuda_stencil.describe_launch`); empty off the
        kernels."""
        loop = self._loop_kernel(shape, channels, n_frames)
        if loop is None:
            return []
        kernel, rows, wc, bh, _ = loop
        return [cuda_stencil.describe_launch(
            kernel, self.plan, rows, wc, channels, bh, d, self.device)
            for d in depths]

    def _place(self, img) -> torch.Tensor:
        """``img`` on the model's device, waited for: a profiler-only
        ``model.place`` span (arg ``bytes``) while a profiler collects."""
        if not _tracing.profiling():
            return self._placed(img)
        with _tracing.span("model.place", "model", profiler_only=True) as s:
            x = self._placed(img)
            if s.recording:
                s.args["bytes"] = x.nbytes
            return x

    def _placed(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(device=self.device, dtype=torch.uint8)
        return torch.from_numpy(np.array(img, np.uint8)).to(self.device)

    def _issue(self, run, x: torch.Tensor, repetitions: int) -> torch.Tensor:
        """``run(x, repetitions)`` inside a profiler-only ``model.issue``
        span while a profiler collects: args ``reps``, ``launches`` (the
        call's delta of :func:`cuda_stencil.launch_counts`, the process's
        counters) and ``kernel`` (the kernels launched, else the
        backend)."""
        if not _tracing.profiling():
            return run(x, repetitions)
        with _tracing.span("model.issue", "model", profiler_only=True) as s:
            if not s.recording:  # the profiler stopped in between
                return run(x, repetitions)
            before = cuda_stencil.launch_counts()
            out = run(x, repetitions)
            moved = {k: n - before[k]
                     for k, n in cuda_stencil.launch_counts().items()
                     if n != before[k]}
            s.args.update(kernel="+".join(moved) or self.backend,
                          reps=int(repetitions),
                          launches=sum(moved.values()))
            return out

    def forward(self, img_u8, repetitions: int) -> torch.Tensor:
        """``repetitions`` stencil applications of an (H, W[, C]) uint8
        image (numpy or tensor; placed on the model's device). The input
        is never written."""
        return self.run_on(self._place(img_u8), repetitions)

    def run_on(self, x: torch.Tensor, repetitions: int) -> torch.Tensor:
        """:meth:`forward` on the device ``x`` (a uint8 tensor) lies on,
        which need not be the model's: the stream's fan-out and the
        batch-axis ``--frames`` run one model on several devices. The
        configuration resolves on the model's device (the devices of one
        job are alike)."""
        return self._issue(self._run, x, repetitions)

    def _run(self, x: torch.Tensor, repetitions: int) -> torch.Tensor:
        ch = x.shape[2] if x.dim() == 3 else 1
        shape2 = tuple(x.shape[:2])
        backend, schedule = self.resolved_config(shape2, ch)
        if backend == "pallas":
            bh, fz = self.resolved_geometry(shape2, ch)
            return cuda_stencil.iterate(
                x, int(repetitions), self.plan, block_h=bh, fuse=fz,
                schedule=schedule,
            )
        return _lowering.iterate(x, int(repetitions), self.plan,
                                 self.boundary)

    def batch_config(
        self, frame_shape: Tuple[int, int], channels: int,
    ) -> Tuple[str, Optional[str]]:
        """The (backend, schedule) the batch path runs: the kernel path
        runs the frames as one tall image (:func:`cuda_stencil.
        iterate_frames`)."""
        return self.resolved_config(frame_shape, channels)

    def batch(self, imgs_u8, repetitions: int) -> torch.Tensor:
        """Batched video/burst mode: (N, H, W[, C]) frames, never mixed."""
        return self.batch_on(self._place(imgs_u8), repetitions)

    def batch_on(self, x: torch.Tensor, repetitions: int) -> torch.Tensor:
        """:meth:`batch` on the device ``x`` lies on (see :meth:`run_on`)."""
        return self._issue(self._batch, x, repetitions)

    def _batch(self, x: torch.Tensor, repetitions: int) -> torch.Tensor:
        ch = x.shape[3] if x.dim() == 4 else 1
        frame_shape = tuple(x.shape[1:3])
        backend, schedule = self.batch_config(frame_shape, ch)
        if backend == "pallas":
            bh, fz = self.resolved_geometry(frame_shape, ch)
            return cuda_stencil.iterate_frames(
                x, int(repetitions), self.plan, block_h=bh, fuse=fz,
                schedule=schedule,
            )
        return _lowering.iterate_frames(x, int(repetitions), self.plan,
                                        self.boundary)
