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
torch ops, ``auto``/``autotune`` the kernels on a GPU and torch ops on the
CPU. As in the JAX package, periodic boundaries, ``direct_f32`` plans and
plans the kernels do not take run the torch-ops lowering, and the model
reports that (``xla``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from tpu_stencil_torch import filters as _filters
from tpu_stencil_torch.config import canonical_backend
from tpu_stencil_torch.devices import resolve_device
from tpu_stencil_torch.filters import Filter
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

    def resolved_config(
        self, shape: Tuple[int, int], channels: int
    ) -> Tuple[str, Optional[str]]:
        """The (backend, schedule) that runs for this shape: 'auto' and
        'autotune' resolve by device, and a kernel run the kernels cannot
        take resolves (and reports) 'xla'. ``shape`` is (H, W)."""
        backend = self.backend
        if backend in ("auto", "autotune"):
            backend = "pallas" if self.device.type == "cuda" else "xla"
        if backend == "pallas":
            if (self.boundary != "zero"
                    or not cuda_stencil.plan_supported(self.plan, channels)):
                return "xla", None
            return "pallas", cuda_stencil.effective_schedule(self.schedule)
        return backend, None

    def resolved_backend(self, shape: Tuple[int, int], channels: int) -> str:
        return self.resolved_config(shape, channels)[0]

    def resolved_geometry(
        self, shape: Tuple[int, int], channels: int
    ) -> Tuple[Optional[int], Optional[int]]:
        """The forced (block_h, fuse) the launch uses (None = defaults)."""
        return self.block_h, self.fuse

    def prepare(self, shape: Tuple[int, int], channels: int) -> None:
        """Build (or load) the kernels this shape will launch, so that no
        build lands in a timed window. Launches nothing."""
        if (self.device.type == "cuda"
                and self.resolved_backend(shape, channels) == "pallas"):
            cuda_stencil.build_kernels()

    def _place(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(device=self.device, dtype=torch.uint8)
        return torch.from_numpy(np.array(img, np.uint8)).to(self.device)

    def forward(self, img_u8, repetitions: int) -> torch.Tensor:
        """``repetitions`` stencil applications of an (H, W[, C]) uint8
        image (numpy or tensor; placed on the model's device). The input
        is never written."""
        x = self._place(img_u8)
        ch = x.shape[2] if x.dim() == 3 else 1
        backend, _ = self.resolved_config(tuple(x.shape[:2]), ch)
        if backend == "pallas":
            return cuda_stencil.iterate(
                x, int(repetitions), self.plan, block_h=self.block_h,
                fuse=self.fuse, schedule=self.schedule,
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
        x = self._place(imgs_u8)
        ch = x.shape[3] if x.dim() == 4 else 1
        backend, _ = self.batch_config(tuple(x.shape[1:3]), ch)
        if backend == "pallas":
            return cuda_stencil.iterate_frames(
                x, int(repetitions), self.plan, block_h=self.block_h,
                fuse=self.fuse, schedule=self.schedule,
            )
        return _lowering.iterate_frames(x, int(repetitions), self.plan,
                                        self.boundary)
