"""Which devices a job runs on: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

from typing import List, Optional

import torch


class NoDeviceError(RuntimeError):
    """A GPU run was asked for (the default) and there is no CUDA device."""


def resolve_device(platform: Optional[str] = None) -> torch.device:
    """``'cpu'`` -> the CPU; ``None`` or ``'gpu'`` -> the current CUDA
    device, raising :class:`NoDeviceError` when there is none (a GPU job
    never drops to the CPU on its own)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "gpu"):
        raise ValueError(f"unknown platform {platform!r}; expected cpu|gpu")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass --platform cpu to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_devices(platform: Optional[str] = None) -> List[torch.device]:
    """Every device a job may use, as ``jax.devices()`` gives them: the
    one CPU for ``'cpu'``; else every visible CUDA device, raising
    :class:`NoDeviceError` when there is none."""
    first = resolve_device(platform)
    if first.type == "cpu":
        return [first]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
