"""Shared roofline model of the port: one traffic model and one operations
bound for every tool that reports a share of the card.

The port's counterpart of the job-path half of the JAX package's
``runtime/roofline.py``: :func:`effective_fuse`,
:func:`analytic_bytes_per_rep`, :func:`achieved`, :func:`achieved_frames`,
:func:`device_hbm_bytes` and :func:`hbm_frame_feasible`, over the port's
own geometry helpers (:mod:`tpu_stencil_torch.ops.cuda_stencil`). On this
card the stencil is bound by integer operations, not by bytes (one
gaussian rep is 5 int32 operations per element against 2 bytes per element
per ``fuse`` reps), so beside the traffic model stand the operations
bound :func:`plan_ops` and :func:`bound_ms_per_rep`, which the on-card
smoke test, the kernel lab, the benchmark sweep and the autotuner's
reports all read.

The peak rates are those of one H100 SXM from NVIDIA's data sheet (dense,
at the full 700 W power limit). The interconnect, host-link, streaming,
mesh and pipeline models of the JAX module are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

# One H100 SXM (NVIDIA's data sheet): 80 GB of HBM3 at 3.35 TB/s; float32
# 67 TFLOP/s outside the tensor cores, i.e. 128 FP32 lanes per SM x 132 SMs
# x 1.98 GHz x 2 (an FMA counts two). Hopper has 64 INT32 lanes per SM, so
# one int32 op (add, multiply-add, shift, compare) per lane per clock is
# 67e12 / 4; a float32 op that is not an FMA is 67e12 / 2.
H100_HBM_BYTES_PER_S = 3.35e12
H100_HBM_GBPS = H100_HBM_BYTES_PER_S / 1e9
H100_HBM_BYTES = 80 * 10 ** 9
H100_F32_FLOPS = 67e12
H100_INT32_OPS_PER_S = H100_F32_FLOPS / 4
H100_F32_OPS_PER_S = H100_F32_FLOPS / 2

ENV_DEVICE_HBM_BYTES = "TPU_STENCIL_TORCH_DEVICE_HBM_BYTES"


def _plan(filter_name: str):
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import lowering

    return lowering.plan_filter(filters.get_filter(filter_name))


def effective_fuse(filter_name: str, h_img: int,
                   block_h=None, fuse=None, schedule=None,
                   w_img=None, channels: int = 1, reps=None,
                   n_frames: int = 1, device=None) -> int:
    """Reps per trip through device memory that
    :func:`tpu_stencil_torch.ops.cuda_stencil.iterate` achieves for this
    (filter, image height): device-memory traffic per rep is divided by
    it. Mirrors the launch: K1's clamped fuse (``block_h``/``fuse``: a
    forced or tuned geometry; None = module defaults); under
    ``schedule='deep'`` the full ``reps`` count when the resident kernel
    runs (``w_img``/``channels`` feed its L2 feasibility check; without a
    width it is taken as infeasible), else K1's deep depth. ``n_frames``
    > 1 models the tall-image batch launch."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    plan = _plan(filter_name)
    if not cs.plan_supported(plan, channels):
        return 1
    rows = cs.frames_rows(plan, h_img, n_frames) if n_frames > 1 else h_img
    sched = cs.check_schedule(schedule)
    if (sched == cs.DEEP and w_img and block_h is None and fuse is None
            and cs.resident_feasible(plan, rows, w_img * channels, channels,
                                     device)):
        return max(1, int(reps)) if reps else 1
    return cs.effective_geometry(plan, rows, channels, block_h, fuse,
                                 schedule=sched)[1]


def analytic_bytes_per_rep(frame_bytes: int, backend: str,
                           filter_name: str, h_img: int,
                           block_h=None, fuse=None, schedule=None,
                           w_img=None, channels: int = 1,
                           reps=None, n_frames: int = 1,
                           device=None) -> float:
    """The traffic model's device-memory bytes per repetition: a torch-ops
    step (``xla``) reads and writes the frame every rep; the kernels
    (``pallas``) pay device memory once per :func:`effective_fuse` reps
    (ghost-band recompute is operations, not traffic)."""
    eff = (
        effective_fuse(filter_name, h_img, block_h, fuse,
                       schedule=schedule, w_img=w_img, channels=channels,
                       reps=reps, n_frames=n_frames, device=device)
        if backend == "pallas" else 1
    )
    return 2.0 * frame_bytes / eff


def achieved(frame_bytes: int, per_rep_s: float, backend: str,
             filter_name: str, h_img: int,
             block_h=None, fuse=None, schedule=None,
             w_img=None, channels: int = 1, reps=None,
             device=None) -> Tuple[float, float]:
    """(device-memory GB/s, % of the H100's 3.35 TB/s) for one measured
    per-rep time, at the geometry and schedule that ran."""
    gbps = analytic_bytes_per_rep(
        frame_bytes, backend, filter_name, h_img, block_h, fuse,
        schedule=schedule, w_img=w_img, channels=channels, reps=reps,
        device=device,
    ) / per_rep_s / 1e9
    return gbps, 100 * gbps / H100_HBM_GBPS


def achieved_frames(frame_bytes: int, n_frames: int, per_rep_s: float,
                    backend: str, filter_name: str, h_img: int,
                    block_h=None, fuse=None) -> Tuple[float, float]:
    """:func:`achieved` for a batched launch of ``n_frames`` independent
    frames per rep: traffic is ``n_frames`` times one frame's."""
    return achieved(frame_bytes * n_frames, per_rep_s, backend,
                    filter_name, h_img, block_h, fuse)


def device_hbm_bytes() -> int:
    """The per-device memory budget: ``TPU_STENCIL_TORCH_DEVICE_HBM_BYTES``
    when set, else the H100's 80 GB."""
    return int(os.environ.get(ENV_DEVICE_HBM_BYTES, H100_HBM_BYTES))


def hbm_frame_feasible(frame_bytes: int, pipeline_depth: int = 2,
                       hbm_bytes: Optional[int] = None) -> bool:
    """Whether one device can hold a streaming working set for this frame
    size: ``pipeline_depth`` frames in flight plus one of staging,
    ``(depth + 1) * frame_bytes`` against :func:`device_hbm_bytes`."""
    budget = hbm_bytes if hbm_bytes is not None else device_hbm_bytes()
    return (pipeline_depth + 1) * frame_bytes <= budget


# ---------------------------------------------------------------------------
# The operations bound
# ---------------------------------------------------------------------------


def plan_ops(plan) -> Tuple[int, int]:
    """(int32 ops, float32 ops) per flat element per rep the plan needs at
    the least: a sum of n nonzero taps is n - 1 adds, a tap multiply and
    its add being one multiply-add (IMAD), plus one multiply where no tap
    is 1 to start the sum from; then the finish (shift and any clip, or
    convert/divide/clip/convert). Gaussian 3x3: 2 + 2 + 1 = 5."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    def taps_ops(taps):
        nz = [t for t in taps if t]
        return max(0, len(nz) - 1) + (0 if not nz or 1 in nz else 1)

    if plan.kind == "sep_int":
        iops = taps_ops(plan.row_taps) + taps_ops(plan.col_taps)
    else:
        iops = taps_ops([int(t) for row in plan.taps for t in row])
    if plan.shift is not None:
        return iops + 1 + (2 if cs.clip_needed(plan) else 0), 0
    return iops, 5


def bound_ms_per_rep(plan, n_elems: int, reps: int,
                     n_bytes: Optional[int] = None) -> Tuple[float, str]:
    """The least time per rep the card could take: the larger of the bytes
    the call must move (input read once, output written once: ``n_bytes``,
    default 2 bytes per element) over the device-memory rate, spread over
    the call's ``reps``, and the ops ``n_elems`` output elements need over
    the int32/float32 rates. Returns (ms, 'bytes'|'operations')."""
    n_bytes = 2 * n_elems if n_bytes is None else n_bytes
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S / reps
    iops, fops = plan_ops(plan)
    t_ops = n_elems * (iops / H100_INT32_OPS_PER_S
                       + fops / H100_F32_OPS_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
