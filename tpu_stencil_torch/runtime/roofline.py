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

The stream half: :func:`stream_stage_seconds`,
:func:`stream_frames_per_second`, :func:`pcie_contention_frames_per_second`
and :func:`mesh_stream_frames_per_second` model the streaming engine's
device-side stages (one frame's copy to the card and back over the host
link, its reps at the operations bound) and the bound they put on
frames/s, on one card and over a fan of cards behind one host.

The peak rates are those of one H100 SXM from NVIDIA's data sheet (dense,
at the full 700 W power limit; the host link PCIe Gen5 x16). The
interconnect model and the sharded-stream and pipeline models of the JAX
module are not ported yet; its ghost byte counts of the sharded exchange
are (:func:`ici_ghost_bytes_per_edge`, :func:`ici_ghost_bytes_per_rep`,
pure counts under the JAX names, with no interconnect rate beside them).
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
# The H100 SXM's host link (data sheet): PCIe Gen5 x16, 64 GB/s in each
# direction; a frame's copy to the card and its copy back use one
# direction each.
H100_PCIE_BYTES_PER_S = 64e9

ENV_DEVICE_HBM_BYTES = "TPU_STENCIL_TORCH_DEVICE_HBM_BYTES"


def _plan(filter_name: str):
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import lowering

    return lowering.plan_filter(filters.get_filter(filter_name))


def effective_fuse(filter_name: str, h_img: int,
                   block_h=None, fuse=None, schedule=None,
                   w_img=None, channels: int = 1, reps=None,
                   n_frames: int = 1, device=None) -> float:
    """Reps per trip through device memory that
    :func:`tpu_stencil_torch.ops.cuda_stencil.iterate` achieves for this
    (filter, image height): device-memory traffic per rep is divided by
    it. Mirrors the launch: K1's clamped fuse (``block_h``/``fuse``: a
    forced or tuned geometry; None = module defaults); under
    ``schedule='deep'``, when the resident kernel runs, ``reps`` over K2's
    grid syncs (one round trip of the image through its two buffers per
    sync; K2's reps per sync without ``reps``; ``w_img``/``channels`` feed
    its L2 feasibility check; without a width it is taken as infeasible),
    else K1's deep depth. ``n_frames`` > 1 models the tall-image batch
    launch."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    plan = _plan(filter_name)
    if not cs.plan_supported(plan, channels):
        return 1
    rows = cs.frames_rows(plan, h_img, n_frames) if n_frames > 1 else h_img
    sched = cs.check_schedule(schedule)
    if (sched == cs.DEEP and w_img and block_h is None and fuse is None
            and cs.resident_feasible(plan, rows, w_img * channels, channels,
                                     device)):
        fz = cs.resident_geometry(plan, rows, w_img * channels, channels,
                                  cs.device_caps(device)[1])[1]
        return reps / len(cs.launch_schedule(reps, fz)) if reps else fz
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


def ici_ghost_bytes_per_edge(tile_shape, channels: int, halo: int,
                             mesh_shape, fuse: int = 1,
                             elem_bytes: int = 1,
                             mode: str = "phased") -> dict:
    """Modelled ghost bytes *received per tile per repetition* on the
    sharded mesh, per edge: ``{"n", "s", "w", "e"[, "corners"]}`` (keys
    only for edges that exchange: an axis of one tile exchanges nothing).

    ``mode="phased"`` is the corner-routed exchange of the joined
    schedules (off, split, fused-split): the column strips ride the
    row-extended tile, so W/E are ``tile_h + 2*g`` tall and carry the
    corners. ``mode="edge"`` is the per-edge pipeline: every strip covers
    the bare tile (W/E ``tile_h`` tall) and the four ``g x g`` corner
    patches come by the packed second hop, as ``"corners"``. A chunk of
    ``fuse`` reps pays one exchange ``g = fuse*halo`` deep, so per-rep
    bytes divide by ``fuse``. The JAX package's model, unchanged."""
    th, tw = tile_shape
    r, c = mesh_shape
    g = fuse * halo
    scale = elem_bytes / max(1, fuse)
    per_edge = {}
    if r > 1:
        per_edge["n"] = per_edge["s"] = g * tw * channels * scale
    if c > 1:
        rows = th + (2 * g if (r > 1 and mode != "edge") else 0)
        per_edge["w"] = per_edge["e"] = g * rows * channels * scale
        if mode == "edge":
            per_edge["corners"] = 4 * g * g * channels * scale
    return per_edge


def ici_ghost_bytes_per_rep(tile_shape, channels: int, halo: int,
                            mesh_shape, fuse: int = 1,
                            elem_bytes: int = 1,
                            mode: str = "phased") -> float:
    """Total modelled ghost bytes received per tile per repetition: the sum
    of :func:`ici_ghost_bytes_per_edge` (``elem_bytes`` 1 for the uint8
    exchanges, 4 for the torch-ops sep_int step's int32 phases)."""
    return float(sum(ici_ghost_bytes_per_edge(
        tile_shape, channels, halo, mesh_shape, fuse=fuse,
        elem_bytes=elem_bytes, mode=mode,
    ).values()))


# ---------------------------------------------------------------------------
# The stream half
# ---------------------------------------------------------------------------


def stream_stage_seconds(frame_bytes: int, reps: int, backend: str,
                         filter_name: str, h_img: int,
                         block_h=None, fuse=None, w_img=None,
                         channels: int = 1, schedule=None,
                         device=None) -> dict:
    """Modelled seconds per frame of the streaming engine's device-side
    stages: ``h2d`` and ``d2h`` move one frame over the host link in one
    direction each; ``compute`` runs ``reps`` reps at
    :func:`bound_ms_per_rep` over the bytes the backend moves (the kernels
    once per :func:`effective_fuse` reps, the torch ops every rep). The
    host's ``read`` and ``write`` are measured, never modelled: no
    constant holds for every disk and pipe."""
    compute = 0.0
    if reps > 0:
        per_rep_bytes = analytic_bytes_per_rep(
            frame_bytes, backend, filter_name, h_img, block_h, fuse,
            schedule=schedule, w_img=w_img, channels=channels, reps=reps,
            device=device)
        ms, _ = bound_ms_per_rep(_plan(filter_name), frame_bytes, reps,
                                 n_bytes=per_rep_bytes * reps)
        compute = reps * ms / 1e3
    link = frame_bytes / H100_PCIE_BYTES_PER_S
    return {"h2d": link, "compute": compute, "d2h": link}


def stream_frames_per_second(frame_bytes: int, reps: int, backend: str,
                             filter_name: str, h_img: int,
                             block_h=None, fuse=None,
                             pipeline_depth: int = 2, **geometry) -> float:
    """The modelled steady-state frames/s of one device's stream: with
    frames in flight (``pipeline_depth`` >= 2) the stages overlap and the
    bound is ``1 / max(stage)``; at depth 1 they run one after another and
    it is ``1 / sum(stage)``. ``geometry``: :func:`stream_stage_seconds`'s
    ``w_img``, ``channels``, ``schedule``, ``device``."""
    stages = stream_stage_seconds(frame_bytes, reps, backend, filter_name,
                                  h_img, block_h, fuse, **geometry)
    bound = (sum(stages.values()) if pipeline_depth <= 1
             else max(stages.values()))
    return 1.0 / bound if bound > 0 else float("inf")


def pcie_contention_frames_per_second(frame_bytes: int) -> float:
    """The host link's ceiling on a whole fan's frames/s: every frame goes
    to a card and comes back, one direction each, and the fan's lanes
    share one host, so whatever the number of cards the model lets no
    more than ``H100_PCIE_BYTES_PER_S / frame_bytes`` frames a second
    through (the conservative shape of one shared link; a host with a
    link per card would scale it, and then it does not bind)."""
    return H100_PCIE_BYTES_PER_S / float(frame_bytes)


def mesh_stream_frames_per_second(frame_bytes: int, reps: int,
                                  backend: str, filter_name: str,
                                  h_img: int, block_h=None, fuse=None,
                                  pipeline_depth: int = 2,
                                  n_devices: int = 1,
                                  **geometry) -> float:
    """The modelled whole-fan frames/s of the mesh fan-out
    (:mod:`tpu_stencil_torch.parallel.fanout`): frames are independent,
    so ``n_devices`` times one device's bound
    (:func:`stream_frames_per_second`), capped by the shared host link
    (:func:`pcie_contention_frames_per_second`)."""
    per_device = stream_frames_per_second(
        frame_bytes, reps, backend, filter_name, h_img, block_h, fuse,
        pipeline_depth=pipeline_depth, **geometry)
    return min(per_device * max(1, n_devices),
               pcie_contention_frames_per_second(frame_bytes))
