"""End-to-end job driver: load -> iterate on the device -> store -> report.

The port's counterpart of the JAX package's driver (and of each reference
variant's ``main``): CLI -> load -> [compute loop] -> store -> metrics.
One image on one device, or spatially sharded over a mesh of devices
(``--mesh RxC``, or more than one device); ``--frames`` clips run as one
batch on one device. The compute window is fenced on every device of the
job at both ends, and excludes file I/O and the kernel build (the
reference's headline metric).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_stencil_torch.config import JobConfig
from tpu_stencil_torch.devices import resolve_devices
from tpu_stencil_torch.io import images as images_io
from tpu_stencil_torch.io import raw as raw_io
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import cuda_stencil
from tpu_stencil_torch.runtime import autotune
from tpu_stencil_torch.utils.timing import Timer, max_across_processes


def _load_input(cfg: JobConfig) -> np.ndarray:
    """Whole-image host load, any supported container format.

    ``frames > 1``: the raw file holds N concatenated frames; returns
    (N, H, W[, C])."""
    if images_io.is_raw(cfg.image, sniff=True):
        img = raw_io.read_raw(
            cfg.image, cfg.width, cfg.height * cfg.frames, cfg.channels
        )
        if cfg.channels == 1:
            img = img[..., 0]
        if cfg.frames > 1:
            img = img.reshape((cfg.frames, cfg.height) + img.shape[1:])
        return img
    if cfg.frames > 1:
        raise NotImplementedError(
            "--frames requires a raw input (N concatenated headerless frames)"
        )
    return images_io.load_image(cfg.image, cfg.image_type)


def _store_output(cfg: JobConfig, out: np.ndarray) -> None:
    """Write the result in the container format of the output path."""
    if cfg.frames > 1:
        out = out.reshape((cfg.frames * cfg.height,) + out.shape[2:])
    if images_io.is_raw(cfg.output_path):
        raw_io.write_raw(cfg.output_path, out)
    else:
        images_io.save_image(cfg.output_path, out)


def prepare_engine(model: IteratedConv2D, imgs: np.ndarray,
                   frames: Optional[int] = None):
    """Place ``imgs`` on the model's device and build the kernels it will
    launch (no launch, so the build stays out of the timed window).

    ``frames=None``: one (H, W[, C]) image; an int: an (N, H, W[, C]) clip.
    Returns ``(img_dev, step_fn, fetch)``: ``step_fn(x, n)`` runs n reps on
    the device, ``fetch`` brings the result to the host."""
    img_dev = torch.from_numpy(np.array(imgs, np.uint8)).to(model.device)
    if frames is not None:
        model.prepare(tuple(imgs.shape[1:3]),
                      imgs.shape[3] if imgs.ndim == 4 else 1)
        step_fn = model.batch
    else:
        model.prepare(tuple(imgs.shape[:2]),
                      imgs.shape[2] if imgs.ndim == 3 else 1)
        step_fn = model

    def fetch(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()

    return img_dev, step_fn, fetch


@dataclasses.dataclass
class JobResult:
    output_path: str
    compute_seconds: float  # reference-compatible: compute window only
    total_seconds: float    # whole job incl. I/O
    backend: str
    mesh_shape: Optional[tuple]  # (R, C) of a sharded run, else None
    schedule: Optional[str] = None  # kernel schedule that ran
    # Effective kernel geometry that launched (post align/clamp), reported
    # when a non-default geometry applied (forced by the user, or the
    # autotuner's verdict for this shape) and for a deep run on K1; None
    # otherwise (defaults, the resident kernel, or xla).
    block_h: Optional[int] = None
    fuse: Optional[int] = None
    # Kernel launches of this job's compute window, by kernel name.
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Measurements the autotuner made for this job, all before the compute
    # window (0: a warm cache, an explicit backend, or no card).
    tune_probes: int = 0


def _ran_geometry(model: IteratedConv2D, rows: int, w: int, channels: int,
                  schedule: Optional[str]):
    """The (block_h, fuse) to report for a ``rows``-tall kernel launch:
    a deep run reports what ran (None, None for the resident kernel);
    otherwise the effective geometry when the user forced either knob or
    the autotuner picked a non-default one for this shape."""
    bh, fz = model.resolved_geometry((rows, w), channels)
    if schedule == cuda_stencil.DEEP:
        return cuda_stencil.deep_geometry(model.plan, rows, w, channels,
                                          bh, fz, model.device)
    if bh is None and fz is None:
        return None, None
    return cuda_stencil.effective_geometry(model.plan, rows, channels, bh, fz)


def run_job(cfg: JobConfig, device: Optional[torch.device] = None,
            devices: Optional[List[torch.device]] = None) -> JobResult:
    """Run one iterated-convolution job end to end.

    ``devices``: the devices the job may use, as ``jax.devices()`` gives
    them to the JAX package's driver (a device may repeat: a mesh of
    several tiles on one card); None means ``[device]`` when ``device`` is
    given, else every visible CUDA device (raising when there is none). A
    single image with more than one device, or with any ``--mesh``, runs
    sharded; ``--mesh RxC`` takes the first R*C devices."""
    if devices is None:
        devices = resolve_devices() if device is None else [device]
    devices = [torch.device(d) for d in devices]
    probes_before = autotune.probe_count
    with Timer() as total_t:
        model = IteratedConv2D(cfg.filter_name, backend=cfg.backend,
                               schedule=cfg.schedule, boundary=cfg.boundary,
                               block_h=cfg.block_h, fuse=cfg.fuse,
                               device=devices[0])
        if cfg.frames > 1:
            if not (images_io.is_raw(cfg.image, sniff=True)
                    and images_io.is_raw(cfg.output_path)):
                raise NotImplementedError(
                    "--frames input and output are raw-only (N concatenated "
                    "headerless frames); single-image containers cannot "
                    "hold a clip"
                )
            if cfg.mesh_shape is not None:
                n_b = cfg.mesh_shape[0] * cfg.mesh_shape[1]
                if n_b > len(devices):
                    raise ValueError(
                        f"--mesh asks for {n_b} devices, have {len(devices)}"
                    )
            else:
                n_b = min(len(devices), cfg.frames)
            if n_b > 1:
                raise NotImplementedError(
                    f"--frames over {n_b} devices (batch-axis sharding) is "
                    "not ported yet; it comes with the streaming slice. "
                    "Run the clip on one device (--mesh 1x1)"
                )
        elif len(devices) > 1 or cfg.mesh_shape is not None:
            if cfg.boundary != "zero" and cfg.mesh_shape is None:
                # A periodic run that never asked for a mesh must not fail
                # on an auto-chosen grid the image does not divide.
                devices = devices[:1]
            if cfg.mesh_shape is not None:
                devices = devices[:cfg.mesh_shape[0] * cfg.mesh_shape[1]]
            return _run_sharded(cfg, model, devices, total_t, probes_before)
        device = devices[0]
        img = _load_input(cfg)
        img_dev, step_fn, fetch = prepare_engine(
            model, img, frames=cfg.frames if cfg.frames > 1 else None,
        )
        before = cuda_stencil.launch_counts()
        with Timer("iterate", device=device) as t:
            out_dev = step_fn(img_dev, cfg.repetitions)
        after = cuda_stencil.launch_counts()
        out = fetch(out_dev)
        compute_seconds = max_across_processes(t.elapsed)
        _store_output(cfg, out)

    if cfg.frames > 1:
        backend, schedule = model.batch_config(
            (cfg.height, cfg.width), cfg.channels
        )
        geo_rows = cuda_stencil.frames_rows(model.plan, cfg.height,
                                            cfg.frames)
    else:
        backend, schedule = model.resolved_config(
            (cfg.height, cfg.width), cfg.channels
        )
        geo_rows = cfg.height
    bh, fz = (None, None)
    if backend == "pallas":
        bh, fz = _ran_geometry(model, geo_rows, cfg.width, cfg.channels,
                               schedule)
    return JobResult(
        output_path=cfg.output_path,
        compute_seconds=compute_seconds,
        total_seconds=total_t.elapsed,
        backend=backend,
        mesh_shape=None,
        schedule=schedule,
        block_h=bh,
        fuse=fz,
        launches={k: after[k] - before[k] for k in after},
        tune_probes=autotune.probe_count - probes_before,
    )


def _run_sharded(cfg: JobConfig, model: IteratedConv2D,
                 devices: List[torch.device], total_t: Timer,
                 probes_before: int = 0) -> JobResult:
    """One image over a mesh of ``devices``: each mesh row's band read once
    from a raw input (else the decoded image cut into tiles), K3 built
    outside the window, the rep loop fenced on every mesh device, each
    tile's rectangle written at its offsets into a raw output (else the
    stitched image saved)."""
    from tpu_stencil_torch.parallel import distributed, sharded

    h, w, ch = cfg.height, cfg.width, cfg.channels
    runner = sharded.ShardedRunner(model, (h, w), ch,
                                   mesh_shape=cfg.mesh_shape,
                                   devices=devices)
    if images_io.is_raw(cfg.image, sniff=True):
        tiles = distributed.read_sharded(cfg.image, h, w, ch, runner.mesh)
    else:
        tiles = runner.put(_load_input(cfg))
    runner.prepare()
    before = cuda_stencil.launch_counts()
    with Timer("iterate", device=runner.devices) as t:
        out = runner.run(tiles, cfg.repetitions)
    after = cuda_stencil.launch_counts()
    compute_seconds = max_across_processes(t.elapsed)
    if images_io.is_raw(cfg.output_path):
        distributed.write_sharded(cfg.output_path, out, h, w, ch)
    else:
        images_io.save_image(cfg.output_path, runner.fetch(out))
    # Report an applied (forced or tuned) geometry as what K3 launches at
    # this tile.
    sh_bh = sh_fuse = None
    if runner.geo_applied:
        sh_bh = runner.block_h_eff
        if sh_bh is None:
            sh_bh = cuda_stencil.valid_geometry(model.plan, runner.tile[0],
                                                ch, runner.fuse)[0]
        sh_fuse = runner.fuse
    return JobResult(
        output_path=cfg.output_path,
        compute_seconds=compute_seconds,
        total_seconds=total_t.elapsed,
        backend=runner.backend,
        mesh_shape=runner.mesh_shape,
        schedule=runner.schedule,
        block_h=sh_bh,
        fuse=sh_fuse,
        launches={k: after[k] - before[k] for k in after},
        tune_probes=autotune.probe_count - probes_before,
    )
