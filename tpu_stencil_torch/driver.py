"""End-to-end job driver: load -> iterate on the device -> store -> report.

The port's counterpart of the JAX package's driver (and of each reference
variant's ``main``): CLI -> load -> place -> warm-up -> [compute loop] ->
fetch -> store -> metrics, each step an ``obs.phase``. One image on one
device, or spatially sharded over a mesh of devices (``--mesh RxC``, or
more than one device, or several processes); ``--frames`` clips run as
one batch per device, each device taking a contiguous share of the frames
(the JAX package's batch axis), and across processes one contiguous frame
range per process, batched over its devices.
The compute window opens after a barrier of the processes, is fenced on
every local device of the job at both ends, is max-reduced over the
processes, and excludes file I/O, the kernel build and the warm-up that
launches each kernel instance once before it (the reference's timer opens
after ``MPI_Barrier``).

The job is hardened as the JAX package's is: named fault points
(``resilience.faults``), the fallback ladder around the warm-up
(``resilience.fallback``), the dispatch watchdog on every fence of the
window (``resilience.deadline``) and checkpoint/resume between chunks of
the window (``runtime.checkpoint``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from tpu_stencil_torch import filters as _filters
from tpu_stencil_torch import obs
from tpu_stencil_torch.config import JobConfig
from tpu_stencil_torch.devices import resolve_devices
from tpu_stencil_torch.io import images as images_io
from tpu_stencil_torch.io import raw as raw_io
from tpu_stencil_torch.models.blur import IteratedConv2D
from tpu_stencil_torch.ops import cuda_stencil
from tpu_stencil_torch.ops import lowering as _lowering
from tpu_stencil_torch.parallel import distributed
from tpu_stencil_torch.resilience import deadline as _deadline
from tpu_stencil_torch.resilience import errors as _errors
from tpu_stencil_torch.resilience import fallback as _fallback
from tpu_stencil_torch.resilience import faults as _faults
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


def _window_calls(reps: int, checkpoint_every: int,
                  traced: bool) -> List[int]:
    """The rep counts of the step-function calls the timed window makes
    for ``reps`` reps: one call of all of them; chunks of
    ``checkpoint_every``; one rep per call under tracing."""
    if reps <= 0:
        return []
    if traced:
        return [1]
    if checkpoint_every:
        calls = {min(checkpoint_every, reps)}
        if reps % checkpoint_every:
            calls.add(reps % checkpoint_every)
        return sorted(calls)
    return [reps]


class Engine(NamedTuple):
    """What :func:`prepare_engine` hands the timed window."""

    img_dev: torch.Tensor  # the placed input (the warm-up never wrote it)
    step_fn: Callable      # step_fn(x, n): n reps on the device
    fetch: Callable        # a result to the host
    warm_reps: List[int]   # the rep counts the warm-up ran
    warm_launches: Dict[str, int]  # the kernel launches it made


def _share(n_frames: int, n_devices: int) -> int:
    """Frames per device of a batch over ``n_devices``: the clip is
    zero-padded to a multiple of the device count."""
    return -(-n_frames // n_devices)


def _place_frames(imgs: np.ndarray, devices) -> List[torch.Tensor]:
    """An (N, H, W[, C]) clip as one contiguous share per device: N
    zero-padded to a multiple of ``len(devices)`` (the JAX package's
    ``_put_batched``; :func:`prepare_engine`'s fetch crops), share ``d`` on
    ``devices[d]``. Frames never mix, so nothing is exchanged."""
    per = _share(imgs.shape[0], len(devices))
    pad = per * len(devices) - imgs.shape[0]
    if pad:
        imgs = np.concatenate(
            [imgs, np.zeros((pad,) + imgs.shape[1:], np.uint8)])
    return [torch.from_numpy(np.array(imgs[d * per:(d + 1) * per]))
            .to(dev) for d, dev in enumerate(devices)]


def prepare_engine(model: IteratedConv2D, imgs: np.ndarray,
                   frames: Optional[int] = None,
                   calls: Sequence[int] = (),
                   timeout_s: float = 0.0,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> Engine:
    """Place ``imgs`` on the model's device, build the kernels it will
    launch, and warm them up, all before the timed window (the JAX
    package's ``prepare_engine``; the reference's timer opens after
    ``MPI_Barrier``).

    The warm-up runs, on a scratch copy of the placed input (never the
    input itself), one call of the step function for each rep count of
    :meth:`IteratedConv2D.warm_reps` over ``calls`` (the rep count of each
    call the window will make): each kernel instance the window launches
    is launched once (K1's fused depth and its single-rep remainder, or
    K2's one launch, which also resolves ``resident_geometry``; one rep of
    the torch ops off the kernels), then fenced, under the dispatch
    watchdog when ``timeout_s`` arms it (so the watchdog's drain thread
    has started before the window, which fences with it). It is the
    ``compile``
    phase and the ``compile`` fault point; what it raises is what the
    fallback ladder sees. Its launches are counted by the kernels'
    counters, before the window's.

    ``frames=None``: one (H, W[, C]) image; an int: an (N, H, W[, C])
    clip. ``devices`` (a clip only): more than one batches it over them,
    a contiguous share each (:func:`_place_frames`); the engine's tensor
    is then the list of shares, the step runs each share on its device
    and the fetch joins and crops them. Returns an :class:`Engine`."""
    fault_h2d = _faults.site("h2d")
    fault_compile = _faults.site("compile")
    batched = frames is not None and devices is not None and len(devices) > 1
    with obs.phase("place"):
        if fault_h2d is not None:
            fault_h2d()
        if batched:
            img_dev = _place_frames(np.asarray(imgs, np.uint8), devices)
        else:
            img_dev = torch.from_numpy(
                np.array(imgs, np.uint8)).to(model.device)
    if batched:
        shape = tuple(imgs.shape[1:3])
        channels = imgs.shape[3] if imgs.ndim == 4 else 1
        per_device = _share(frames, len(devices))

        def step_fn(xs, n):
            return [model.batch_on(x, n) for x in xs]
    elif frames is not None:
        shape = tuple(imgs.shape[1:3])
        channels = imgs.shape[3] if imgs.ndim == 4 else 1
        per_device = frames
        step_fn = model.batch
    else:
        shape = tuple(imgs.shape[:2])
        channels = imgs.shape[2] if imgs.ndim == 3 else 1
        step_fn = model
    with obs.phase("compile") as s:
        if fault_compile is not None:
            fault_compile()
        model.prepare(shape, channels)
        warm = model.warm_reps(shape, channels, calls,
                               n_frames=None if frames is None
                               else per_device)
        before = cuda_stencil.launch_counts()
        scratch = ([x.clone() for x in img_dev] if batched
                   else img_dev.clone())
        for n in warm:
            scratch = step_fn(scratch, n)
        s.fence(_deadline.fence(scratch, timeout_s, "driver.warmup"))
        warm_launches = _delta(cuda_stencil.launch_counts(), before)

    def fetch(x) -> np.ndarray:
        if batched:
            return np.concatenate([t.cpu().numpy() for t in x])[:frames]
        return x.cpu().numpy()

    return Engine(img_dev, step_fn, fetch, warm, warm_launches)


def _describe_site(cfg: JobConfig, kernels: List[dict], backend: str,
                   schedule: Optional[str], block_h: Optional[int],
                   fuse: Optional[int], device) -> dict:
    """What :func:`obs.introspect.capture` records for one site: the
    kernel instances, their libraries' build seconds, and the modelled
    bytes (:func:`roofline.analytic_bytes_per_rep`) and operations
    (:func:`roofline.plan_ops`) per rep of the job."""
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.runtime import roofline

    n_elems = cfg.nbytes
    iops, fops = roofline.plan_ops(_lowering.plan_filter(
        _filters.get_filter(cfg.filter_name)))
    builds = [_build.build_seconds(k) for k in
              dict.fromkeys(r["kernel"] for r in kernels)]
    return {
        "kernels": kernels,
        "build_seconds": (sum(builds) if builds and None not in builds
                          else None),
        "model_bytes_per_rep": roofline.analytic_bytes_per_rep(
            n_elems, backend, cfg.filter_name, cfg.height, block_h, fuse,
            schedule=schedule, w_img=cfg.width, channels=cfg.channels,
            reps=cfg.repetitions, n_frames=cfg.frames, device=device),
        "model_ops_per_rep": n_elems * (iops + fops),
    }


def _record_device_memory(device) -> None:
    """Point-in-time device-memory gauges into the driver registry, taken
    right after the compute window while the working set is resident;
    nothing without a CUDA device."""
    obs.introspect.record_memory_gauges(obs.registry(), device=device)


def _maybe_profile(profile_dir: Optional[str], devices):
    """A ``torch.profiler`` trace of the compute window (``--profile``),
    with CUDA activity when the job runs on a card, written into
    ``profile_dir`` as Chrome trace JSON."""
    if profile_dir is None:
        return contextlib.nullcontext()
    return _profile_window(profile_dir, devices)


@contextlib.contextmanager
def _profile_window(profile_dir: str, devices):
    """The profiler around the window; its trace carries the program's
    profiler-only spans of the window too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if any(torch.device(d).type == "cuda" for d in devices):
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    t0_ns = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(profile_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    obs.export.add_profiled_spans(path, t0_ns, time.time_ns())


def _maybe_restore(cfg: JobConfig,
                   resume: bool) -> Tuple[int, Optional[np.ndarray]]:
    """(completed reps, frame) from a matching checkpoint, else (0, None);
    checked before the input is read, so a resume never pays the load."""
    if not resume:
        return 0, None
    from tpu_stencil_torch.runtime import checkpoint as ckpt

    return ckpt.restore(cfg) or (0, None)


def _reps_spanned(run_fn: Callable, img_dev, n_reps: int, rep0: int = 0):
    """One call of ``n_reps`` normally; under tracing, ``n_reps`` one-rep
    calls, each fenced and recorded as its own ``iterate.rep`` span
    (``rep`` = its absolute rep number ``rep0 + i``), so per-rep time is
    attributed to the rep that spent it. The cost is one launch and one
    synchronize per rep (K1's fused reps run one at a time): the JAX
    package's documented cost of span-level attribution."""
    if n_reps <= 0 or not obs.enabled():
        return run_fn(img_dev, n_reps)
    for i in range(n_reps):
        with obs.span("iterate.rep", "driver", rep=rep0 + i) as s:
            img_dev = s.fence(run_fn(img_dev, 1))
    return img_dev


def _checkpointed_iterate(cfg: JobConfig, run_fn: Callable,
                          save_fn: Callable, img_dev, checkpoint_every: int,
                          start_rep: int, devices,
                          fault: Optional[Callable] = None,
                          timeout_s: float = 0.0):
    """Run the remaining reps, checkpointing every ``checkpoint_every``.
    Returns (out, compute_seconds): each chunk opens after a barrier of
    the processes and is fenced on every device of ``devices`` at both
    ends (its end under the dispatch watchdog, :func:`deadline.fence`),
    the window is the sum of the chunks, and the checkpoint I/O between
    chunks stays outside it. The final state is the job's output, not a
    checkpoint. Every process runs the same chunks.

    ``fault`` is the ``compute`` injection site, resolved once by the
    caller (None when unarmed): a call covering reps [r, r+n) checks it
    at every rep index it spans, so ``compute:rep=N`` fires whatever the
    chunking."""
    if fault is not None:
        inner_run = run_fn

        def run_fn(x, n, _rep=[start_rep]):
            for r in range(_rep[0], _rep[0] + n):
                fault(r)
            _rep[0] += n
            return inner_run(x, n)

    total = 0.0
    rep = start_rep
    while True:
        n = cfg.repetitions - rep
        if checkpoint_every:
            n = min(checkpoint_every, n)
        distributed.barrier(timeout_s)
        with Timer("iterate", device=devices) as t:
            img_dev = _reps_spanned(run_fn, img_dev, n, rep)
            _deadline.fence(img_dev, timeout_s, f"driver.iterate[rep={rep}]")
        total += t.elapsed
        rep += n
        if rep >= cfg.repetitions:
            return img_dev, total
        save_fn(rep, img_dev)


def _clear_checkpoint(cfg: JobConfig, checkpoint_every: int,
                      resume: bool) -> None:
    if checkpoint_every or resume:
        from tpu_stencil_torch.runtime import checkpoint as ckpt

        ckpt.clear(cfg)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


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
    # The tile body the kernels ran (K1's cuda_stencil.K1Launch, K2's and
    # K3's cuda_stencil.tile_body); None off the kernels.
    body: Optional[str] = None
    # Kernel launches of the warm-up before the window, by kernel name
    # (not the autotuner's probes nor a sharded run's tracing probes).
    warmup_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # The interior/border overlap schedule a sharded run ran ("off",
    # "split", "fused-split" or "edge": "auto" resolved, and a mode that
    # degraded reported as what ran); None on one device (no exchange).
    overlap: Optional[str] = None


def _ran_launch(model: IteratedConv2D, shape: Tuple[int, int],
               channels: int, n_frames: Optional[int], schedule: Optional[str],
               reps: int) -> Tuple[Optional[int], Optional[int], str]:
    """(block_h, fuse, body) to report for the rep loop on ``shape``
    (``n_frames``: the frames' tall layout), from the model's
    :class:`cuda_stencil.RepLoop`: the body of a ``reps``-rep call's first
    launch (K2's :func:`cuda_stencil.tile_body`), and the tile height and
    depth of its fused K1 launch for a deep run (None, None for K2) or
    where the user forced either knob or the autotuner picked a
    non-default one for this shape."""
    loop = model.rep_loop(shape, channels, n_frames)
    if loop.kernel == "stencil_resident":
        return None, None, cuda_stencil.tile_body(model.plan)
    body = (loop.launches(reps)[:1] or [loop.fused])[0].body
    if (schedule != cuda_stencil.DEEP
            and model.resolved_geometry(shape, channels) == (None, None)):
        return None, None, body
    return loop.fused.tile_h, loop.fuse, body


def run_job(cfg: JobConfig, device: Optional[torch.device] = None,
            devices: Optional[List[torch.device]] = None,
            profile_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False) -> JobResult:
    """Run one iterated-convolution job end to end.

    ``devices``: the devices the job may use, as ``jax.devices()`` gives
    them to the JAX package's driver (a device may repeat: a mesh of
    several tiles on one card); None means ``[device]`` when ``device`` is
    given, else every visible CUDA device (raising when there is none). A
    single image with more than one device, or with any ``--mesh``, runs
    sharded; ``--mesh RxC`` takes the first R*C devices. Across processes
    (:func:`distributed.initialize`) ``devices`` are this process's: a
    single image runs sharded over every device of every process, and a
    clip splits into one contiguous frame range per process.

    ``profile_dir``: a ``torch.profiler`` trace of the window there.
    ``checkpoint_every``/``resume``: checkpoint every N reps, and resume
    from a matching checkpoint (:mod:`tpu_stencil_torch.runtime.
    checkpoint`). On one device a resource failure of the warm-up walks
    the fallback ladder (:func:`tpu_stencil_torch.resilience.fallback.
    job_ladder`: on a card from K2 to K1 only)."""
    if checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}")
    if devices is None:
        devices = resolve_devices() if device is None else [device]
    devices = [torch.device(d) for d in devices]
    rungs = _fallback.job_ladder(cfg.backend, cfg.schedule,
                                 cfg.fallback_backend, devices[0])
    probes_before = autotune.probe_count
    multi = distributed.process_count() > 1
    obs.registry().counter("jobs_total").inc()
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
            if multi:
                return _run_frames_multiprocess(
                    cfg, model, devices, total_t, probes_before,
                    profile_dir, checkpoint_every, resume)
            if cfg.mesh_shape is not None:
                n_b = cfg.mesh_shape[0] * cfg.mesh_shape[1]
                if n_b > len(devices):
                    raise ValueError(
                        f"--mesh asks for {n_b} devices, have {len(devices)}"
                    )
            else:
                n_b = min(len(devices), cfg.frames)
            devices = devices[:n_b]
        elif multi or len(devices) > 1 or cfg.mesh_shape is not None:
            if not multi and cfg.boundary != "zero" and cfg.mesh_shape is None:
                # A periodic run that never asked for a mesh must not fail
                # on an auto-chosen grid the image does not divide.
                devices = devices[:1]
            if not multi and cfg.mesh_shape is not None:
                # Across processes a mesh spans every device instead.
                devices = devices[:cfg.mesh_shape[0] * cfg.mesh_shape[1]]
            return _run_sharded(cfg, model, devices, total_t, probes_before,
                                profile_dir, checkpoint_every, resume)
        start_rep, frame = _maybe_restore(cfg, resume)
        fault_read = _faults.site("read")
        with obs.phase("load"):
            if fault_read is not None:
                fault_read()
            img = _load_input(cfg) if frame is None else frame
        frames = cfg.frames if cfg.frames > 1 else None
        calls = _window_calls(cfg.repetitions - start_rep, checkpoint_every,
                              obs.enabled())
        timeout_s = _deadline.resolve(cfg.dispatch_timeout_s)
        # A clip batches over its devices (one share each); one image
        # runs on the model's device.
        run_devices = devices if frames else [model.device]
        share = _share(cfg.frames, len(run_devices))
        # The fallback ladder: a resource failure of the warm-up (the card
        # out of memory, a launch asking for more than the card has, an
        # injected OOM) steps deep -> default schedule; on the CPU on to
        # torch ops (-> opt-in CPU rung). Every rung writes the same
        # bytes; each step is counted, traced and printed.
        for i, rung in enumerate(rungs):
            if i:
                # Demoted rung: default geometry too, the failed warm-up
                # may have been the geometry's.
                model = IteratedConv2D(
                    cfg.filter_name, backend=rung.backend,
                    schedule=rung.schedule, boundary=cfg.boundary,
                    device=(torch.device(rung.platform) if rung.platform
                            else devices[0]))
            try:
                engine = prepare_engine(
                    model, img, frames=frames, calls=calls,
                    timeout_s=timeout_s,
                    devices=run_devices if frames else None)
                break
            except Exception as e:
                if i + 1 >= len(rungs) or not _fallback.demotable(e):
                    raise
                _fallback.record_demotion(rung, rungs[i + 1], e)
        shape2 = (cfg.height, cfg.width)
        if cfg.frames > 1:
            backend, schedule = model.batch_config(shape2, cfg.channels)
        else:
            backend, schedule = model.resolved_config(shape2, cfg.channels)
        bh, fz, body = None, None, None
        if backend == "pallas":
            bh, fz, body = _ran_launch(model, shape2, cfg.channels,
                                       share if cfg.frames > 1 else None,
                                       schedule, cfg.repetitions)
        if obs.introspect.enabled():
            obs.introspect.capture(
                "driver.warmup",
                lambda: _describe_site(
                    cfg, model.describe_launches(
                        shape2, cfg.channels, engine.warm_reps,
                        n_frames=share if frames else None),
                    backend, schedule, bh, fz, model.device),
                meta={"shape": tuple(np.asarray(img).shape),
                      "frames": frames, "devices": len(run_devices),
                      "warm_reps": engine.warm_reps})

        def save_fn(rep, x):
            from tpu_stencil_torch.runtime import checkpoint as ckpt

            ckpt.save(cfg, rep, engine.fetch(x))

        before = cuda_stencil.launch_counts()
        with _maybe_profile(profile_dir, run_devices):
            with obs.phase("iterate", reps=cfg.repetitions):
                out_dev, compute = _checkpointed_iterate(
                    cfg, engine.step_fn, save_fn, engine.img_dev,
                    checkpoint_every, start_rep, run_devices,
                    fault=_faults.site("compute"), timeout_s=timeout_s,
                )
        after = cuda_stencil.launch_counts()
        fault_d2h = _faults.site("d2h")
        with obs.phase("fetch"):
            if fault_d2h is not None:
                fault_d2h()
            out = engine.fetch(out_dev)
        _record_device_memory(model.device)
        compute_seconds = max_across_processes(compute)
        fault_write = _faults.site("write")
        with obs.phase("store"):
            if fault_write is not None:
                fault_write()
            _store_output(cfg, out)
        _clear_checkpoint(cfg, checkpoint_every, resume)

    return JobResult(
        output_path=cfg.output_path,
        compute_seconds=compute_seconds,
        total_seconds=total_t.elapsed,
        backend=backend,
        mesh_shape=None,
        schedule=schedule,
        block_h=bh,
        fuse=fz,
        launches=_delta(after, before),
        tune_probes=autotune.probe_count - probes_before,
        body=body,
        warmup_launches=engine.warm_launches,
    )


def _run_sharded(cfg: JobConfig, model: IteratedConv2D,
                 devices: List[torch.device], total_t: Timer,
                 probes_before: int = 0, profile_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 resume: bool = False) -> JobResult:
    """One image over a mesh of ``devices``: each mesh row's band read once
    from a raw input (else the decoded image cut into tiles), or the tiles
    of a matching checkpoint; K3 built and warmed up (one chunk at the
    runner's depth, one exchange and K3 on every tile, plus a one-rep
    chunk when the window has a remainder, on a scratch copy) and fenced
    on every mesh device outside the window; under tracing, the
    exchange/compute probes; the rep loop fenced on every mesh device,
    chunked by ``checkpoint_every``; each tile's rectangle written at its
    offsets into a raw output (else the stitched image saved). The
    runner takes ``cfg.overlap``; each call of the window (a
    ``--checkpoint-every`` chunk among them) starts its own slab and
    exchanges it from the tiles it is given.

    Across processes each process reads, runs and writes only its own
    tiles (raw input and output only), the exchange crosses processes,
    and the window is max-reduced. A dispatch timeout of the window (a
    device fence, or a wait on a peer's strip) is raised as
    :class:`~tpu_stencil_torch.resilience.errors.CollectiveTimeout`,
    with per-edge verdicts in one process only."""
    from tpu_stencil_torch.parallel import sharded
    from tpu_stencil_torch.runtime import checkpoint as ckpt

    h, w, ch = cfg.height, cfg.width, cfg.channels
    multi = distributed.process_count() > 1
    if multi and not images_io.is_raw(cfg.output_path):
        # Fail before the compute: no process holds the whole image.
        raise NotImplementedError(
            "a job of several processes needs a .raw output path "
            "(per-process strided writes); convert afterwards")
    timeout_s = _deadline.resolve(cfg.dispatch_timeout_s)
    runner = sharded.ShardedRunner(model, (h, w), ch,
                                   mesh_shape=cfg.mesh_shape,
                                   devices=devices, overlap=cfg.overlap,
                                   timeout_s=timeout_s)
    start_rep, tiles = 0, None
    if resume:
        restored = ckpt.restore_sharded(cfg, runner)
        if restored is not None:
            start_rep, tiles = restored
    fault_read = _faults.site("read")
    if tiles is None:
        with obs.phase("load"):
            if fault_read is not None:
                fault_read()
            if images_io.is_raw(cfg.image, sniff=True):
                tiles = distributed.read_sharded(cfg.image, h, w, ch,
                                                 runner.mesh)
            elif multi:
                raise NotImplementedError(
                    "a job of several processes needs a .raw input "
                    "(per-process strided reads); convert it first")
            else:
                tiles = runner.put(_load_input(cfg))
    calls = _window_calls(cfg.repetitions - start_rep, checkpoint_every,
                          obs.enabled())
    fault_compile = _faults.site("compile")
    with obs.phase("compile") as s:
        if fault_compile is not None:
            fault_compile()
        runner.prepare()
        warm = runner.warm_reps(calls)
        warm_before = cuda_stencil.launch_counts()
        s.fence(_deadline.fence(runner.warmup(tiles, warm), timeout_s,
                                "sharded.warmup"))
        warm_launches = _delta(cuda_stencil.launch_counts(), warm_before)
    if obs.enabled():
        runner.trace_phase_probes(tiles)
    # Report an applied (forced or tuned) geometry as what K3 launches at
    # this tile.
    sh_bh = sh_fuse = None
    if runner.geo_applied:
        sh_bh = runner.block_h_eff
        if sh_bh is None:
            sh_bh = cuda_stencil.valid_geometry(model.plan, runner.tile[0],
                                                ch, runner.fuse)[0]
        sh_fuse = runner.fuse
    runner.introspect_warmup(warm, lambda kernels: _describe_site(
        cfg, kernels, runner.backend, runner.schedule, sh_bh, sh_fuse,
        runner.devices[0]))

    def save_fn(rep, grid):
        ckpt.save_sharded(cfg, rep, grid)

    # The "collective" fault point fires at launch granularity: the host
    # side of each call, which runs its halo exchanges.
    fault_coll = _faults.site("collective")
    run_fn = runner.run
    if fault_coll is not None:
        def run_fn(x, n, _inner=runner.run):
            fault_coll()
            return _inner(x, n)
    before = cuda_stencil.launch_counts()
    try:
        with _maybe_profile(profile_dir, runner.devices):
            with obs.phase("iterate", reps=cfg.repetitions):
                out, compute = _checkpointed_iterate(
                    cfg, run_fn, save_fn, tiles, checkpoint_every, start_rep,
                    runner.devices, fault=_faults.site("compute"),
                    timeout_s=timeout_s,
                )
    except _errors.DispatchTimeout as e:
        edges = {}
        if not multi:
            # Which edge is wedged, itself under a watchdog; across
            # processes the probes would exchange with ranks that did not
            # time out and will not join them.
            try:
                edges = runner.diagnose_edges(
                    timeout_s=min(10.0, timeout_s or 10.0))
            except Exception:
                pass
        raise _errors.CollectiveTimeout(e.label, e.seconds,
                                        edges=edges) from e
    after = cuda_stencil.launch_counts()
    _record_device_memory(runner.devices[0])
    compute_seconds = max_across_processes(compute)
    fault_write = _faults.site("write")
    with obs.phase("store"):
        if fault_write is not None:
            fault_write()
        if images_io.is_raw(cfg.output_path):
            distributed.write_sharded(cfg.output_path, out, h, w, ch)
        else:
            images_io.save_image(cfg.output_path, runner.fetch(out))
    _clear_checkpoint(cfg, checkpoint_every, resume)
    return JobResult(
        output_path=cfg.output_path,
        compute_seconds=compute_seconds,
        total_seconds=total_t.elapsed,
        backend=runner.backend,
        mesh_shape=runner.mesh_shape,
        schedule=runner.schedule,
        block_h=sh_bh,
        fuse=sh_fuse,
        launches=_delta(after, before),
        tune_probes=autotune.probe_count - probes_before,
        body=runner.body,
        warmup_launches=warm_launches,
        overlap=runner.overlap,
    )


def _run_frames_multiprocess(cfg: JobConfig, model: IteratedConv2D,
                             devices: List[torch.device], total_t: Timer,
                             probes_before: int = 0,
                             profile_dir: Optional[str] = None,
                             checkpoint_every: int = 0,
                             resume: bool = False) -> JobResult:
    """A ``--frames`` clip across processes: each process owns one
    contiguous frame range (frames never mix, so nothing is exchanged),
    reads and writes only its byte range of the raw files, and batches it
    over its local ``devices`` (a contiguous share each, as one process
    does). The window is max-reduced
    over the processes. Checkpoints use the frames format: every process
    writes its range into one shared versioned data file each chunk
    (:func:`checkpoint.save_frames_sharded`); a process with no frames
    runs the same chunk loop on nothing, so it joins every barrier and
    every commit."""
    from tpu_stencil_torch.io import native
    from tpu_stencil_torch.runtime import checkpoint as ckpt

    if cfg.mesh_shape is not None:
        raise NotImplementedError(
            "--mesh with --frames across processes is not supported: each "
            "process batches its frame range over its local devices")
    p, n_proc = distributed.process_index(), distributed.process_count()
    per = -(-cfg.frames // n_proc)
    f0 = min(cfg.frames, p * per)
    n_local = min(cfg.frames, f0 + per) - f0
    h, w, ch = cfg.height, cfg.width, cfg.channels
    start_rep, imgs = 0, None
    if resume:
        restored = ckpt.restore_frames_sharded(cfg, f0, n_local)
        if restored is not None:
            start_rep, imgs = restored
    calls = _window_calls(cfg.repetitions - start_rep, checkpoint_every,
                          obs.enabled())
    timeout_s = _deadline.resolve(cfg.dispatch_timeout_s)

    def save_fn(rep, x):
        ckpt.save_frames_sharded(cfg, rep, None if x is None
                                 else engine.fetch(x), f0)

    out, launches, warm_launches = None, {}, {}
    run_devices = devices[:max(1, min(len(devices), n_local))]
    if n_local:
        if imgs is None:
            fault_read = _faults.site("read")
            with obs.phase("load"):
                if fault_read is not None:
                    fault_read()
                imgs = raw_io.read_raw_rows(cfg.image, f0 * h, n_local * h,
                                            w, ch).reshape(n_local, h, w, ch)
                if ch == 1:
                    imgs = imgs[..., 0]
        engine = prepare_engine(model, imgs, frames=n_local, calls=calls,
                                timeout_s=timeout_s, devices=run_devices)
        warm_launches = engine.warm_launches
        before = cuda_stencil.launch_counts()
        with _maybe_profile(profile_dir, run_devices):
            with obs.phase("iterate", reps=cfg.repetitions):
                out_dev, compute = _checkpointed_iterate(
                    cfg, engine.step_fn, save_fn, engine.img_dev,
                    checkpoint_every, start_rep, run_devices,
                    fault=_faults.site("compute"), timeout_s=timeout_s,
                )
        launches = _delta(cuda_stencil.launch_counts(), before)
        with obs.phase("fetch"):
            out = engine.fetch(out_dev)
        _record_device_memory(model.device)
    else:
        _checkpointed_iterate(cfg, lambda x, n: x, save_fn, None,
                              checkpoint_every, start_rep, [])
        compute = 0.0
    compute_seconds = max_across_processes(compute)
    fault_write = _faults.site("write")
    with obs.phase("store"):
        if fault_write is not None:
            fault_write()
        native.set_size(cfg.output_path, cfg.frames * h * w * ch)
        if n_local:
            raw_io.write_raw_block(cfg.output_path, f0 * h, 0,
                                   out.reshape((n_local * h,) + out.shape[2:]),
                                   w, ch, cfg.frames * h)
    _clear_checkpoint(cfg, checkpoint_every, resume)
    backend, schedule = model.batch_config((h, w), ch)
    bh, fz, body = None, None, None
    if backend == "pallas":
        n_share = _share(n_local or per, len(run_devices))
        bh, fz, body = _ran_launch(model, (h, w), ch, n_share, schedule,
                                   cfg.repetitions)
    return JobResult(
        output_path=cfg.output_path,
        compute_seconds=compute_seconds,
        total_seconds=total_t.elapsed,
        backend=backend,
        mesh_shape=None,
        schedule=schedule,
        block_h=bh,
        fuse=fz,
        launches=launches,
        tune_probes=autotune.probe_count - probes_before,
        body=body,
        warmup_launches=warm_launches,
    )
