"""Benchmark sweep harness: the reference's table grid, on the GPU.

The port's counterpart of the JAX package's ``runtime/bench_sweep.py``:
the sweep the reference's authors ran by hand (BASELINE.md: 4 image sizes
x {grey, rgb}, 40 reps) plus wider filters and an 8K x 1000-rep stress
row. Emits one markdown table (and optional CSV) with the measured
per-rep times, the share of the card's bound
(:func:`tpu_stencil_torch.runtime.roofline.bound_ms_per_rep` over the
measured time: integer operations bind this stencil on an H100, not
bytes), the achieved device-memory bandwidth of the traffic model, and the
speedup over the reference's published GTX-970 number where one exists.
Every row's configuration is also held byte for byte against the torch-ops
lowering (``exact``).

Timing: steady-state two-point differencing (autotune's
``_steady_state_per_rep``), each run fenced with a synchronize, under the
shared retry policy. ``--pipe-stages K`` adds the temporal pipeline's row
(``xla:pipeK``): steady-state seconds per frame-rep through K stages on
``[device] * K`` (the fill outside the timer), its finished frame held
against the torch-ops path.

Usage:
    python -m tpu_stencil_torch.runtime.bench_sweep [--quick] [--stress]
        [--csv out.csv] [--filters gaussian,gaussian5,gaussian7]
        [--backends xla,pallas,auto] [--frames N] [--pipe-stages K]
        [--platform cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

# Reference numbers (BASELINE.md): CUDA GTX-970 whole-program seconds at 40
# reps.
_CUDA_40REPS = {
    ("grey", 630): 0.076, ("grey", 1260): 0.116,
    ("grey", 2520): 0.172, ("grey", 5040): 0.189,
    ("rgb", 630): 0.307, ("rgb", 1260): 0.537,
    ("rgb", 2520): 1.017, ("rgb", 5040): 1.837,
}

SIZES = (630, 1260, 2520, 5040)
WIDTH = 1920
_CHECK_REPS = 9  # reps of each row's exactness check


def _model(filter_name: str, backend: str, device):
    from tpu_stencil_torch.models.blur import IteratedConv2D

    return IteratedConv2D(filter_name, backend=backend, device=device)


def _timed(fn, device):
    from tpu_stencil_torch.utils.timing import fence

    def timed(n_reps: int) -> float:
        fence(device)
        t0 = time.perf_counter()
        fn(n_reps)
        fence(device)
        return time.perf_counter() - t0

    return timed


def _steady(timed, budget_s: float, probe_reps: int, floor: int) -> float:
    """Steady-state seconds per rep with N scaled so that each timed run
    lasts about ``budget_s`` on the device."""
    from tpu_stencil_torch.runtime.autotune import _steady_state_per_rep

    timed(1)  # first-launch fence
    est = max(timed(probe_reps) / probe_reps, 1e-8)
    lo = min(max(int(budget_s / est), floor), 50_000)
    return _steady_state_per_rep(timed, lo)


def _measure_per_rep(img: np.ndarray, filter_name: str, budget_s: float,
                     backend: str, device, probe_reps: int = 500):
    """Returns ``(per_rep_s, resolved_backend, schedule, block_h, fuse,
    exact)``. ``auto``/``autotune`` rows resolve through the model (the
    default path: tuned backend, schedule and geometry per shape,
    disk-cached) and the sweep then times exactly that configuration, so
    an auto row is what a bare-CLI user measures; an explicit backend runs
    the module defaults."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    model = _model(filter_name, backend, device)
    shape2 = tuple(img.shape[:2])
    ch = img.shape[2] if img.ndim == 3 else 1
    model.prepare(shape2, ch)
    resolved, sched = model.resolved_config(shape2, ch)
    bh, fz = model.resolved_geometry(shape2, ch)
    dev_img = torch.from_numpy(img).to(device)

    def run(n):
        if resolved == "pallas":
            return cs.iterate(dev_img, n, model.plan, block_h=bh, fuse=fz,
                              schedule=sched)
        return lowering.iterate(dev_img, n, model.plan)

    exact = bool(torch.equal(
        run(_CHECK_REPS), lowering.iterate(dev_img, _CHECK_REPS, model.plan)))
    per = _steady(_timed(run, device), budget_s, probe_reps, 200)
    return per, resolved, sched, bh, fz, exact


def _measure_batch_per_frame_rep(imgs: np.ndarray, filter_name: str,
                                 budget_s: float, backend: str, device,
                                 probe_reps: int = 100):
    """Steady-state seconds per frame-repetition of the batch mode
    (``--frames``): ``xla`` runs the torch-ops step over the clip,
    ``pallas`` the tall-image kernel launch
    (``cuda_stencil.iterate_frames``), ``auto`` what the model's batch
    path resolves. Returns ``(per_frame_rep_s, resolved_backend, schedule,
    block_h, fuse, exact)``."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    model = _model(filter_name, backend, device)
    frame_shape = tuple(imgs.shape[1:3])
    ch = imgs.shape[3] if imgs.ndim == 4 else 1
    model.prepare(frame_shape, ch)
    resolved, sched = model.batch_config(frame_shape, ch)
    bh, fz = model.resolved_geometry(frame_shape, ch)
    dev = torch.from_numpy(imgs).to(device)

    def run(n):
        if resolved == "pallas":
            return cs.iterate_frames(dev, n, model.plan, block_h=bh,
                                     fuse=fz, schedule=sched)
        return lowering.iterate_frames(dev, n, model.plan)

    exact = bool(torch.equal(
        run(_CHECK_REPS),
        lowering.iterate_frames(dev, _CHECK_REPS, model.plan)))
    per = _steady(_timed(run, device), budget_s, probe_reps, 100)
    return per / imgs.shape[0], resolved, sched, bh, fz, exact


def _measure_pipe_per_frame_rep(img: np.ndarray, filter_name: str,
                                stages: int, budget_s: float, device,
                                reps: int = 40):
    """Steady-state seconds per frame-rep through a K-stage temporal
    pipeline over ``[device] * stages``: the same frame fed every tick,
    each steady tick finishing one frame of ``reps`` reps. The fill ticks
    run before the timer starts. Returns ``(per_frame_rep_s, "xla", None,
    None, None, exact)``: the finished frame against the torch-ops path."""
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.parallel.pipeline import PipelineRunner
    from tpu_stencil_torch.utils.timing import fence

    model = _model(filter_name, "xla", device)
    ch = img.shape[2] if img.ndim == 3 else 1
    runner = PipelineRunner(model, tuple(img.shape[:2]), ch, stages,
                            devices=[device] * stages)
    dev_img = torch.from_numpy(img).to(device)
    inp = runner.assemble_input([dev_img])
    carry = runner.warm(reps)
    for _ in range(stages):  # the fill: every stage holds the frame
        carry, out = runner.tick(carry, inp, reps)
    exact = bool(torch.equal(out[0][0],
                             lowering.iterate(dev_img, reps, model.plan)))
    fence(device)
    n = 0
    t0 = time.perf_counter()
    while True:
        carry, out = runner.tick(carry, inp, reps)
        fence(device)
        n += 1
        if n >= 3 and time.perf_counter() - t0 > budget_s:
            break
    return (time.perf_counter() - t0) / n / reps, "xla", None, None, None, \
        exact


def _with_retries(measure_fn, label: str, retries: int = 2):
    """Run one measurement under the shared retry policy
    (:mod:`tpu_stencil_torch.resilience.retry`): a transient failure
    (device memory held by a neighbour for a moment) must not kill a long
    sweep, while deterministic failures (capability guards, validation
    errors, a kernel that does not build or launch) can never succeed on
    retry and fail at once."""
    from tpu_stencil_torch.resilience import retry as _retry

    def on_retry(attempt, e):
        print(f"row {label} attempt {attempt} failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    return _retry.retry_call(
        measure_fn,
        policy=_retry.RetryPolicy(attempts=retries + 1, base_delay=15.0,
                                  multiplier=2.0, max_delay=120.0),
        on_retry=on_retry,
    )


def _label(backend: str, resolved: str, sched, bh, fz) -> str:
    """The row's backend label: what ran, with the schedule and any
    non-default geometry."""
    if resolved != "pallas":
        name = resolved
    else:
        name = f"pallas[{sched}]"
        if bh is not None:
            name += f"@{bh}x{fz}"
        elif fz is not None:
            name += f"@fuse{fz}"
    return f"auto:{name}" if backend in ("auto", "autotune") else name


def _make_row(filter_name, mode, size_label, backend, measured, frame_bytes,
              n_elems, h_img, w_img, channels, reps, base, n_frames=1):
    from tpu_stencil_torch.runtime import roofline
    from tpu_stencil_torch.models.blur import IteratedConv2D

    per_rep, resolved, sched, bh, fz, exact = measured
    plan = IteratedConv2D(filter_name, device="cpu").plan
    gbps, pct = roofline.achieved(
        frame_bytes, per_rep, resolved, filter_name, h_img, block_h=bh,
        fuse=fz, schedule=sched, w_img=w_img, channels=channels, reps=reps)
    bound_ms, by = roofline.bound_ms_per_rep(plan, n_elems, reps)
    total = per_rep * reps * n_frames
    return {
        "filter": filter_name, "mode": mode, "size": size_label,
        "backend": _label(backend, resolved, sched, bh, fz),
        "us_per_rep": round(per_rep * 1e6, 2),
        "bound_us_per_rep": round(bound_ms * 1e3, 3),
        "bound_by": by,
        "pct_of_bound": round(100 * bound_ms / (per_rep * 1e3), 1),
        "reps": reps,
        "total_s": round(total, 6),
        "hbm_gbps": round(gbps, 1),
        "pct_hbm_peak": round(pct, 2),
        "gtx970_40reps_s": base,
        "speedup_vs_gtx970": round(base / total, 1) if base else None,
        "exact": exact,
    }


def run_sweep(
    quick: bool = False,
    stress: bool = False,
    filters: Optional[List[str]] = None,
    csv_path: Optional[str] = None,
    backends: Optional[List[str]] = None,
    frames: int = 0,
    device=None,
    sizes=None,
    width: int = WIDTH,
    pipe_stages: int = 1,
) -> List[dict]:
    """Measure the grid on ``device`` (default: the first CUDA device,
    raising without one). ``sizes``/``width`` shrink the grid for a
    rehearsal on the CPU."""
    from tpu_stencil_torch.devices import resolve_device

    device = resolve_device() if device is None else torch.device(device)
    filters = filters or ["gaussian"]
    backends = backends or ["xla"]
    rng = np.random.default_rng(0)
    budget_s = 0.1 if quick else 0.5
    rows = []
    writer = _IncrementalCsv(csv_path)
    if sizes is None:
        sizes = SIZES[:2] if quick else SIZES
    small = device.type != "cuda"
    probe = 4 if small else 500

    def add(row):
        rows.append(row)
        writer.write(row)
        print(_fmt_row(row), file=sys.stderr, flush=True)

    for backend in backends:
        for filter_name in filters:
            for mode in ("grey", "rgb"):
                ch = 1 if mode == "grey" else 3
                for h in sizes:
                    shape = (h, width) if ch == 1 else (h, width, 3)
                    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
                    base = (
                        _CUDA_40REPS.get((mode, h))
                        if filter_name == "gaussian" and width == WIDTH
                        else None
                    )
                    label = f"{width}x{h}"
                    measured = _with_retries(
                        lambda: _measure_per_rep(img, filter_name, budget_s,
                                                 backend, device, probe),
                        f"{label} [{backend}]")
                    add(_make_row(filter_name, mode, label, backend,
                                  measured, img.nbytes, img.size, h, width,
                                  ch, 40, base))
        if stress:
            img = rng.integers(0, 256, size=(4320, 7680, 3), dtype=np.uint8)
            measured = _with_retries(
                lambda: _measure_per_rep(img, "gaussian", budget_s * 4,
                                         backend, device, probe),
                f"8K [{backend}]")
            add(_make_row("gaussian", "rgb", "7680x4320 (8K)", backend,
                          measured, img.nbytes, img.size, 4320, 7680, 3,
                          1000, None))
    if frames:
        fh = sizes[-1] if small else 2520
        imgs = rng.integers(0, 256, size=(frames, fh, width, 3),
                            dtype=np.uint8)
        base = _CUDA_40REPS.get(("rgb", fh)) if width == WIDTH else None
        for backend in backends:
            measured = _with_retries(
                lambda: _measure_batch_per_frame_rep(
                    imgs, "gaussian", budget_s, backend, device,
                    4 if small else 100),
                f"x{frames} frames [{backend}]")
            add(_make_row("gaussian", "rgb",
                          f"{width}x{fh} x{frames} frames", backend,
                          measured, imgs.nbytes // frames,
                          imgs.size // frames, fh, width, 3, 40,
                          base * frames if base else None, n_frames=frames))
    if pipe_stages > 1:
        fh = sizes[-1] if small else 2520
        img = rng.integers(0, 256, size=(fh, width, 3), dtype=np.uint8)
        base = _CUDA_40REPS.get(("rgb", fh)) if width == WIDTH else None
        measured = _with_retries(
            lambda: _measure_pipe_per_frame_rep(img, "gaussian", pipe_stages,
                                                budget_s, device),
            f"pipe{pipe_stages} [xla]")
        row = _make_row("gaussian", "rgb", f"{width}x{fh} pipe{pipe_stages}",
                        "xla", measured, img.nbytes, img.size, fh, width, 3,
                        40, base)
        add({**row, "backend": f"xla:pipe{pipe_stages}"})
    return rows


class _IncrementalCsv:
    """Append each row as it is measured; a crash loses nothing."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self._writer = None
        self._file = None

    def write(self, row: dict) -> None:
        if not self.path:
            return
        import csv

        if self._writer is None:
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file,
                                          fieldnames=list(row.keys()))
            self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()


def _fmt_row(r: dict) -> str:
    sp = f"{r['speedup_vs_gtx970']}x" if r["speedup_vs_gtx970"] else "-"
    return (f"{r['filter']:>10} {r['mode']:>4} {r['size']:>12} "
            f"[{r['backend']}]: {r['us_per_rep']:>8} us/rep, "
            f"{r['pct_of_bound']}% of the {r['bound_by']} bound, "
            f"{r['hbm_gbps']:>6} GB/s ({r['pct_hbm_peak']}% peak), "
            f"{r['reps']} reps = {r['total_s']:.4f} s, vs GTX-970 {sp}, "
            f"exact={r['exact']}")


def emit_markdown(rows: List[dict]) -> str:
    lines = [
        "| filter | mode | size | backend | us/rep | bound us/rep | % of "
        "bound | HBM GB/s | % peak | reps | total (s) | GTX-970 40 reps (s) "
        "| speedup | exact |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        sp = (str(r["speedup_vs_gtx970"]) + "x"
              if r["speedup_vs_gtx970"] else "-")
        lines.append(
            f"| {r['filter']} | {r['mode']} | {r['size']} | {r['backend']} "
            f"| {r['us_per_rep']} | {r['bound_us_per_rep']} "
            f"({r['bound_by']}) | {r['pct_of_bound']} | {r['hbm_gbps']} "
            f"| {r['pct_hbm_peak']} | {r['reps']} | {r['total_s']} "
            f"| {r['gtx970_40reps_s'] or '-'} | {sp} | {r['exact']} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    from tpu_stencil_torch.devices import NoDeviceError, resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="2 sizes, short runs")
    p.add_argument("--stress", action="store_true",
                   help="add the 8K x1000 config")
    p.add_argument("--csv", default=None, help="also write CSV here")
    p.add_argument("--filters", default="gaussian",
                   help="comma-separated filter names (default gaussian)")
    p.add_argument("--backends", default="xla",
                   help="comma-separated backends to sweep "
                        "(xla,pallas,auto)")
    p.add_argument("--frames", type=int, default=0, metavar="N",
                   help="also measure the batch mode with N frames of the "
                        "reference size, one row per swept backend; reports "
                        "us per frame*rep")
    p.add_argument("--pipe-stages", type=int, default=1, metavar="K",
                   help="also measure the K-stage temporal pipeline at the "
                        "reference size on K copies of the device (us per "
                        "frame*rep, steady state)")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="cpu rehearses on torch ops and the kernels' plain "
                        "versions (use --sizes/--width to keep it small); "
                        "default runs on the first CUDA device and fails "
                        "without one")
    p.add_argument("--sizes", default=None,
                   help="comma-separated image heights (default "
                        f"{','.join(map(str, SIZES))}; --quick the first two)")
    p.add_argument("--width", type=int, default=WIDTH,
                   help=f"image width (default {WIDTH})")
    ns = p.parse_args(argv)
    try:
        device = resolve_device(ns.platform)
    except NoDeviceError as e:
        print(f"bench_sweep: error: {e}", file=sys.stderr)
        return 2
    rows = run_sweep(
        quick=ns.quick, stress=ns.stress,
        filters=ns.filters.split(","), csv_path=ns.csv,
        backends=ns.backends.split(","), frames=ns.frames, device=device,
        sizes=[int(v) for v in ns.sizes.split(",")] if ns.sizes else None,
        width=ns.width, pipe_stages=ns.pipe_stages,
    )
    print(emit_markdown(rows))
    bad = [r for r in rows if not r["exact"]]
    if bad:
        print(f"NOT EXACT: {len(bad)} row(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
