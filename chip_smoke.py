#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpu_stencil_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every hand-written kernel and every lab variant from
``tpu_stencil_torch/ops/csrc/`` (one ``nvcc`` per library, all started
together, into ``build/kernels/``), points the autotune cache at
``build/chip_smoke/autotune.json``, then runs these phases, each printing
one JSON line. The phases that pin launch counts name ``--backend pallas``
(K1 at its default geometry); ``autotune_path`` drives the default
``auto``/``autotune`` resolution.

1. ``device`` — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, SM count and L2 size.
2. ``divide`` — the torch-ops float32 divide on the card is correctly
   rounded over every accumulator of the box and edge plans.
3. ``k1`` — K1 ``stencil_fused`` against its plain version, byte for byte,
   at 1920x2520 RGB gaussian x{1,7,8,9,40}, grey gaussian x40, box and
   edge RGB x9 (the float32 divide), gaussian5 RGB x9, and
   ``iterate_frames`` on 3 frames of 256x320 RGB x9; plus small images
   against the NumPy golden model.
4. ``k2`` — K2 ``stencil_resident`` against its plain version at
   1920x2520 RGB x40 ``deep`` (one K2 launch, no K1 launch), the same
   for box, edge, gaussian5, grey and 3 frames, and a deep run past the
   L2 budget (7680x4320 RGB x8) that must run K1.
5. ``main_path`` — the CLI on a seeded 1920x2520 RGB raw file, x40,
   default schedule and ``--schedule deep``: cold, as
   ``python -m tpu_stencil_torch`` in a fresh process (its ``--time``
   line gives the launches), and warm, as ``tpu_stencil_torch.cli.main``
   in this process with the launch counters set to 0 just before each run
   and read just after; the bytes written must equal the torch-ops path
   on the card.
6. ``k3`` — K3 ``stencil_valid`` against its plain version, byte for
   byte, on the ghost-extended tiles of every shard position of a 2x2
   grid over a seeded 1920x2520 RGB image (corner, edge and interior
   global origins), at fuse 1 and 8 for gaussian, box, edge and
   gaussian5, grey gaussian at fuse 8, and a direct-int plan that shifts.
7. ``sharded_path`` — the sharded runner on ``devices=[cuda:0] * R*C`` at
   1920x2520 RGB gaussian x40 for meshes 1x1, 2x2, 1x4 and 4x1, each
   byte-equal to K1's ``iterate`` and to the torch-ops path, with
   ``(reps // fuse + reps % fuse) * R*C`` K3 launches; the indivisible
   1921x2519 RGB image at 2x2 x9 (the pad mask, fuse 1) and gaussian5 at
   2x2 x9; the CLI with ``--mesh 1x1``, cold and warm; and
   ``driver.run_job`` with mesh 2x2 over ``[cuda:0] * 4`` writing the
   file.
8. ``l2`` — L2 ``stencil_lab``: every exact variant (``current``,
   ``pair``, ``acc16``, ``swar``) against its plain version and against
   K1's bytes at 1920x2520 RGB gaussian, fuse 8 at 32 rows and fuse 4 at
   64 rows, plus gaussian5 and grey; the host's shared-memory model
   against the library's own; then the kernel lab tool
   (``tpu_stencil_torch.tools.kernel_lab``) over its whole table with the
   launch counter set to 0 just before, and the timing table of all
   variants and ablations (ms per rep x40, interleaved, median of 7, L2
   flushed) with ``current / shipped``.
9. ``l1`` — L1 ``op_chain``: every case at a chain of 3 (where no case's
   output is constant, which is checked) and at both timed chains, 8 and
   16, against its plain version (byte-equal; float cases within 1),
   through the op cost tool (``tpu_stencil_torch.tools.op_cost``), which
   then gives us per op-pass per case.
10. ``autotune_path`` — ``python -m tpu_stencil_torch IMG 1920 2520 40
   rgb --backend autotune --time`` in a fresh process with an empty cache
   file: it measures, writes the cache and reports the verdict, and its
   bytes equal the torch-ops path; a second run (``cli.main`` here) makes
   zero probes by the autotuner's own counter and launches what the
   verdict says; the same through ``run_job`` on a 2x2 mesh over
   ``[cuda:0] * 4``; then ``bh_fuse_ab`` and a ``--quick`` benchmark
   sweep run to the end with every row exact.
11. ``times`` — ms per rep at 1920x2520 RGB gaussian x40, each the median
   of 7 runs after a warm-up (CUDA events, L2 flushed before each run):
   the three job kernels (K3 alone on the one ext tile of a 1x1 mesh at
   fuse 8), L2's ``current`` body, one L1 launch (``add_i32``, chain of
   8), the whole 2x2 sharded runner under ``pallas`` and under ``auto``
   taking turns (``auto`` must not chunk shallower nor take 1.5x the
   time), their plain versions, the torch-ops path, and one depthwise float32 ``F.conv2d`` rep (TF32 off) as the
   library yardstick, which the port never calls; and each kernel's
   bound.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before that line; without a CUDA device the script exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# The bounds (bytes over the card's memory rate, operations over its int32
# and float32 rates) come from tpu_stencil_torch.runtime.roofline, which
# the lab, the sweep and the autotuner's reports read as well.

MAIN_W, MAIN_H, MAIN_C, MAIN_REPS = 1920, 2520, 3, 40
BIG_W, BIG_H = 7680, 4320  # 2 x 99.5 MB: past the L2 budget
FRAMES_SHAPE = (3, 320, 256, 3)
ODD_W, ODD_H = 1921, 2519  # indivisible by a 2x2 grid: the pad mask
MESHES = ((1, 1), (2, 2), (1, 4), (4, 1))
NO_LAUNCHES = {"stencil_fused": 0, "stencil_resident": 0, "stencil_valid": 0}
PALLAS = ["--backend", "pallas"]  # pins K1/K2/K3 at the default geometry
LAB_EXACT = ("current", "pair", "acc16", "swar")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed ({r.returncode}): {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def seeded(shape, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def plan_of(name: str):
    """The plan of a named filter; 'direct16' is a non-separable filter
    with a power-of-two divisor (a direct-int plan that shifts)."""
    from tpu_stencil_torch import filters
    from tpu_stencil_torch.ops import lowering

    if name == "direct16":
        return lowering.plan_filter(filters.from_numpy(
            np.array([[1, 1, 1], [1, 8, 1], [1, 1, 1]]), 16))
    return lowering.plan_filter(filters.get_filter(name))


def launches(**counts) -> dict:
    return {**NO_LAUNCHES, **counts}


def flat_plain(img: torch.Tensor, plan, reps: int) -> torch.Tensor:
    """The plain version of ``reps`` reps of an (H, W[, C]) image."""
    from tpu_stencil_torch.ops import cuda_stencil

    c = img.shape[2] if img.dim() == 3 else 1
    x2 = img.reshape(img.shape[0], -1)
    return cuda_stencil.stencil_fused_plain(x2, plan, c, reps).reshape(img.shape)


def phase_k1(dev) -> dict:
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops.stencil import reference_stencil_numpy
    from tpu_stencil_torch import filters

    worst, cases = 0, []
    rgb = seeded((MAIN_H, MAIN_W, 3), 1, dev)
    grey = seeded((MAIN_H, MAIN_W), 2, dev)
    g = plan_of("gaussian")
    # One launch of the wrapper at the main path's shapes, fused and single.
    x2 = rgb.reshape(MAIN_H, -1)
    bh, fz = cs.effective_geometry(g, MAIN_H, 3)
    for depth in (fz, 1):
        out = cs.stencil_fused(x2, g, 3, depth, block_h=bh)
        err = max_err(out, cs.stencil_fused_plain(x2, g, 3, depth))
        worst = max(worst, err)
        cases.append({"case": f"wrapper rgb gaussian fuse={depth}", "err": err})
    runs = [(rgb, "gaussian", r) for r in (1, 7, 8, 9, 40)]
    runs += [(grey, "gaussian", 40), (rgb, "box", 9), (rgb, "edge", 9),
             (rgb, "gaussian5", 9)]
    for img, name, reps in runs:
        p = plan_of(name)
        err = max_err(cs.iterate(img, reps, p), flat_plain(img, p, reps))
        worst = max(worst, err)
        cases.append({"case": f"{tuple(img.shape)} {name} x{reps}", "err": err})
    frames = seeded(FRAMES_SHAPE, 3, dev)
    out = cs.iterate_frames(frames, 9, g)
    want = torch.stack([flat_plain(f, g, 9) for f in frames])
    err = max_err(out, want)
    worst = max(worst, err)
    cases.append({"case": f"frames {FRAMES_SHAPE} gaussian x9", "err": err})
    # Small images against the pure-NumPy golden model (K1 and K2).
    small = np.random.default_rng(4).integers(0, 256, (21, 17, 3), np.uint8)
    for name in ("gaussian", "box", "edge", "gaussian5"):
        want = reference_stencil_numpy(small, filters.get_filter(name), 3)
        for sched in (None, "deep"):
            got = cs.iterate(torch.from_numpy(small).to(dev), 3, plan_of(name),
                             schedule=sched).cpu().numpy()
            err = int(np.abs(got.astype(int) - want.astype(int)).max())
            worst = max(worst, err)
            cases.append({"case": f"golden {name} x3 schedule={sched}",
                          "err": err})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["err"]]
    require(not bad, f"K1 disagrees with its plain version: {bad}")
    return {"phase": "k1", "ok": True, "cases": len(cases),
            "max_abs_err": worst}


def phase_divide(dev) -> dict:
    """The torch-ops paths' float32 divide on the card, against NumPy's
    correctly rounded divide, over every accumulator the box (/9) and edge
    (/28) plans can produce. Division by a host scalar is counted beside it
    (PyTorch multiplies by the reciprocal there); the port never uses it."""
    from tpu_stencil_torch.ops import lowering

    out = {}
    for d in (9.0, 28.0):
        acc = np.arange(0, 255 * int(d) + 1, dtype=np.float32)
        want = acc / np.float32(d)
        t = torch.from_numpy(acc).to(dev)
        port = lowering.divide_f32(t, d).cpu().numpy()
        host = (t / d).cpu().numpy()
        out[str(int(d))] = {"values": int(acc.size),
                            "port_mismatches": int((port != want).sum()),
                            "host_scalar_mismatches": int((host != want).sum())}
        require(out[str(int(d))]["port_mismatches"] == 0,
                f"divide_f32 by {d} is not correctly rounded on the card")
    return {"phase": "divide", "ok": True, "divisors": out}


def phase_k2(dev) -> dict:
    from tpu_stencil_torch.ops import cuda_stencil as cs

    g = plan_of("gaussian")
    rgb = seeded((MAIN_H, MAIN_W, 3), 1, dev)
    x2 = rgb.reshape(MAIN_H, -1)
    require(cs.resident_feasible(g, MAIN_H, MAIN_W * 3, 3, dev),
            "K2 must be feasible at 1920x2520 RGB")
    out = cs.stencil_resident(x2, g, 3, MAIN_REPS)
    err = max_err(out, cs.stencil_resident_plain(x2, g, 3, MAIN_REPS))
    cs.reset_launch_counts()
    deep = cs.iterate(rgb, MAIN_REPS, g, schedule="deep")
    counts = cs.launch_counts()
    require(counts == launches(stencil_resident=1),
            f"deep at 1920x2520 must be one K2 launch, got {counts}")
    err = max(err, max_err(deep, flat_plain(rgb, g, MAIN_REPS)))
    # The other plans (divide, direct, wide halo), grey, and frames.
    grey = seeded((MAIN_H, MAIN_W), 2, dev)
    frames = seeded(FRAMES_SHAPE, 3, dev)
    for img, name, reps in ((rgb, "box", 9), (rgb, "edge", 9),
                            (rgb, "gaussian5", 9), (grey, "gaussian", 40),
                            (frames, "gaussian", 9)):
        p = plan_of(name)
        cs.reset_launch_counts()
        if img is frames:
            got = cs.iterate_frames(img, reps, p, schedule="deep")
            want = torch.stack([flat_plain(f, p, reps) for f in img])
        else:
            got = cs.iterate(img, reps, p, schedule="deep")
            want = flat_plain(img, p, reps)
        counts = cs.launch_counts()
        require(counts == launches(stencil_resident=1),
                f"deep {name} {tuple(img.shape)}: launches {counts}")
        err = max(err, max_err(got, want))
    require(err == 0, f"K2 disagrees with its plain version (max {err})")
    # Past the L2 budget 'deep' runs K1 at the deep depth.
    big = seeded((BIG_H, BIG_W, 3), 5, dev)
    require(not cs.resident_feasible(g, BIG_H, BIG_W * 3, 3, dev),
            f"{BIG_W}x{BIG_H} RGB must not fit the L2 budget")
    geo = cs.deep_geometry(g, BIG_H, BIG_W, 3, device=dev)
    cs.reset_launch_counts()
    out = cs.iterate(big, 8, g, schedule="deep")
    counts = cs.launch_counts()
    want_k1 = len(cs.launch_schedule(8, geo[1]))
    require(counts == launches(stencil_fused=want_k1),
            f"deep past L2 must run K1 x{want_k1}, got {counts}")
    big_err = max_err(out, flat_plain(big, g, 8))
    require(big_err == 0, f"deep K1 path disagrees (max {big_err})")
    return {"phase": "k2", "ok": True, "max_abs_err": err,
            "past_l2": {"shape": [BIG_H, BIG_W, 3], "reps": 8,
                        "geometry": list(geo), "launches": counts,
                        "max_abs_err": big_err}}


def run_cli(args) -> tuple:
    """cli.main with the launch counters set to 0 just before it and read
    just after; returns (stdout lines, counts)."""
    from tpu_stencil_torch import cli
    from tpu_stencil_torch.ops import cuda_stencil as cs

    buf = io.StringIO()
    cs.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    counts = cs.launch_counts()
    require(rc == 0, f"cli.main{tuple(args)} returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(line, flush=True)
    return lines, counts


def parse_launches(report: str) -> dict:
    """The launch counts of a ``--time`` line's ``launches=`` field."""
    field = report.rsplit("launches=", 1)[1].split()[0]
    return {k: int(v) for k, v in (kv.split(":") for kv in field.split(","))}


def run_cli_cold(args, env=None) -> tuple:
    """``python -m tpu_stencil_torch`` in a fresh process, as a user runs
    it: the compute window includes the first launch of each kernel
    (module load, shared-memory attribute). Returns (stdout lines, counts
    parsed from the ``--time`` line's ``launches=``)."""
    r = subprocess.run([sys.executable, "-m", "tpu_stencil_torch", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=env)
    require(r.returncode == 0,
            f"python -m tpu_stencil_torch exited {r.returncode}: {r.stderr}")
    lines = r.stdout.strip().splitlines()
    for line in lines:
        print(line, flush=True)
    return lines, parse_launches(lines[1])


def main_raw() -> tuple:
    """The seeded 1920x2520 RGB raw file of the main path: (path, image)."""
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "waterfall_1920_2520.raw"
    img = np.random.default_rng(6).integers(
        0, 256, (MAIN_H, MAIN_W, MAIN_C), np.uint8)
    img.tofile(src)
    return src, img


def phase_main_path(dev) -> dict:
    """The reference job through the CLI, default schedule (K1) and
    ``--schedule deep`` (K2): once in a fresh process (cold: the job a
    user runs) and once in this process with the launch counters set to 0
    just before and read just after (warm: the kernels were launched by
    the earlier phases)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    src, img = main_raw()
    g = plan_of("gaussian")
    want = lowering.iterate(torch.from_numpy(img).to(dev), MAIN_REPS,
                            g).cpu().numpy()
    fuse = cs.effective_geometry(g, MAIN_H, MAIN_C)[1]
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", *PALLAS]
    out = {}
    for label, extra, expect in (
        ("default", [], launches(
            stencil_fused=MAIN_REPS // fuse + MAIN_REPS % fuse)),
        ("deep", ["--schedule", "deep"], launches(stencil_resident=1)),
    ):
        for temp, runner in (("cold", run_cli_cold), ("warm", run_cli)):
            dst = WORK / f"blur_{label}_{temp}.raw"
            lines, counts = runner(base + extra + ["--output", str(dst)])
            require(counts == expect, f"main path {label} {temp}: launches "
                    f"{counts}, expected {expect}")
            got = np.fromfile(dst, np.uint8).reshape(img.shape)
            err = int(np.abs(got.astype(int) - want.astype(int)).max())
            require(err == 0,
                    f"main path {label} {temp} disagrees with torch ops ({err})")
            secs = float(lines[0].split()[2])
            require(np.isfinite(secs) and secs > 0, f"bad time line {lines[0]}")
            out[f"{label}_{temp}"] = {"launches": counts, "max_abs_err": err,
                                      "execution_time_s": secs,
                                      "report": lines[1]}
    return {"phase": "main_path", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "runs": out}


def ext_tile(img: torch.Tensor, i: int, j: int, grid, g: int) -> torch.Tensor:
    """The flat ghost-extended tile (i, j) of ``img`` (H, W[, C]) on an R x C
    grid with ``g`` ghosts per side, zeros past the image: what the zero
    boundary halo exchange hands K3."""
    th, tw = img.shape[0] // grid[0], img.shape[1] // grid[1]
    pad = [0, 0] * (img.dim() - 2) + [g, g, g, g]
    ext = torch.nn.functional.pad(img, pad)[
        i * th:(i + 1) * th + 2 * g, j * tw:(j + 1) * tw + 2 * g]
    return ext.contiguous().reshape(th + 2 * g, -1)


def phase_k3(dev) -> dict:
    """K3 against its plain version at every shard position of a 2x2 grid
    (corner, edge and interior origins all occur: each tile has two image
    edges and two neighbour edges), at the sharded path's shapes."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    rgb = seeded((MAIN_H, MAIN_W, 3), 11, dev)
    grey = seeded((MAIN_H, MAIN_W), 12, dev)
    grid = (2, 2)
    runs = [(rgb, name, fuse) for name in ("gaussian", "box", "edge",
                                           "gaussian5") for fuse in (1, 8)]
    runs += [(grey, "gaussian", 8), (rgb, "direct16", 8)]
    worst, cases = 0, []
    for img, name, fuse in runs:
        p = plan_of(name)
        c = img.shape[2] if img.dim() == 3 else 1
        th, tw = MAIN_H // grid[0], MAIN_W // grid[1]
        glob = (MAIN_H, MAIN_W * c)
        for i in range(grid[0]):
            for j in range(grid[1]):
                ext = ext_tile(img, i, j, grid, fuse * p.halo)
                got = cs.valid_fused(ext, p, fuse, c, i * th, j * tw * c, glob)
                want = cs.stencil_valid_plain(ext, p, c, fuse, i * th,
                                              j * tw * c, glob)
                err = max_err(got, want)
                worst = max(worst, err)
                cases.append({"case": f"{name} C={c} fuse={fuse} tile=({i},{j})",
                              "err": err})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["err"]]
    require(not bad, f"K3 disagrees with its plain version: {bad}")
    return {"phase": "k3", "ok": True, "cases": len(cases),
            "max_abs_err": worst}


def run_runner(img: np.ndarray, name: str, reps: int, mesh, dev) -> tuple:
    """The sharded runner over ``[dev] * R*C``, counters set to 0 just
    before ``run`` and read just after. Returns (output, counts, fuse)."""
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    c = img.shape[2] if img.ndim == 3 else 1
    runner = ShardedRunner(IteratedConv2D(name, backend="pallas", device=dev),
                           img.shape[:2], c, mesh_shape=mesh,
                           devices=[dev] * (mesh[0] * mesh[1]))
    require(runner.backend == "pallas", f"sharded {name} ran {runner.backend}")
    tiles = runner.put(img)
    runner.prepare()
    cs.reset_launch_counts()
    out = runner.run(tiles, reps)
    torch.cuda.synchronize()
    counts = cs.launch_counts()
    return runner.fetch(out), counts, runner.fuse


def phase_sharded_path(dev) -> dict:
    """The sharded path: the runner at every mesh against K1 and the
    torch-ops path, the pad mask, a wide halo, the CLI with --mesh 1x1
    (cold and warm) and run_job over a 2x2 mesh on one card."""
    from tpu_stencil_torch import config, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    src, img = main_raw()
    g = plan_of("gaussian")
    img_dev = torch.from_numpy(img).to(dev)
    want = lowering.iterate(img_dev, MAIN_REPS, g).cpu().numpy()
    k1 = cs.iterate(img_dev, MAIN_REPS, g).cpu().numpy()
    require(np.array_equal(k1, want), "K1 disagrees with torch ops")
    out = {}
    for mesh in MESHES:
        n = mesh[0] * mesh[1]
        got, counts, fuse = run_runner(img, "gaussian", MAIN_REPS, mesh, dev)
        expect = launches(stencil_valid=(MAIN_REPS // fuse + MAIN_REPS % fuse)
                          * n)
        require(counts == expect,
                f"mesh {mesh}: launches {counts}, expected {expect}")
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"mesh {mesh} disagrees with K1 / torch ops ({err})")
        out[f"{mesh[0]}x{mesh[1]}"] = {"fuse": fuse, "launches": counts,
                                      "max_abs_err": err}
    odd = np.random.default_rng(8).integers(0, 256, (ODD_H, ODD_W, 3),
                                            np.uint8)
    for label, im, name, reps, fuse_want in (
            ("mask_1921x2519", odd, "gaussian", 9, 1),
            ("gaussian5", img, "gaussian5", 9, None)):
        got, counts, fuse = run_runner(im, name, reps, (2, 2), dev)
        require(fuse_want is None or fuse == fuse_want,
                f"{label}: fuse {fuse}, expected {fuse_want}")
        expect = launches(stencil_valid=(reps // fuse + reps % fuse) * 4)
        require(counts == expect, f"{label}: launches {counts}, expected "
                f"{expect}")
        ref = lowering.iterate(torch.from_numpy(im).to(dev), reps,
                               plan_of(name)).cpu().numpy()
        err = int(np.abs(got.astype(int) - ref.astype(int)).max())
        require(err == 0, f"{label} disagrees with torch ops ({err})")
        out[label] = {"mesh": [2, 2], "reps": reps, "fuse": fuse,
                      "launches": counts, "max_abs_err": err}
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", "--mesh", "1x1", *PALLAS]
    expect = launches(stencil_valid=MAIN_REPS // cs.DEFAULT_FUSE
                      + MAIN_REPS % cs.DEFAULT_FUSE)
    for temp, runner in (("cold", run_cli_cold), ("warm", run_cli)):
        dst = WORK / f"blur_mesh1x1_{temp}.raw"
        lines, counts = runner(base + ["--output", str(dst)])
        require(counts == expect,
                f"--mesh 1x1 {temp}: launches {counts}, expected {expect}")
        require("mesh=(1, 1)" in lines[1], f"--mesh 1x1 {temp}: {lines[1]}")
        got = np.fromfile(dst, np.uint8).reshape(img.shape)
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"--mesh 1x1 {temp} disagrees with torch ops ({err})")
        out[f"cli_mesh1x1_{temp}"] = {
            "launches": counts, "max_abs_err": err,
            "execution_time_s": float(lines[0].split()[2]),
            "report": lines[1]}
    dst = WORK / "blur_mesh2x2_run_job.raw"
    cfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                           repetitions=MAIN_REPS,
                           image_type=config.ImageType.RGB, mesh_shape=(2, 2),
                           backend="pallas", output=str(dst))
    res = driver.run_job(cfg, devices=[dev] * 4)
    expect = launches(stencil_valid=5 * 4)
    require(res.launches == expect and res.mesh_shape == (2, 2),
            f"run_job 2x2: launches {res.launches} mesh {res.mesh_shape}")
    got = np.fromfile(dst, np.uint8).reshape(img.shape)
    err = int(np.abs(got.astype(int) - want.astype(int)).max())
    require(err == 0, f"run_job 2x2 disagrees with torch ops ({err})")
    out["run_job_mesh2x2"] = {"launches": res.launches, "max_abs_err": err,
                              "compute_seconds": res.compute_seconds}
    worst = max(v["max_abs_err"] for v in out.values())
    return {"phase": "sharded_path", "ok": True, "shape": list(img.shape),
            "reps": MAIN_REPS, "max_abs_err": worst, "runs": out}


def bound_ms_per_rep(plan, n_elems: int, reps: int, n_bytes: int = None):
    from tpu_stencil_torch.runtime import roofline

    return roofline.bound_ms_per_rep(plan, n_elems, reps, n_bytes)


def time_ms(fn, dev, runs: int = 7) -> float:
    """Median ms of ``fn`` over ``runs`` after a warm-up, CUDA events,
    with the L2 flushed (a 256 MB write) before each run."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def interleaved_ms(fns: dict, dev, runs: int = 7) -> dict:
    """Median ms of every ``name -> fn`` over ``runs`` rounds, the
    candidates taking turns within each round (CUDA events, L2 flushed
    before each timed run), after one warm-up each."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(v) for name, v in times.items()}


def phase_l2(dev) -> dict:
    """L2 against its plain versions and K1, the lab tool, the timing
    table."""
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import kernel_lab

    rgb = seeded((MAIN_H, MAIN_W, 3), 21, dev)
    grey = seeded((MAIN_H, MAIN_W), 22, dev)
    worst, cases = 0, []
    for img, fname, geos in ((rgb, "gaussian", ((32, 8), (64, 4), (32, 1))),
                             (rgb, "gaussian5", ((32, 8),)),
                             (grey, "gaussian", ((32, 8),))):
        plan = plan_of(fname)
        c = img.shape[2] if img.dim() == 3 else 1
        x2 = img.reshape(img.shape[0], -1)
        for bh, fz in geos:
            bh, fz = cs.effective_geometry(plan, MAIN_H, c, bh, fz)
            k1 = cs.stencil_fused(x2, plan, c, fz, block_h=bh)
            for name in LAB_EXACT:
                v = lab.parse_variant(name)
                require(lab.variant_supported(v, plan),
                        f"lab variant {name} must run {fname}")
                got = lab.stencil_lab(x2, plan, c, fz, v, block_h=bh)
                err = max(max_err(got, lab.stencil_lab_plain(x2, plan, c, fz,
                                                             v)),
                          max_err(got, k1))
                model = lab.lab_smem_bytes(v, plan, bh, fz, c)
                kern = lab.kernel_smem_bytes(v, plan, bh, fz, c)
                require(model == kern, f"{name} {bh}x{fz}: the host's shared-"
                        f"memory model says {model}, the library {kern}")
                worst = max(worst, err)
                cases.append({"case": f"{fname} C={c} {name} {bh}x{fz}",
                              "err": err})
        # the whole rep loop, fused launches and single-rep remainders
        k1 = cs.iterate(img, 9, plan)
        for name in LAB_EXACT:
            err = max_err(lab.lab_iterate(img, 9, plan,
                                          lab.parse_variant(name)), k1)
            worst = max(worst, err)
            cases.append({"case": f"{fname} C={c} {name} x9", "err": err})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["err"]]
    require(not bad, f"L2 disagrees with its plain version or K1: {bad}")
    # The tool, as a user runs it (in this process: the counter is read).
    buf = io.StringIO()
    lab.reset_launch_counts()
    tool = kernel_lab.run_lab([], dev, reps=400, rounds=1, out=buf)
    tool_launches = lab.launch_counts()["stencil_lab"]
    for line in buf.getvalue().strip().splitlines():
        print(line, flush=True)
    inexact = [n for n, r in tool.items() if r["exact"] is False]
    require(not inexact, f"kernel_lab: not exact: {inexact}")
    require(tool_launches > 0, "kernel_lab launched stencil_lab no time")
    # The timing table: every variant of the tool's table, x40, within
    # this one call, taking turns.
    g = plan_of("gaussian")
    fns = {n: (lambda f=kernel_lab.variant_fn(n, g, rgb)[0]: f(MAIN_REPS))
           for n in kernel_lab.DEFAULT_VARIANTS}
    table = {n: t / MAIN_REPS for n, t in interleaved_ms(fns, dev).items()}
    return {"phase": "l2", "ok": True, "cases": len(cases),
            "max_abs_err": worst, "tool_launches": tool_launches,
            "tool_us_per_rep": {n: r["us_per_rep"] for n, r in tool.items()},
            "ms_per_rep_x40": table,
            "current_over_shipped": table["current"] / table["shipped"]}


def phase_l1(dev) -> dict:
    """L1 against its plain version at the check chain (3: no case's
    output is constant there) and at both timed chains, then the op cost
    tool's table."""
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.tools import op_cost

    buf = io.StringIO()
    lab.reset_launch_counts()
    res = op_cost.run_cases([], dev, reps=100, rounds=3, out=buf)
    tool_launches = lab.launch_counts()["op_chain"]
    torch.cuda.synchronize()
    for line in buf.getvalue().strip().splitlines():
        print(line, flush=True)
    bad = {n: r["max_abs_err"] for n, r in res.items() if not r["exact"]}
    require(not bad, f"L1 disagrees with its plain version: {bad}")
    require(len(res) == len(lab.CASES), "op_cost skipped a case")
    flat = [n for n, r in res.items() if not r["check_varies"]]
    require(not flat, f"L1: the check chain's output is constant for {flat}: "
            "the comparison there could not tell a wrong kernel")
    for case in lab.CASES:
        ib, _, wc, _ = op_cost.tile_for(case)
        model = lab.op_chain_smem_bytes(case, ib, wc)
        kern = lab.op_chain_kernel_smem_bytes(case, ib, wc)
        require(model == kern, f"{case}: the host's shared-memory model "
                f"says {model}, the library {kern}")
    require(tool_launches > 0, "op_cost launched op_chain no time")
    return {"phase": "l1", "ok": True,
            "cases": len(lab.BUILT_N_OPS) * len(res),
            "chains": list(lab.BUILT_N_OPS),
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "tolerance": "0; 1 for mul_add_f32 and mxu_rows_bf16 (float32 "
                         "products)",
            "tool_launches": tool_launches,
            "us_per_op_pass": {n: r["us_per_op_pass"] for n, r in res.items()},
            "chain_us": {n: r["chain_us"] for n, r in res.items()}}


def verdict_launches(report: str, rows: int, reps: int) -> dict:
    """The launches a ``--time`` line's verdict implies for a single
    device job (backend, schedule and any reported geometry)."""
    from tpu_stencil_torch.ops import cuda_stencil as cs

    if "backend=pallas" not in report:
        return launches()
    fields = dict(kv.split("=", 1) for kv in report.split() if "=" in kv)
    if fields.get("schedule") == "deep" and "block_h" not in fields:
        return launches(stencil_resident=1)
    fz = int(fields["fuse"]) if "fuse" in fields else cs.effective_geometry(
        plan_of("gaussian"), rows, MAIN_C)[1]
    return launches(stencil_fused=len(cs.launch_schedule(reps, fz)))


def phase_autotune_path(dev) -> dict:
    """``--backend autotune`` end to end: cold (measures, writes the
    cache), warm (zero probes, launches the verdict), a 2x2 mesh, then the
    geometry sweep and the quick benchmark sweep."""
    from tpu_stencil_torch import config, driver
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering
    from tpu_stencil_torch.runtime import autotune, bench_sweep
    from tpu_stencil_torch.tools import bh_fuse_ab

    src, img = main_raw()
    g = plan_of("gaussian")
    want = lowering.iterate(torch.from_numpy(img).to(dev), MAIN_REPS,
                            g).cpu().numpy()
    cache = Path(os.environ[autotune.ENV_CACHE])
    cache.unlink(missing_ok=True)
    base = [str(src), str(MAIN_W), str(MAIN_H), str(MAIN_REPS), "rgb",
            "--time", "--backend", "autotune"]
    out = {}

    def check_file(dst, label):
        got = np.fromfile(dst, np.uint8).reshape(img.shape)
        err = int(np.abs(got.astype(int) - want.astype(int)).max())
        require(err == 0, f"{label} disagrees with torch ops ({err})")
        return err

    # Cold: a fresh process, an empty cache file.
    dst = WORK / "blur_autotune_cold.raw"
    lines, counts = run_cli_cold(base + ["--output", str(dst)],
                                 env=dict(os.environ))
    probes = int(lines[1].rsplit("tune_probes=", 1)[1].split()[0])
    require(probes > 0, f"cold autotune made no probe: {lines[1]}")
    require(cache.exists(), "cold autotune wrote no cache file")
    entry = autotune.cached_entry(g, (MAIN_H, MAIN_W), MAIN_C, dev)
    require(entry is not None, "the cache holds no entry for the job")
    expect = verdict_launches(lines[1], MAIN_H, MAIN_REPS)
    require(counts == expect, f"cold autotune: launches {counts}, the "
            f"verdict implies {expect}")
    out["cold"] = {"report": lines[1], "probes": probes, "launches": counts,
                   "max_abs_err": check_file(dst, "cold autotune"),
                   "execution_time_s": float(lines[0].split()[2]),
                   "verdict": entry}
    # Warm: zero probes by the autotuner's counter, the verdict launched.
    dst = WORK / "blur_autotune_warm.raw"
    before = autotune.probe_count
    lines, counts = run_cli(base + ["--output", str(dst)])
    require(autotune.probe_count == before and "tune_probes=0" in lines[1],
            f"warm autotune probed: {lines[1]}")
    require(counts == expect, f"warm autotune: launches {counts}, the "
            f"verdict implies {expect}")
    tuned = [v for v in (entry["backend"], entry["schedule"]) if v]
    require(all(f"={v}" in lines[1] for v in tuned),
            f"warm autotune reports {lines[1]}, the cache says {entry}")
    out["warm"] = {"report": lines[1], "probes": 0, "launches": counts,
                   "max_abs_err": check_file(dst, "warm autotune"),
                   "execution_time_s": float(lines[0].split()[2])}
    # A 2x2 mesh of four tiles on this card: tuned against the tile.
    for label in ("mesh2x2_cold", "mesh2x2_warm"):
        dst = WORK / f"blur_autotune_{label}.raw"
        cfg = config.JobConfig(image=str(src), width=MAIN_W, height=MAIN_H,
                               repetitions=MAIN_REPS,
                               image_type=config.ImageType.RGB,
                               mesh_shape=(2, 2), backend="autotune",
                               output=str(dst))
        cs.reset_launch_counts()
        res = driver.run_job(cfg, devices=[dev] * 4)
        require((res.tune_probes > 0) == (label == "mesh2x2_cold"),
                f"{label}: {res.tune_probes} probes")
        fz = res.fuse if res.fuse is not None else cs.DEFAULT_FUSE
        expect4 = launches() if res.backend != "pallas" else launches(
            stencil_valid=len(cs.launch_schedule(MAIN_REPS, fz)) * 4)
        require(res.launches == expect4 and res.mesh_shape == (2, 2),
                f"{label}: launches {res.launches}, the verdict implies "
                f"{expect4}")
        out[label] = {"backend": res.backend, "schedule": res.schedule,
                      "block_h": res.block_h, "fuse": res.fuse,
                      "probes": res.tune_probes, "launches": res.launches,
                      "max_abs_err": check_file(dst, label),
                      "compute_seconds": res.compute_seconds}
    # The geometry sweep and the quick benchmark sweep, to the end.
    buf = io.StringIO()
    rows = bh_fuse_ab.run_sweep(
        bh_fuse_ab.parse_candidates([], g, MAIN_C), dev, reps=400, rounds=3,
        out=buf)
    for line in buf.getvalue().strip().splitlines():
        print(line, flush=True)
    require(all(r["exact"] for r in rows), f"bh_fuse_ab not exact: {rows}")
    out["bh_fuse_ab"] = [{k: r[k] for k in ("block_h", "fuse", "us_per_rep",
                                            "forty_us_per_rep", "exact")}
                         for r in rows]
    sweep = bench_sweep.run_sweep(quick=True, device=dev,
                                  backends=["xla", "pallas", "auto"])
    print(bench_sweep.emit_markdown(sweep), flush=True)
    require(all(r["exact"] for r in sweep),
            f"bench_sweep rows not exact: {[r for r in sweep if not r['exact']]}")
    out["bench_sweep_quick"] = sweep
    return {"phase": "autotune_path", "ok": True, "runs": out}


def phase_times(dev) -> dict:
    from tpu_stencil_torch.ops import cuda_stencil as cs
    from tpu_stencil_torch.ops import lowering

    g = plan_of("gaussian")
    img = seeded((MAIN_H, MAIN_W, MAIN_C), 7, dev)
    x2 = img.reshape(MAIN_H, -1)
    n = MAIN_REPS
    r = {
        "stencil_fused_ms": time_ms(lambda: cs.iterate(img, n, g), dev) / n,
        "stencil_resident_ms": time_ms(
            lambda: cs.iterate(img, n, g, schedule="deep"), dev) / n,
        "plain_ms": time_ms(
            lambda: cs.stencil_fused_plain(x2, g, MAIN_C, n), dev) / n,
        "torch_ops_ms": time_ms(lambda: lowering.iterate(img, n, g), dev) / n,
    }
    # K3 alone: the one ext tile of a 1x1 mesh at fuse 8, per rep.
    fz = cs.DEFAULT_FUSE
    ext = ext_tile(img, 0, 0, (1, 1), fz * g.halo)
    glob = (MAIN_H, MAIN_W * MAIN_C)
    r["stencil_valid_ms"] = time_ms(
        lambda: cs.valid_fused(ext, g, fz, MAIN_C, 0, 0, glob), dev) / fz
    r["stencil_valid_plain_ms"] = time_ms(
        lambda: cs.stencil_valid_plain(ext, g, MAIN_C, fz, 0, 0, glob),
        dev) / fz
    r["stencil_valid_bound_ms"], r["stencil_valid_bound_by"] = (
        bound_ms_per_rep(g, MAIN_H * MAIN_W * MAIN_C, fz,
                         n_bytes=ext.numel() + MAIN_H * MAIN_W * MAIN_C))
    # The whole 2x2 sharded runner on one card: K3 plus the exchange.
    from tpu_stencil_torch.models.blur import IteratedConv2D
    from tpu_stencil_torch.parallel.sharded import ShardedRunner

    runner = ShardedRunner(
        IteratedConv2D("gaussian", backend="pallas", device=dev),
        (MAIN_H, MAIN_W), MAIN_C, mesh_shape=(2, 2), devices=[dev] * 4)
    tiles = runner.put(img.cpu().numpy())
    # The same runner under `auto` (the default backend), whose verdict
    # phase autotune_path left in the cache: it must not chunk shallower
    # than `pallas` at its defaults, since every chunk costs an exchange,
    # and the two windows are timed taking turns.
    tuned = ShardedRunner(
        IteratedConv2D("gaussian", backend="auto", device=dev),
        (MAIN_H, MAIN_W), MAIN_C, mesh_shape=(2, 2), devices=[dev] * 4)
    require(tuned.backend == "pallas" and tuned.fuse >= runner.fuse,
            f"sharded auto runs {tuned.backend} at fuse {tuned.fuse}, pallas "
            f"at its defaults fuse {runner.fuse}")
    both = interleaved_ms({"pallas": lambda: runner.run(tiles, n),
                           "auto": lambda: tuned.run(tiles, n)}, dev)
    r["sharded_2x2_ms"] = both["pallas"] / n
    r["sharded_2x2_auto_ms"] = both["auto"] / n
    r["sharded_2x2_auto_fuse"] = tuned.fuse
    require(both["auto"] <= 1.5 * both["pallas"],
            f"sharded 2x2 under auto takes {both['auto']} ms, under pallas "
            f"{both['pallas']} ms")
    # Library yardstick: one depthwise float32 convolution rep (planar
    # layout prepared outside the window). Timed only.
    torch.backends.cudnn.allow_tf32 = False
    xf = img.permute(2, 0, 1)[None].to(torch.float32).contiguous()
    w = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]],
                     device=dev).div(16.0).expand(MAIN_C, 1, 3, 3).contiguous()
    r["library_conv2d_ms"] = time_ms(
        lambda: torch.nn.functional.conv2d(xf, w, padding=1, groups=MAIN_C),
        dev)
    bound, by = bound_ms_per_rep(g, MAIN_H * MAIN_W * MAIN_C, n)
    r["bound_ms"], r["bound_by"] = bound, by
    # L2: the lab's `current` body through the same rep loop, and its
    # plain version (K1's function).
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.runtime import roofline
    from tpu_stencil_torch.tools import op_cost

    cur = lab.parse_variant("current")
    r["stencil_lab_ms"] = time_ms(
        lambda: lab.lab_iterate(img, n, g, cur), dev) / n
    r["stencil_lab_plain_ms"] = time_ms(
        lambda: lab.stencil_lab_plain(x2, g, MAIN_C, n, cur), dev) / n
    # L1: one launch of add_i32 with a chain of 8 on the tool's tiles. The
    # case is elementwise, so the stored rows depend on as many input rows
    # and no more. Its bound: those rows read once and written once,
    # against one int32 add per stored element and operation.
    ib, b, wc, grid = op_cost.tile_for("add_i32")
    xt = seeded((grid * ib, wc), 9, dev)
    ot = torch.empty((grid * b, wc), dtype=torch.uint8, device=dev)
    r["op_chain_ms"] = time_ms(
        lambda: lab.op_chain(xt, "add_i32", 8, ib, b, out=ot), dev)
    r["op_chain_plain_ms"] = time_ms(
        lambda: lab.op_chain_plain(xt, "add_i32", 8, ib, b), dev)
    t_bytes = 2 * ot.numel() / roofline.H100_HBM_BYTES_PER_S
    t_ops = 8 * ot.numel() / roofline.H100_INT32_OPS_PER_S
    r["op_chain_bound_ms"] = max(t_bytes, t_ops) * 1e3
    r["op_chain_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    r["op_chain_unit"] = (f"ms per launch, add_i32 chain of 8, {grid} tiles "
                          f"of {ib}x{wc}, {b} rows of each stored")
    r["clocks_power"] = nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu")
    return {"phase": "times", "unit": "ms per rep",
            "shape": [MAIN_H, MAIN_W, MAIN_C], "reps": n, "filter": "gaussian",
            **r}


def run(dev: torch.device) -> None:
    """Every phase on ``dev``; raises on any failure."""
    from tpu_stencil_torch.ops import _build
    from tpu_stencil_torch.ops import cuda_stencil as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(dev)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sms": props.multi_processor_count,
          "l2_bytes": int(props.L2_cache_size)})

    # The autotune cache of this run: a file of its own, empty at start.
    from tpu_stencil_torch.ops import lab
    from tpu_stencil_torch.runtime import autotune
    from tpu_stencil_torch.tools import kernel_lab

    WORK.mkdir(parents=True, exist_ok=True)
    os.environ[autotune.ENV_CACHE] = str(WORK / "autotune.json")
    (WORK / "autotune.json").unlink(missing_ok=True)

    # Every library this script launches, one nvcc each, all together.
    t0 = time.perf_counter()
    variants = [lab.parse_variant(n) for n in kernel_lab.DEFAULT_VARIANTS
                if n not in kernel_lab.SPECIAL]
    targets = [*_build.JOB_KERNELS, "op_chain", *lab.lab_targets(variants)]
    built = _build.build(targets)

    def label(t):
        return t if isinstance(t, str) else f"{t[0]}[{' '.join(t[1])}]"

    def log_of(t):
        return _build.build_log(t) if isinstance(t, str) else _build.build_log(*t)

    libs = {label(t): str(p) for t, p in built.items()}
    ptxas = {label(t): [ln.strip() for ln in log_of(t).splitlines()
                        if "registers" in ln or "spill" in ln][:6]
             for t in built if t != "op_chain"}
    spills = [ln for t in built for ln in log_of(t).splitlines()
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs, "ptxas": ptxas, "lines_with_spills": spills})

    emit(phase_divide(dev))
    k1 = phase_k1(dev)
    emit(k1)
    k2 = phase_k2(dev)
    emit(k2)
    main_path = phase_main_path(dev)
    emit(main_path)
    k3 = phase_k3(dev)
    emit(k3)
    sharded_path = phase_sharded_path(dev)
    emit(sharded_path)
    l2 = phase_l2(dev)
    emit(l2)
    l1 = phase_l1(dev)
    emit(l1)
    autotune_path = phase_autotune_path(dev)
    emit(autotune_path)
    times = phase_times(dev)
    emit(times)

    runs = main_path["runs"]
    common = {"route": "cuda", "plain_ms": times["plain_ms"],
              "bound_ms": times["bound_ms"],
              "bound_by": times["bound_by"],
              "library_ms": times["library_conv2d_ms"], "ok": True,
              "unit": "ms per rep, 1920x2520 RGB gaussian x40"}
    emit({"kernels": [
        {"name": "stencil_fused",
         "source": "tpu_stencil_torch/ops/csrc/stencil_fused.cu",
         "replaces": "tpu_stencil/ops/pallas_stencil.py:757",
         "launches": runs["default_warm"]["launches"]["stencil_fused"],
         "max_abs_err": max(k1["max_abs_err"],
                            runs["default_warm"]["max_abs_err"],
                            runs["default_cold"]["max_abs_err"]),
         "ms": times["stencil_fused_ms"], **common},
        {"name": "stencil_resident",
         "source": "tpu_stencil_torch/ops/csrc/stencil_resident.cu",
         "replaces": "tpu_stencil/ops/pallas_stencil.py:1079",
         "launches": runs["deep_warm"]["launches"]["stencil_resident"],
         "max_abs_err": max(k2["max_abs_err"], runs["deep_warm"]["max_abs_err"],
                            runs["deep_cold"]["max_abs_err"]),
         "ms": times["stencil_resident_ms"], **common},
        {"name": "stencil_valid",
         "source": "tpu_stencil_torch/ops/csrc/stencil_valid.cu",
         "replaces": "tpu_stencil/ops/pallas_stencil.py:909",
         "launches": sharded_path["runs"]["cli_mesh1x1_warm"]["launches"][
             "stencil_valid"],
         "max_abs_err": max(k3["max_abs_err"], sharded_path["max_abs_err"]),
         "ms": times["stencil_valid_ms"],
         **common, "plain_ms": times["stencil_valid_plain_ms"],
         "bound_ms": times["stencil_valid_bound_ms"],
         "bound_by": times["stencil_valid_bound_by"]},
        # L2 and L1 run on the tools' path, not the job's: their launches
        # are those of the tool runs in phases l2 and l1.
        {"name": "stencil_lab",
         "source": "tpu_stencil_torch/ops/csrc/stencil_lab.cu",
         "replaces": "tools/kernel_lab.py:254",
         "launches": l2["tool_launches"],
         "max_abs_err": l2["max_abs_err"],
         "ms": times["stencil_lab_ms"],
         **common, "plain_ms": times["stencil_lab_plain_ms"],
         "unit": "ms per rep, 1920x2520 RGB gaussian x40, body `current`"},
        {"name": "op_chain",
         "source": "tpu_stencil_torch/ops/csrc/op_chain.cu",
         "replaces": "tools/op_cost.py:31",
         "launches": l1["tool_launches"],
         "max_abs_err": l1["max_abs_err"],
         "ms": times["op_chain_ms"], "route": "cuda", "ok": True,
         "plain_ms": times["op_chain_plain_ms"],
         "bound_ms": times["op_chain_bound_ms"],
         "bound_by": times["op_chain_bound_by"],
         "library_ms": None, "unit": times["op_chain_unit"]},
    ]})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
