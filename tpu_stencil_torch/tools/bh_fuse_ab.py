"""A/B the shipped fused kernel's tile height and fuse on the card.

The port's counterpart of the JAX package's ``tools/bh_fuse_ab.py``: a
same-process sweep of ``cuda_stencil.iterate`` itself (K1, not the lab's
copy) over (block_h, fuse) candidates at the reference job's shape, one
line per candidate: steady-state µs per rep (two-point differencing, all
candidates interleaved, the median), the literal 40-rep window (a fuse
that does not divide 40 pays ``40 % fuse`` single-rep launches there,
which the steady-state column cannot see), and byte-exactness against the
torch-ops lowering. It decides nothing: the defaults move only by a PR
that reads it.

Usage:  python -m tpu_stencil_torch.tools.bh_fuse_ab [BHxFUSE ...]
            [--platform cpu] [--shape HxW] [--reps N] [--rounds R]
Output: ``bh= fuse=  us/rep  forty= us/rep  exact=`` per candidate (the
effective geometry after align and clamp). A candidate whose tile does not
fit shared memory in the plan's tile body (``cuda_stencil.tile_body``:
gaussian runs ``swar``, 4 bytes per element) is a usage error, named
before anything runs. Exit code 1 when a candidate is not exact.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import List, Optional

import torch

from tpu_stencil_torch import filters
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.tools import _harness

H, W, C = 2520, 1920, 3

DEFAULT_GRID = ("16x4", "16x8", "32x4", "32x5", "32x8", "32x10", "32x16",
                "64x4", "64x8", "64x10", "64x16", "64x20", "128x8")


def parse_candidates(cands: List[str], plan, channels: int) -> List[tuple]:
    """[(block_h, fuse)] of ``cands``; raises ValueError for a malformed
    candidate or one whose tile does not fit shared memory."""
    out = []
    for cand in cands or DEFAULT_GRID:
        bh, sep, fz = cand.lower().partition("x")
        if not sep or not bh.isdigit() or not fz.isdigit():
            raise ValueError(f"candidate must be BHxFUSE, got {cand!r}")
        bh, fz = int(bh), int(fz)
        if bh < 8 or bh % 8 or fz < 1:
            raise ValueError(f"{cand}: block_h is a positive multiple of 8 "
                             "and fuse is positive")
        need = cs.tile_smem_bytes(plan, bh, fz, channels)
        if need > cs.SMEM_LIMIT:
            raise ValueError(f"{cand}: the tile takes {need} bytes of shared "
                             f"memory, a block may use {cs.SMEM_LIMIT}")
        out.append((bh, fz))
    return out


def run_sweep(cands: List[tuple], device: torch.device, shape=(H, W),
              channels: int = C, reps: int = 2000, rounds: int = 3,
              out=None) -> List[dict]:
    out = sys.stdout if out is None else out
    plan = lowering.plan_filter(filters.get_filter("gaussian"))
    full = tuple(shape) + ((channels,) if channels > 1 else ())
    img = _harness.seeded_image(full, device)
    print(f"platform={_harness.describe(device)} schedule={cs.FUSED} "
          f"body={cs.tile_body(plan)} "
          f"shipped=({cs.DEFAULT_BLOCK_H},{cs.DEFAULT_FUSE}) shape={full}",
          file=out, flush=True)
    want_by_fz, runs, rows = {}, {}, []
    for bh, fz in cands:
        eff = cs.rep_loop(plan, shape[0], shape[1] * channels, channels, bh,
                          fz, None, device).fused

        def fn(n, _bh=bh, _fz=fz):
            return cs.iterate(img, n, plan, block_h=_bh, fuse=_fz)

        if eff.fuse not in want_by_fz:
            want_by_fz[eff.fuse] = lowering.iterate(img, eff.fuse, plan)
        ok = bool(torch.equal(fn(eff.fuse), want_by_fz[eff.fuse]))
        run = _harness.timed(fn, device)
        runs[(bh, fz)] = (run, max(eff.fuse, reps - reps % eff.fuse))
        rows.append({"block_h": eff.tile_h, "fuse": eff.fuse, "exact": ok,
                     "requested": (bh, fz), "run": run})
    per_rep = _harness.interleaved_per_rep(runs, rounds)
    for row in rows:
        run = row.pop("run")
        run(40)  # the 40-rep launch sequence, warm
        forty = statistics.median(run(40) for _ in range(5)) / 40
        per = per_rep[row["requested"]]
        row.update(us_per_rep=per * 1e6, forty_us_per_rep=forty * 1e6)
        print(f"bh={row['block_h']:4d} fuse={row['fuse']:3d}  "
              f"{per * 1e6:8.2f} us/rep  forty={forty * 1e6:8.2f} us/rep  "
              f"exact={row['exact']}", file=out, flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_stencil_torch.tools.bh_fuse_ab",
        description=__doc__.split("\n\n")[0])
    p.add_argument("candidates", nargs="*", metavar="BHxFUSE",
                   help=f"default: {' '.join(DEFAULT_GRID)}")
    p.add_argument("--shape", default=f"{H}x{W}", help="image HxW")
    _harness.add_common_args(p, 2000)
    ns = p.parse_args(argv)
    plan = lowering.plan_filter(filters.get_filter("gaussian"))
    try:
        cands = parse_candidates(ns.candidates, plan, C)
        shape = _harness.parse_shape(ns.shape)
    except ValueError as e:
        p.error(str(e))
    device = _harness.device_for(ns.platform, p.prog)
    if device is None:
        return 2
    rows = run_sweep(cands, device, shape, C, ns.reps, ns.rounds)
    bad = [f"{r['block_h']}x{r['fuse']}" for r in rows if not r["exact"]]
    if bad:
        print(f"NOT EXACT: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
