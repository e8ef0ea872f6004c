"""Micro-cost single operations inside a kernel, on the fused stencil
kernel's own tile.

The port's counterpart of the JAX package's ``tools/op_cost.py``. Each case
runs a chain of N identical operations on the tiles of one launch (L1
``op_chain``, ``csrc/op_chain.cu``) and reports the marginal cost of one
operation over every tile: ``(t(chain 2N) - t(chain N)) / N``, which
cancels the load, the store and the launch. The tile is K1's at its
default geometry (48 rows x 320 lanes: a 32 x 256 tile with its fuse-8
ghost band, lanes rounded up to whole warps), 32 rows of each stored,
1056 tiles (8 per SM of an H100); the shrinking adds at offset 8 and the
band products take taller tiles (:func:`tile_for`). Every case reads only
the rows its stored rows depend on (``lab.op_chain_rows_read``).

The JAX tool's cases, and the case that answers each here (same name =
same function), by where the chain runs:

In registers, no shared memory and no barrier (a thread holds one
16-byte run of the stored rows, or one lane and its rows; every operation
one or two predicated instructions the compiler cannot fold):
  add_i32, add_f32, mul_add_f32, mul_add_i32, shift_i32, where_i32,
  mul_i32, clip_i32   -> same names
  add_u8, add_i16     -> same names, each in its own width (a 16-bit add,
                         and for uint8 its wrap); and vadd4_u8 / vadd2_i16:
                         four uint8 or two int16 per 32-bit word, the
                         card's own answer (__vadd4 / __vadd2)
  cvt_u8_i32_rt, cvt_i16_i32_rt
                      -> same names: the two convert instructions (I2I /
                         PRMT) of a narrow value and its int32 widening, in
                         a register; no narrow memory traffic is priced
  strip_add_i32, strip128_add_i32
                      -> strip_add_i32: every chain here is held in
                         registers, so the two strip widths are one case
  subroll1_add_i32, subroll1_add_u8
                      -> same names: the end-around row roll, a lane's 48
                         rows in one thread's registers (other tile
                         heights: a column strip in shared memory)
  mis_slice_add_i32, mis_slice_add_i16
                      -> same names: the shrinking row add at offset 1, the
                         rows the 32 stored rows need in one thread's
                         registers (other tiles: shared memory)
By warp shuffle:
  shfl1_add_i32, shfl3_add_i32
                      -> this card's own: a warp-shuffle neighbour,
                         end-around within 32 lanes, no shared memory
Through shared memory:
  roll3_i32, roll3_add_i32, roll1_add_i32, roll128_add_i32
                      -> same names: the end-around lane roll, a block
                         whole rows; every lane writes its value to a
                         shared buffer and reads its source lane's after
                         one barrier an operation (two buffers in turn).
                         A shuffle within the warp, the buffer only for
                         the lanes across warps, was slower: the shuffle
                         was issued for every lane all the same
  al_slice_add_i16    -> same name: the shrinking row add at offset 8, a
                         column strip of 32 + 8N rows in shared memory (at a
                         chain of 16 more rows than registers hold), each
                         thread walking its own lanes with each row's old
                         value loaded once and held in a register
On tensor cores:
  mxu_rows_bf16       -> mxu_rows_bf16: the 144x144 band product by
                         mma.sync m16n8k16 bf16 -> float32
  mxu_rows_i8         -> mxu_rows_i8: the same by m16n8k32 int8 -> int32,
                         the depth padded with zeros to 160

Usage:  python -m tpu_stencil_torch.tools.op_cost [case ...]
            [--platform cpu] [--grid BLOCKS] [--reps N] [--rounds R]
Output: one line per case, ``name  us/op-pass  (bound B)  (chainN=
chain2N=)  exact=True|False``: B is the same difference of the two
chains' least times (``runtime.roofline.op_chain_bound_ms``) over N; both
chains, and a chain of 3 whose output no case leaves constant (at 8 and 16
a doubled or shifted byte is 0 whatever ran), are held byte for byte
(float cases within 1) against the plain version before they are timed.
Exit code 1 when a case is not exact.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import torch

from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.runtime import roofline
from tpu_stencil_torch.tools import _harness

N = lab.N_OPS[0]          # chains of N and 2N operations
BLOCK = 32                # rows stored: K1's default tile height
EXTRA = 16                # K1's fuse-8 ghost rows, and the 2N rows a
#                           shrinking add at offset 1 consumes
WC = 320                  # K1's 256 + 2*24 lanes, in whole warps
GRID = 1056               # 8 blocks for each of 132 SMs
# max |kernel - plain| allowed: float32 products may round once apart
TOLERANCE = {"mul_add_f32": 1, "mxu_rows_bf16": 1}


def tile_for(case: str, grid: int = GRID) -> Tuple[int, int, int, int]:
    """(in_block, block, wc, grid) of ``case``: the default tile, except
    where the chain needs more rows: the offset-8 shrink consumes 8 * 2N,
    the band products need their 144 rows (and, with a second buffer,
    narrower tiles and an eighth of the blocks)."""
    if case.startswith("mxu_rows"):
        return 160, BLOCK, 128, max(1, grid // 8)
    if case == "al_slice_add_i16":
        return BLOCK + 8 * 2 * N, BLOCK, WC, grid
    return BLOCK + EXTRA, BLOCK, WC, grid


def bound_us_per_op_pass(case: str, grid: int = GRID) -> float:
    """The least time of one operation over the tiles, as the tool reads
    it: the two chains' least times (``roofline.op_chain_bound_ms`` at
    their tiles) differenced over N, in us. 0 where both chains are bound
    by the same bytes."""
    ib, b, wc, g = tile_for(case, grid)
    t = {n: roofline.op_chain_bound_ms(case, n, ib, b, wc, g)[0]
         for n in (N, 2 * N)}
    return (t[2 * N] - t[N]) / N * 1e3


def resolve_cases(names: List[str]) -> List[str]:
    names = list(names) or list(lab.CASES)
    for n in names:
        if n not in lab.CASES:
            raise ValueError(f"unknown case {n!r}; the cases are: "
                             f"{', '.join(lab.CASES)}")
    return names


def run_cases(names: List[str], device: torch.device, grid: int = GRID,
              reps: int = 200, rounds: int = 3, out=None) -> dict:
    """Check and time ``names``; returns name -> {"us_per_op_pass",
    "bound_us_per_op_pass", "chain_us": {N: , 2N: }, "exact",
    "max_abs_err", "check_varies"} (``check_varies``: the plain output at
    the check chain is not one constant, so the comparison there can tell
    a wrong kernel)."""
    out = sys.stdout if out is None else out
    names = resolve_cases(names)
    print(f"platform={_harness.describe(device)} tile={BLOCK + EXTRA}x{WC} "
          f"grid={grid} n_ops={N},{2 * N}", file=out, flush=True)
    if device.type == "cuda":
        _build.build(["op_chain"])
    runs, checks, varies = {}, {}, {}
    for name in names:
        ib, b, wc, g = tile_for(name, grid)
        x = _harness.seeded_image((g * ib, wc), device)
        o = torch.empty((g * b, wc), dtype=torch.uint8, device=device)
        worst = 0
        for n_ops in (lab.CHECK_N_OPS, N, 2 * N):
            got = lab.op_chain(x, name, n_ops, ib, b)
            want = lab.op_chain_plain(x, name, n_ops, ib, b)
            worst = max(worst, int((got.to(torch.int32)
                                    - want.to(torch.int32)).abs().max()))
            if n_ops == lab.CHECK_N_OPS:
                varies[name] = bool(want.min() != want.max())
                continue  # checked, not timed

            def fn(k, _n=n_ops, _x=x, _o=o, _ib=ib, _b=b, _c=name):
                for _ in range(k):
                    lab.op_chain(_x, _c, _n, _ib, _b, out=_o)

            runs[(name, n_ops)] = (_harness.device_timed(fn, device), reps)
        checks[name] = worst
    per_launch = _harness.interleaved_per_rep(runs, rounds)
    result = {}
    for name in names:
        t1, t2 = per_launch[(name, N)], per_launch[(name, 2 * N)]
        per_op = (t2 - t1) / N
        bound = bound_us_per_op_pass(name, grid)
        ok = checks[name] <= TOLERANCE.get(name, 0) and varies[name]
        print(f"{name:22s} {per_op * 1e6:7.2f} us/op-pass   "
              f"(bound {bound:5.2f})   "
              f"(chain{N}={t1 * 1e6:6.1f} chain{2 * N}={t2 * 1e6:6.1f})   "
              f"exact={ok}", file=out, flush=True)
        result[name] = {"us_per_op_pass": per_op * 1e6,
                        "bound_us_per_op_pass": bound,
                        "chain_us": {N: t1 * 1e6, 2 * N: t2 * 1e6},
                        "exact": ok, "max_abs_err": checks[name],
                        "check_varies": varies[name]}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_stencil_torch.tools.op_cost",
        description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*", help="case names (default: all)")
    p.add_argument("--grid", type=int, default=GRID,
                   help=f"tiles (blocks) per launch; default {GRID}")
    _harness.add_common_args(p, 200)
    ns = p.parse_args(argv)
    try:
        names = resolve_cases(ns.cases)
    except ValueError as e:
        p.error(str(e))
    device = _harness.device_for(ns.platform, p.prog)
    if device is None:
        return 2
    result = run_cases(names, device, ns.grid, ns.reps, ns.rounds)
    bad = [n for n, r in result.items() if not r["exact"]]
    if bad:
        print(f"NOT EXACT: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
