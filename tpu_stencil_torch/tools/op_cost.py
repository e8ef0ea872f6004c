"""Micro-cost single operations inside a kernel, on the fused stencil
kernel's own tile.

The port's counterpart of the JAX package's ``tools/op_cost.py``. Each case
runs a chain of N identical operations on one shared-memory tile per block
(L1 ``op_chain``, ``csrc/op_chain.cu``) and reports the marginal cost of
one operation over every tile: ``(t(chain 2N) - t(chain N)) / N``, which
cancels the load, the store and the launch. The tile is K1's at its
default geometry (48 rows x 320 lanes: a 32 x 256 tile with its fuse-8
ghost band, lanes rounded up to whole warps), one block each, 1056 blocks
(8 per SM of an H100); the shrinking adds at offset 8 and the band
products take taller tiles (:func:`tile_for`).

The JAX tool's cases, and the case that answers each here (same name =
same function, computed through shared memory one sweep per operation
unless said otherwise):
  mxu_rows_bf16       -> mxu_rows_bf16: the 144x144 band product as float32
                         FMAs on bf16-rounded inputs, in the kernel's body
  mxu_rows_i8         -> mxu_rows_i8: the same product as __dp4a on int8
  strip_add_i32, strip128_add_i32
                      -> strip_add_i32: the chain held in registers (one
                         shared-memory round trip in all); a register
                         holds one element whatever the strip width, so
                         the two widths are one case
  subroll1_add_i32, subroll1_add_u8
                      -> same names: the end-around row roll, in place up
                         each thread's own lane
  cvt_u8_i32_rt, cvt_i16_i32_rt
                      -> same names: a narrow array to an int32 array and
                         back (in registers a convert is free; the cost on
                         this card is the narrow loads and stores)
  add_u8, add_i16     -> same names, one element per thread per access;
                         and vadd4_u8 / vadd2_i16: four or two per 32-bit
                         word (__vadd4, __vadd2), the card's own answer
  add_i32, add_f32, mul_add_f32, mul_add_i32, shift_i32, where_i32,
  mul_i32, clip_i32   -> same names
  mis_slice_add_i32, mis_slice_add_i16
                      -> same names: the shrinking row add at offset 1, in
                         place down each lane
  al_slice_add_i16    -> same name: the shrinking row add at offset 8 (no
                         alignment to gain here; kept as the offset-8 case)
  roll3_i32, roll3_add_i32, roll1_add_i32, roll128_add_i32
                      -> same names: the end-around lane roll through
                         shared memory, two buffers and a barrier; and
                         shfl1_add_i32 / shfl3_add_i32: a warp-shuffle
                         neighbour, end-around within 32 lanes, in
                         registers

Usage:  python -m tpu_stencil_torch.tools.op_cost [case ...]
            [--platform cpu] [--grid BLOCKS] [--reps N] [--rounds R]
Output: one line per case, ``name  us/op-pass  (chainN= chain2N=)
exact=True|False``: both chains, and a chain of 3 whose output no case
leaves constant (at 8 and 16 a doubled or shifted byte is 0 whatever ran),
are held byte for byte (float cases within 1) against the plain version
before they are timed. Exit code 1 when a case is not exact.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import torch

from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import lab
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
    "chain_us": {N: , 2N: }, "exact", "max_abs_err", "check_varies"}
    (``check_varies``: the plain output at the check chain is not one
    constant, so the comparison there can tell a wrong kernel)."""
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

            runs[(name, n_ops)] = (_harness.timed(fn, device), reps)
        checks[name] = worst
    per_launch = _harness.interleaved_per_rep(runs, rounds)
    result = {}
    for name in names:
        t1, t2 = per_launch[(name, N)], per_launch[(name, 2 * N)]
        per_op = (t2 - t1) / N
        ok = checks[name] <= TOLERANCE.get(name, 0) and varies[name]
        print(f"{name:22s} {per_op * 1e6:7.2f} us/op-pass   "
              f"(chain{N}={t1 * 1e6:6.1f} chain{2 * N}={t2 * 1e6:6.1f})   "
              f"exact={ok}", file=out, flush=True)
        result[name] = {"us_per_op_pass": per_op * 1e6,
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
