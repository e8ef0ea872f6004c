"""Kernel lab: time variants of the fused stencil kernel on the card, to
find where K1's time goes and what a redesign could gain.

The port's counterpart of the JAX package's ``tools/kernel_lab.py``. Every
variant runs the reference job's shape (2520x1920 RGB gaussian unless
``--shape``/``--filter``/``--grey`` say otherwise) through one harness:
steady-state seconds per rep by two-point differencing, all variants
interleaved over ``--rounds`` passes, the median reported, and the output
of each exact variant held byte for byte against the torch-ops lowering.

Variants (exact unless marked ablation; geometry suffixes ``_bN`` = tile
height N, ``_fN`` = fuse N, in either order, on any of them):
  shipped   ``cuda_stencil.iterate`` as shipped (K1)
  xla       the torch-ops lowering
  current   the lab's own copy of K1's body; the ratio current/shipped is
            printed and reconciles the lab's harness with the shipped
            kernel
  pair      binomial taps as chains of pair adds, no multiplies
  acc16     the rows-pass intermediate as int16 in shared memory
  swar      two pixels (rows 2q, 2q+1 of a lane) per 32-bit word
  abl_no_rows, abl_no_cols, abl_no_mask, abl_load_store_only
            ablations of ``current``: WRONG OUTPUT, timing only
  abl_swar_no_rows, abl_swar_no_cols, abl_swar_no_mask,
  abl_swar_load_store_only
            the same ablations of ``swar``

The JAX tool's variants, and what answers each here:
  current              -> current
  hoist, hoist_pair    -> none: they hoist Mosaic's iota masks out of the
                          rep loop; K1 tests bounds with one compare per
                          thread and has no mask array to hoist
  shrink               -> acc16 (the contracting band with the int16
                          intermediate; K1 already contracts its band)
  shrink_pair          -> pair
  shrink_pair_b256, shrink_pair_f16_b256
                       -> pair_b64, pair_f16_b64 (this card's tiles are
                          tens of rows: 227 KB of shared memory a block)
  shrink_rollrows      -> none: it trades a misaligned sublane slice for a
                          full-tile rotate; a thread walking down its lane
                          has no alignment to pay for
  shrink_strips, shrink_strips_i32, shrink_strips_256, shrink_strips_1024,
  swar_strips, swar_strips_1024
                       -> none: strips keep a rep's chain in vector
                          registers between VMEM sweeps; here the rows-pass
                          window already lives in registers
  swar, swar_b256, swar_f16_b256
                       -> swar, swar_b64, swar_f16_b64
  swar_cols_ilp, swar_ilp_f16_b256
                       -> none: they reorder lane rotates for the VPU's
                          latency; the cols pass here is independent
                          multiply-adds on shared-memory loads already
  abl_no_mask, abl_no_cols, abl_no_rows, abl_dma_only
                       -> abl_no_mask, abl_no_cols, abl_no_rows,
                          abl_load_store_only
  abl_swar_no_rows, abl_swar_no_cols, abl_swar_no_mask, abl_swar_dma_only
                       -> the same names, abl_swar_load_store_only
  shipped, xla         -> shipped, xla
  xla_pair             -> none: the torch-ops lowering has one form
Asking for a name that is not listed here is a usage error.

Usage:  python -m tpu_stencil_torch.tools.kernel_lab [variant ...]
            [--platform cpu] [--shape HxW] [--grey] [--filter NAME]
            [--reps N] [--rounds R]
Output: one line per variant, ``name  us/rep  exact=True|False|-``, then
the current/shipped ratio. Exit code 1 when any exact variant is not exact.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from tpu_stencil_torch import filters
from tpu_stencil_torch.ops import _build
from tpu_stencil_torch.ops import cuda_stencil as cs
from tpu_stencil_torch.ops import lab
from tpu_stencil_torch.ops import lowering
from tpu_stencil_torch.tools import _harness

H, W, C = 2520, 1920, 3

# The default run, in order (any name lab.parse_variant takes may be asked
# for as well).
DEFAULT_VARIANTS = (
    "shipped", "current", "pair", "acc16", "swar",
    "current_b64", "pair_b64", "acc16_b64", "swar_b64",
    "pair_f16_b64", "swar_f16_b64", "current_f4", "swar_f4",
    "abl_no_rows", "abl_no_cols", "abl_no_mask", "abl_load_store_only",
    "abl_swar_no_rows", "abl_swar_no_cols", "abl_swar_no_mask",
    "abl_swar_load_store_only",
)
SPECIAL = ("shipped", "xla")


def resolve_names(names: List[str]) -> List[str]:
    """``names`` checked (default: :data:`DEFAULT_VARIANTS`); raises
    ValueError listing the names there are."""
    names = list(names) or list(DEFAULT_VARIANTS)
    for n in names:
        if n in SPECIAL:
            continue
        try:
            lab.parse_variant(n)
        except ValueError:
            raise ValueError(
                f"unknown variant {n!r}; the variants are: "
                f"{', '.join(SPECIAL + lab.BODIES)}, abl_[swar_]"
                f"{{{','.join(lab.ABLATIONS)}}}, each with optional "
                "_b<rows> and _f<fuse> suffixes"
            ) from None
    return names


def variant_fn(name: str, plan, img: torch.Tensor):
    """(fn(n) running ``n`` reps of ``name``, reps per fused launch)."""
    rows = img.shape[0]
    channels = img.shape[2] if img.dim() == 3 else 1
    if name == "shipped":
        fuse = cs.effective_geometry(plan, rows, channels)[1]
        return (lambda n: cs.iterate(img, n, plan)), fuse
    if name == "xla":
        return (lambda n: lowering.iterate(img, n, plan)), 1
    variant = lab.parse_variant(name)
    fuse = lab.lab_geometry(variant, plan, rows, channels)[1]
    return (lambda n: lab.lab_iterate(img, n, plan, variant)), fuse


def run_lab(names: List[str], device: torch.device, shape=(H, W),
            channels: int = C, filter_name: str = "gaussian",
            reps: int = 2000, rounds: int = 3, out=None) -> dict:
    """Time and check ``names``; returns name -> {"us_per_rep", "exact"}
    (``exact`` None for ablations). Prints the tool's lines to ``out``."""
    out = sys.stdout if out is None else out
    names = resolve_names(names)
    plan = lowering.plan_filter(filters.get_filter(filter_name))
    full = tuple(shape) + ((channels,) if channels > 1 else ())
    img = _harness.seeded_image(full, device)
    print(f"platform={_harness.describe(device)} plan={plan.kind} "
          f"row_taps={plan.row_taps} col_taps={plan.col_taps} "
          f"shape={full}", file=out, flush=True)
    variants = [lab.parse_variant(n) for n in names if n not in SPECIAL]
    if device.type == "cuda":
        # Every library of this run, one nvcc each, all started together.
        _build.build(list(lab.lab_targets(variants)) + ["stencil_fused"])
    fns, exact = {}, {}
    for name in names:
        fn, fuse = variant_fn(name, plan, img)
        fns[name] = (fn, fuse)
        exact[name] = None
        if not name.startswith("abl_"):
            n = 2 * fuse + 1  # fused launches and a single-rep remainder
            exact[name] = bool(torch.equal(
                fn(n), lowering.iterate(img, n, plan)))
    runs = {}
    for name, (fn, fuse) in fns.items():
        base = max(fuse, reps - reps % fuse)
        runs[name] = (_harness.timed(fn, device), base)
    per_rep = _harness.interleaved_per_rep(runs, rounds)
    result = {}
    for name in names:
        per = per_rep[name]
        ok = exact[name]
        print(f"{name:26s} {per * 1e6:8.2f} us/rep   "
              f"exact={'-' if ok is None else ok}", file=out, flush=True)
        result[name] = {"us_per_rep": per * 1e6, "exact": ok}
    if "current" in result and "shipped" in result:
        ratio = result["current"]["us_per_rep"] / result["shipped"][
            "us_per_rep"]
        print(f"current / shipped = {ratio:.3f}", file=out, flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_stencil_torch.tools.kernel_lab",
        description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", help="variant names (default: "
                   "the whole table; see the module docstring)")
    p.add_argument("--shape", default=f"{H}x{W}", help="image HxW")
    p.add_argument("--grey", action="store_true", help="one channel")
    p.add_argument("--filter", dest="filter_name", default="gaussian")
    _harness.add_common_args(p, 2000)
    ns = p.parse_args(argv)
    try:
        names = resolve_names(ns.variants)
        shape = _harness.parse_shape(ns.shape)
    except ValueError as e:
        p.error(str(e))
    device = _harness.device_for(ns.platform, p.prog)
    if device is None:
        return 2
    result = run_lab(names, device, shape, 1 if ns.grey else C,
                     ns.filter_name, ns.reps, ns.rounds)
    bad = [n for n, r in result.items() if r["exact"] is False]
    if bad:
        print(f"NOT EXACT: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
