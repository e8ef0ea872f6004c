"""``direct_rep_us.mpx``: device time of the traced window's ``stencil_*``
kernels, over every card, per rep that the window's ``model.issue`` spans
of a ``direct_int`` plan (arg ``plan``) ran in K1 (arg ``body_reps``,
summed over bodies), in us. It follows the plan and not the body, so it
stays the direct plan's cost a rep whichever body runs it, tail launches
included. Nothing to read in a program whose spans carry no such args,
or in a window that ran no direct plan."""

from benchmark.harness import program_spans as ps
from benchmark.harness.trace import STENCIL_KERNEL

DIRECT = "direct_int"


def read(ctx):
    spans = ps.window_spans(ctx.capture)
    if spans is None:
        return None
    reps = sum(sum(r.args.get("body_reps", {}).values()) for r in spans
               if r.name == ps.ISSUE and r.args.get("plan") == DIRECT)
    kernel_s = ctx.capture.seconds("kernel", STENCIL_KERNEL)
    if reps <= 0 or kernel_s <= 0:
        return None
    return 1e6 * kernel_s / reps
