"""``kernel_roofline_pct.mpx``: the share of their roofline at which the
port's stencil kernels did the window's finished work, in %.

The bound is the benchmark's frozen work count (:mod:`benchmark.harness.
workcount`) summed over the outputs the window finished; the time is the
device time of the kernels named ``stencil_*`` in the traced window, over
every card."""

from benchmark.harness import workcount
from benchmark.harness.trace import STENCIL_KERNEL


def read(ctx):
    if ctx.capture is None:
        return None
    kernel_s = ctx.capture.seconds("kernel", STENCIL_KERNEL)
    if kernel_s <= 0 or ctx.window.done <= 0:
        return None
    it = ctx.item()
    bound, _ = workcount.bound_seconds(it["h"], it["w"], it["c"],
                                       it["reps"], it["taps"])
    return 100.0 * bound * ctx.window.done / kernel_s
