"""``idle_program_pct.mpx``: the share of the traced window in which a
card was idle while the innermost open span on the host's calling thread
was one of the program's ``model.*`` spans (``model.place``,
``model.issue``), averaged over the cell's cards, in %: the part of
``device_idle_pct.mpx`` spent inside the program. The device's
operations are first tied to the host's clock
(:func:`benchmark.harness.program_spans.aligned`). Nothing to read in a
program without the spans."""

from benchmark.harness import program_spans as ps


def read(ctx):
    return ps.idle_pct(ctx, lambda name: name.startswith(ps.MODEL))
