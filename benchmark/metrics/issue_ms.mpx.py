"""``issue_ms.mpx``: host self time in the program's ``model.issue`` spans
inside the traced window (the configuration and geometry resolved, and
each launch's checks, packing and call), less what spans inside them
cover, ``host.gc`` among them, per output that the window finished, in
ms. Nothing to read in a program without the spans."""

from benchmark.harness import program_spans as ps


def read(ctx):
    spans = ps.window_spans(ctx.capture)
    if spans is None or ctx.window.done <= 0:
        return None
    c = ctx.capture
    return ps.self_ns(spans, ps.ISSUE, c.start_ns, c.end_ns) / 1e6 / (
        ctx.window.done)
