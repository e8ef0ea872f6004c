"""``exchange_ms.mpx``: host self time in the program's
``sharded.exchange`` spans inside the traced window (one a phase of the
halo exchange: the strips' copies issued and the ghost-extended tiles
assembled), less what spans inside them cover, per output that the
window finished, in ms. Nothing to read in a program without the
spans."""

from benchmark.harness import mesh_spans
from benchmark.harness import program_spans as ps


def read(ctx):
    spans = ps.window_spans(ctx.capture)
    if spans is None or ctx.window.done <= 0:
        return None
    c = ctx.capture
    ns = ps.self_ns(spans, mesh_spans.EXCHANGE, c.start_ns, c.end_ns)
    if ns <= 0:
        return None
    return ns / 1e6 / ctx.window.done
