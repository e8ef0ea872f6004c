"""``idle_mesh_pct.mpx``: the share of the traced window in which a card
was idle while the innermost open span on the host's calling thread was
one of the program's ``sharded.*`` spans (``sharded.place``,
``sharded.exchange``, ``sharded.issue``), averaged over the cell's
cards, in %: the part of ``device_idle_pct.mpx`` spent inside the mesh
path. Each card's operations are first tied to the host's clock by its
own copies (:func:`benchmark.harness.mesh_spans.aligned`). Nothing to
read in a program without the spans."""

from benchmark.harness import mesh_spans


def read(ctx):
    return mesh_spans.idle_pct(
        ctx, lambda name: name.startswith(mesh_spans.PREFIX))
