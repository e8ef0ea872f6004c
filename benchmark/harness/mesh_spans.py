"""The mesh's spans laid against the device's operations, card by card.

:func:`benchmark.harness.program_spans.aligned` ties the device clock to
the host by the job path's ``model.place`` spans, one host-to-card copy
each over all cards together. A job over a mesh of cards places one tile
a card inside one ``sharded.place`` span, so the pairing is made here
once per card: each card's host-to-card copies against the calling
thread's ``sharded.place`` spans, in order, the same causal bounds and
the same choice of offset, and every operation of the card moved by its
own card's offsets. The rest is read with :mod:`program_spans`' helpers.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

from benchmark.harness import program_spans as ps
from benchmark.harness.trace import Capture, DeviceOp

PREFIX = "sharded."          # the mesh path's spans
PLACE = "sharded.place"
EXCHANGE = "sharded.exchange"
ISSUE = "sharded.issue"


def card_offsets(places: Sequence, copies: Sequence[DeviceOp]
                 ) -> Optional[tuple]:
    """(copy starts, offsets) of one card: its copies paired in order with
    ``places`` (one more place than copies is allowed: the window may cut
    the last copy); None when they do not pair or a pair contradicts
    causality."""
    if not copies or not 0 <= len(places) - len(copies) <= 1:
        return None
    starts: List[int] = []
    offsets: List[int] = []
    offset = 0
    for place, copy in zip(places, copies):
        lo = place.start_ns - copy.start_ns
        hi = place.end_ns - copy.end_ns
        if lo > hi:
            return None
        offset = min(max(offset, lo), hi)
        starts.append(copy.start_ns)
        offsets.append(offset)
    return starts, offsets


def aligned(capture, spans: Sequence) -> Optional[Capture]:
    """``capture`` with each card's operations moved onto the host's
    clock by that card's own offsets (:func:`card_offsets`); None when
    any card of the capture cannot be tied."""
    places = sorted((r for r in ps.thread_spans(spans) if r.name == PLACE),
                    key=lambda r: r.start_ns)
    ops: List[DeviceOp] = []
    for device in capture.devices():
        mine = [op for op in capture.ops if op.device == device]
        tie = card_offsets(places, sorted(
            (op for op in mine if op.kind == "h2d"),
            key=lambda op: op.start_ns))
        if tie is None:
            return None
        starts, offsets = tie
        for op in mine:
            k = max(0, bisect.bisect_right(starts, op.start_ns) - 1)
            s = max(op.start_ns + offsets[k], capture.start_ns)
            e = min(op.end_ns + offsets[k], capture.end_ns)
            if e > s:
                ops.append(DeviceOp(op.name, op.device, s, e))
    if not ops:
        return None
    return Capture(capture.start_ns, capture.end_ns, ops, capture.spans)


def idle_pct(ctx, match) -> Optional[float]:
    """:func:`program_spans.idle_pct_under` on the traced window, its
    operations :func:`aligned` card by card; None when there is nothing
    to read."""
    spans = ps.window_spans(ctx.capture)
    if spans is None or ctx.capture.window_s <= 0:
        return None
    capture = aligned(ctx.capture, spans)
    if capture is None:
        return None
    return ps.idle_pct_under(capture, spans, ctx.chips, match)
