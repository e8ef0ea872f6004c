"""``device_idle_pct.mpx``: the share of the traced window in which no
kernel, copy or memset ran on a card, averaged over the cell's cards,
in %."""


def read(ctx):
    c = ctx.capture
    if c is None or not c.ops or c.window_s <= 0:
        return None
    return 100.0 * (1.0 - c.mean_busy_s(ctx.chips) / c.window_s)
