"""``copy_ms.mpx``: device time of the copies between host and card
(host to card and card to host, every card) per output that the traced
window finished, in ms."""


def read(ctx):
    c = ctx.capture
    if c is None or ctx.window.done <= 0:
        return None
    s = c.seconds("h2d") + c.seconds("d2h")
    if s <= 0:
        return None
    return 1e3 * s / ctx.window.done
