"""``halo_ms.mpx``: device time of the halo exchange's copies in the
traced window, summed over every card, per output that the window
finished, in ms: the copies between cards (and a device-to-device copy
on one card), and PyTorch's copy kernel, by which a strip that is not
contiguous (a column strip) crosses to a peer card. The ghosts'
assembly (``torch.cat``) and zero strips are left out. Nothing to read
where no such copy ran."""

import re

COPY_KERNEL = re.compile(r"\bdirect_copy_kernel")


def read(ctx):
    c = ctx.capture
    if c is None or ctx.window.done <= 0:
        return None
    s = (c.seconds("p2p") + c.seconds("copy")
         + c.seconds("kernel", COPY_KERNEL))
    if s <= 0:
        return None
    return 1e3 * s / ctx.window.done
