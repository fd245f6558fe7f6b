"""``port_kernel_roofline_pct.pair``: ``readers.kernel_roofline`` (K7 and K3
sum in a pair)."""

import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
