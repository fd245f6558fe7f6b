"""``port_kernel_roofline_pct.train``: ``readers.kernel_roofline``."""

import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
