"""``port_kernel_roofline_pct.infer``: ``readers.kernel_roofline``."""

import readers


def read(ctx):
    return readers.kernel_roofline(ctx)
