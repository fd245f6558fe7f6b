"""``device_idle_pct.infer``: ``readers.device_idle``."""

import readers


def read(ctx):
    return readers.device_idle(ctx)
