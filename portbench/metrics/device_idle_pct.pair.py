"""``device_idle_pct.pair``: ``readers.device_idle``."""

import readers


def read(ctx):
    return readers.device_idle(ctx)
