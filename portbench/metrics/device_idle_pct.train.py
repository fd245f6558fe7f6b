"""``device_idle_pct.train``: ``readers.device_idle``."""

import readers


def read(ctx):
    return readers.device_idle(ctx)
