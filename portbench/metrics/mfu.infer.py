"""``mfu.infer``: ``readers.mfu``."""

import readers


def read(ctx):
    return readers.mfu(ctx)
