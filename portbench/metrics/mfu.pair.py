"""``mfu.pair``: ``readers.mfu`` (the pair's MLP products and searches,
``drivers/pair_work.py``)."""

import readers


def read(ctx):
    return readers.mfu(ctx)
