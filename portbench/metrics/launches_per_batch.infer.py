"""``launches_per_batch.infer``: the kernel, copy and fill launches inside
``himo.frame`` per traced batch (``spans.launches_per_item``)."""

import spans


def read(ctx):
    return spans.launches_per_item(ctx, "himo.frame")
