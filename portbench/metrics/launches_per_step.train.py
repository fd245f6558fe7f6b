"""``launches_per_step.train``: the kernel, copy and fill launches inside
``himo.train_step`` per traced step (``spans.launches_per_item``)."""

import spans


def read(ctx):
    return spans.launches_per_item(ctx, "himo.train_step")
