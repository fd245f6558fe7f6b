"""``optimizer_device_ms.train``: the device ms launched inside ``himo.optimizer``
(its own events), per traced step (``spans.stage_device_ms``)."""

import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "himo.train_step", "himo.optimizer")
