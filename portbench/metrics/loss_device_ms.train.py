"""``loss_device_ms.train``: the device ms launched inside ``himo.loss``
(its own events), per traced step (``spans.stage_device_ms``)."""

import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "himo.train_step", "himo.loss")
