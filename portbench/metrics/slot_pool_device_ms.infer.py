"""``slot_pool_device_ms.infer``: the device ms launched inside ``himo.slot_pool``
(its own events), per traced batch (``spans.stage_device_ms``)."""

import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "himo.frame", "himo.slot_pool")
