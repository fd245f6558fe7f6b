"""``pillarize_device_ms.infer``: the device ms launched inside ``himo.pillarize``
(its own events), per traced batch (``spans.stage_device_ms``)."""

import spans


def read(ctx):
    return spans.stage_device_ms(ctx, "himo.frame", "himo.pillarize")
