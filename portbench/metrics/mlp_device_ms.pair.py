"""``mlp_device_ms.pair``: the device ms launched inside ``himo.mlp``
(its own events) per traced Adam step (``estimate_spans.stage_device_ms``)."""

import estimate_spans


def read(ctx):
    return estimate_spans.stage_device_ms(ctx, "himo.mlp")
