"""``launches_per_step.pair``: the kernel, copy and fill launches inside
``himo.estimate`` per traced Adam step (``estimate_spans.launches_per_step``)."""

import estimate_spans


def read(ctx):
    return estimate_spans.launches_per_step(ctx)
