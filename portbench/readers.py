"""The per-layer readers' shared arithmetic: each ``metrics/<name>.py``
applies one of these to the run's context."""

import tracing
import work


def mfu(ctx):
    """The least time of one item's counted products at the card's peaks
    (``work``) over the measured time per item of the run's untraced
    window, in %."""
    window = ctx["window"]
    if not window["items"]:
        return None
    per_item = window["seconds"] / window["items"]
    return 100.0 * work.item_least_seconds(ctx["driver"].flops_per_item) / per_item


def kernel_roofline(ctx):
    """Over the traced items' calls of the kernel wrappers of
    ``himo_tpu_torch.ops``, the sum of each call's least time
    (``work.OP_RULES``, from its arguments) over the sum of the device
    time of what it launched, in %. A call whose launches the trace lost
    counts on neither side."""
    by_range = tracing.device_by_range(ctx["events"], tracing.OP_PREFIX)
    least = spent = 0.0
    for i, (name, call) in enumerate(ctx["calls"]):
        events = by_range.get(f"{tracing.OP_PREFIX}{name}#{i}", [])
        if not events:
            continue
        least += work.call_least_seconds(name, call)
        spent += sum(e["dur"] for e in events) / 1e6
    return 100.0 * least / spent if spent > 0 else None


def device_idle(ctx):
    """The share of an item's time in which no kernel, copy or fill ran on
    the device, in %: 1 less the device's busy time per traced item (the
    union of the trace's device intervals over the traced items) over the
    time per item of the same run's untraced window. The traced items' own
    wall would count the profiler's host cost as idle."""
    window = ctx["window"]
    if not window["items"] or not ctx["traced_items"] or ctx["busy_s"] <= 0:
        return None
    busy_per_item = ctx["busy_s"] / ctx["traced_items"]
    return 100.0 * (1.0 - busy_per_item / (window["seconds"] / window["items"]))
