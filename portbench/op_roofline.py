"""One kernel wrapper's share of its roofline, for the ``<kernel>_roofline``
readers: ``readers.kernel_roofline`` over that wrapper's calls alone."""

from __future__ import annotations

import tracing
import work


def op_roofline(ctx: dict, op: str):
    """Over the traced items' calls of the wrapper ``op``, the sum of each
    call's least time (``work.call_least_seconds``) over the sum of the
    device time of what it launched, in %; None where no call's launches
    reached the trace."""
    by_range = tracing.device_by_range(ctx["events"], tracing.OP_PREFIX)
    least = spent = 0.0
    for i, (name, call) in enumerate(ctx["calls"]):
        if name != op:
            continue
        events = by_range.get(f"{tracing.OP_PREFIX}{name}#{i}", [])
        if not events:
            continue
        least += work.call_least_seconds(name, call)
        spent += sum(e["dur"] for e in events) / 1e6
    return 100.0 * least / spent if spent > 0 else None
