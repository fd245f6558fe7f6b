"""The readers of the runtime-optimisation estimators' spans in a
``--trace 1`` run's events: ``himo.estimate`` at the root (one estimator
call, one frame pair), ``himo.mlp``, ``himo.chamfer``, ``himo.backward``
and ``himo.adam`` inside it, per Adam step.

``spans.summarize`` finds only the roots it lists (``himo.frame``,
``himo.train_step``); :func:`summarize` is the same reduction for a named
root, with ``spans``' own helpers, and its table is ``spans``' table. Every
reader returns None when the trace holds no ``himo.estimate`` span: a
program without spans reports nothing.
"""

from __future__ import annotations

import spans
import tracing

ROOT = "himo.estimate"


def summarize(events: list, items: int, root: str = ROOT):
    """``spans.summarize``'s summary with ``root`` as the root, or None
    when the trace holds no such span."""
    ranges = spans._ranges(events, spans.PREFIX)
    if not any(name == root for _, _, name in ranges):
        return None
    starts = [a for a, _, _ in ranges]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in tracing.LAUNCH_CATS
                   and e.get("args", {}).get("correlation") is not None}
    device = tracing.device_events(events)
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_starts = [a for a, _ in busy]
    longest = max((e - s for s, e in busy), default=0.0)

    rows = {}
    for a, b, name in ranges:
        row = rows.setdefault(name, {"calls": 0, "device_us": 0.0, "launches": 0,
                                     "host_us": 0.0, "idle_us": 0.0, "intervals": []})
        row["calls"] += 1
        row["host_us"] += b - a
        row["idle_us"] += spans._idle_us(a, b, busy, busy_starts, longest)
        row["intervals"].append((a, b))
    for name, evs in tracing.device_by_range(events, spans.PREFIX).items():
        rows[name]["device_us"] = sum(e["dur"] for e in evs)
    root_launches = 0
    for e in events:
        if spans._is_launch(e):
            owner = spans._innermost(ranges, starts, e["ts"])
            if owner is not None:
                rows[owner]["launches"] += 1
            root_launches += spans._within(rows[root]["intervals"], e["ts"])

    launched = [(launched_at[c], e["dur"]) for e in device
                if (c := e.get("args", {}).get("correlation")) in launched_at]

    def launched_in(intervals) -> float:
        return sum(dur for at, dur in launched if spans._within(intervals, at))

    for row in rows.values():
        row["nested_us"] = launched_in(row["intervals"])
    items_ranges = [(a, b) for a, b, _ in spans._ranges(events, tracing.ITEM_LABEL)]
    return {"root": root, "items": items, "rows": rows, "root_launches": root_launches,
            "item_device_us": launched_in(items_ranges)}


def summary(ctx: dict):
    """The run's summary, made (and ``spans``' table printed) on the first
    read; its items are the traced pairs' Adam steps."""
    if "estimate_spans" not in ctx:
        items = ctx["traced_items"] * ctx["driver"].steps_per_item
        ctx["estimate_spans"] = summarize(ctx["events"], items)
        if ctx["estimate_spans"] is not None:
            spans._print_table(ctx["estimate_spans"])
    return ctx["estimate_spans"]


def launches_per_step(ctx: dict):
    """Launches inside ``himo.estimate`` per traced Adam step."""
    s = summary(ctx)
    return None if s is None else s["root_launches"] / s["items"]


def stage_device_ms(ctx: dict, name: str):
    """Device ms launched inside ``name`` (its innermost events) per traced
    Adam step."""
    s = summary(ctx)
    if s is None or name not in s["rows"]:
        return None
    return s["rows"][name]["device_us"] / s["items"] / 1e3
