"""The readers of the program's own spans (``himo_tpu_torch.utils.profiling
.span``: ``himo.frame`` and ``himo.train_step`` at the root, the model's
stages and the step's phases inside) in a ``--trace 1`` run's events.

- launches: the host's runtime and driver calls that launch a kernel, a
  copy or a fill (``*LaunchKernel*``, ``*Memcpy*``, ``*Memset*``) whose host
  time falls inside a root span, per traced batch or step;
- a stage's device ms: the device events (kernels, copies, fills)
  launched inside the stage's span, each given to the innermost ``himo.``
  span that holds its launch (``tracing.device_by_range``), per traced
  batch or step. Launches from autograd's device thread fall inside
  ``himo.backward`` by time.

Every reader returns None when the trace holds no root span: a program
without spans reports nothing. The first read of a run prints one table
of every ``himo.`` span on standard error.
"""

from __future__ import annotations

import bisect
import sys

import tracing

PREFIX = "himo."
ROOTS = ("himo.frame", "himo.train_step")
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")


def _is_launch(e: dict) -> bool:
    return e.get("cat") in tracing.LAUNCH_CATS and any(w in e.get("name", "")
                                                      for w in LAUNCH_WORDS)


def _ranges(events: list, prefix: str) -> list:
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if tracing._is_range(e, prefix=prefix))


def _innermost(ranges: list, starts: list, ts: float):
    """The name of the range that holds ``ts`` and starts last, or None
    (``tracing.device_by_range``'s rule)."""
    at = bisect.bisect_right(starts, ts) - 1
    while at >= 0 and ranges[at][1] < ts:
        at -= 1
    return ranges[at][2] if at >= 0 else None


def _within(intervals: list, ts: float) -> bool:
    """Whether ``ts`` lies in one of the sorted, disjoint ``intervals``."""
    at = bisect.bisect_right(intervals, (ts, float("inf"))) - 1
    return at >= 0 and ts <= intervals[at][1]


def _idle_us(a: float, b: float, busy: list, starts: list, longest: float) -> float:
    """The time in (a, b) that no device interval of ``busy`` (sorted by
    start) covers."""
    lo = bisect.bisect_left(starts, a - longest)
    hi = bisect.bisect_left(starts, b)
    covered = tracing.union_us((max(s, a), min(e, b)) for s, e in busy[lo:hi]
                               if e > a and s < b)
    return (b - a) - covered


def summarize(events: list, items: int):
    """Per ``himo.`` span name: calls, own device us and launches (the
    innermost span's), the device us launched anywhere inside it, and host
    us and device idle us (the span's whole wall, under the profiler);
    with the root's launches and the device us the traced items launched.
    None without a root span."""
    ranges = _ranges(events, PREFIX)
    root = next((r for r in ROOTS if any(name == r for _, _, name in ranges)), None)
    if root is None:
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
        row["idle_us"] += _idle_us(a, b, busy, busy_starts, longest)
        row["intervals"].append((a, b))
    for name, evs in tracing.device_by_range(events, PREFIX).items():
        rows[name]["device_us"] = sum(e["dur"] for e in evs)
    root_launches = 0
    for e in events:
        if _is_launch(e):
            owner = _innermost(ranges, starts, e["ts"])
            if owner is not None:
                rows[owner]["launches"] += 1
            root_launches += _within(rows[root]["intervals"], e["ts"])

    launched = [(launched_at[c], e["dur"]) for e in device
                if (c := e.get("args", {}).get("correlation")) in launched_at]

    def launched_in(intervals) -> float:
        """Device us of the events launched inside ``intervals``."""
        return sum(dur for at, dur in launched if _within(intervals, at))

    for row in rows.values():
        row["nested_us"] = launched_in(row["intervals"])
    items_ranges = [(a, b) for a, b, _ in _ranges(events, tracing.ITEM_LABEL)]
    return {"root": root, "items": items, "rows": rows, "root_launches": root_launches,
            "item_device_us": launched_in(items_ranges)}


def _print_table(s: dict) -> None:
    n = s["items"]
    root = s["rows"][s["root"]]
    inside, own = root["nested_us"], root["device_us"]
    lines = [f"[spans] {s['root']} over {n} traced item(s), per item: "
             f"{s['root_launches'] / n:.1f} launches; {inside / n / 1e3:.3f} device ms "
             f"launched inside it, {100 * inside / max(s['item_device_us'], 1e-9):.2f} % of "
             f"the items'; its own (outside every stage) {own / n / 1e3:.3f} ms, "
             f"{100 * own / max(inside, 1e-9):.2f} % of that",
             f"[spans] {'span':<18} {'calls':>6} {'own ms':>9} {'incl. ms':>9} "
             f"{'launches':>9} {'host ms (profiled)':>19} {'idle ms (profiled)':>19}"]
    for name, row in sorted(s["rows"].items(), key=lambda kv: kv[1]["intervals"][0][0]):
        lines.append(f"[spans] {name:<18} {row['calls'] / n:>6.2f} "
                     f"{row['device_us'] / n / 1e3:>9.3f} {row['nested_us'] / n / 1e3:>9.3f} "
                     f"{row['launches'] / n:>9.1f} {row['host_us'] / n / 1e3:>19.3f} "
                     f"{row['idle_us'] / n / 1e3:>19.3f}")
    lines.append("[spans] per item; own ms and launches: the span's innermost ones; incl. "
                 "ms: all launched inside it; host and idle ms: its wall under the profiler")
    print("\n".join(lines), file=sys.stderr, flush=True)


def summary(ctx: dict):
    """The run's span summary, made (and its table printed) on the first
    read; the traced items are the traced batches, or steps."""
    if "spans" not in ctx:
        items = ctx["traced_items"] * ctx["driver"].steps_per_item
        ctx["spans"] = summarize(ctx["events"], items)
        if ctx["spans"] is not None:
            _print_table(ctx["spans"])
    return ctx["spans"]


def launches_per_item(ctx: dict, root: str):
    """Launches inside ``root`` per traced batch or step."""
    s = summary(ctx)
    if s is None or s["root"] != root:
        return None
    return s["root_launches"] / s["items"]


def stage_device_ms(ctx: dict, root: str, name: str, nested: bool = False):
    """Device ms launched inside ``name`` per traced batch or step: its own
    (innermost) events, or with ``nested`` everything launched inside it."""
    s = summary(ctx)
    if s is None or s["root"] != root or name not in s["rows"]:
        return None
    row = s["rows"][name]
    return row["nested_us" if nested else "device_us"] / s["items"] / 1e3
