"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
items, the harness's own host ranges, a range around each call of a
kernel wrapper of ``himo_tpu_torch.ops``, and the reductions the per-layer
readers share.

The lead-fill guard, the busy-time union and the correlation of device
events to host ranges are copies of ``chip_smoke.py``'s ``traced``,
``without_lead``, ``_busy_ms`` and ``split_calls``: a trace now and then
drops a block of its first device events, so it opens with one-element
fills whose events are left out.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

from work import ID_ARGS, OP_RULES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LEAD_LABEL = "pb.lead"
LEAD_FILLS = 2048
HOST_PREFIX = "pb.host:"  # the harness's host ranges: upload, entry, readback, ...
ITEM_LABEL = "pb.item"
OP_PREFIX = "pb.op:"  # pb.op:<wrapper>#<call>
TRAIL_S = 0.01
OPS_PACKAGE = "himo_tpu_torch"


class Tracer:
    """Host ranges and op ranges for one run; inert unless :meth:`traced`
    is active."""

    def __init__(self):
        self.active = False
        self.calls = []  # (wrapper name, recorded call)

    @contextlib.contextmanager
    def host(self, name: str):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(HOST_PREFIX + name):
            yield

    @contextlib.contextmanager
    def item(self):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(ITEM_LABEL):
            yield

    def _wrap(self, name: str, fn):
        def ranged(*args, **kwargs):
            call = {"shapes": [tuple(a.shape) if isinstance(a, torch.Tensor) else None
                               for a in args],
                    "ints": [a for a in args if isinstance(a, int) and not isinstance(a, bool)]}
            at = ID_ARGS.get(name)
            if at is not None:
                call["ids"] = args[at[0]]
                call["rows"] = call["ints"][at[1]] if at[1] is not None else args[0].shape[1]
            self.calls.append((name, call))
            with torch.profiler.record_function(f"{OP_PREFIX}{name}#{len(self.calls) - 1}"):
                return fn(*args, **kwargs)

        # The wrapper carries the wrapped function's attributes (its
        # ``launches`` counter), which the wrapped body updates by name.
        return functools.update_wrapper(ranged, fn)

    @contextlib.contextmanager
    def op_ranges(self):
        """Wrap every kernel wrapper named in ``work.OP_RULES`` wherever a
        module of the program holds it; restored on exit."""
        patched = []
        originals = {}
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or mod_name.split(".")[0] != OPS_PACKAGE:
                continue
            for name in OP_RULES:
                fn = getattr(mod, name, None)
                if fn is None or not callable(fn):
                    continue
                if mod_name.startswith(OPS_PACKAGE + ".ops.") and name not in originals:
                    originals[name] = fn
                patched.append((mod, name, fn))
        wrappers = {name: self._wrap(name, fn) for name, fn in originals.items()}
        for mod, name, fn in patched:
            if originals.get(name) is fn:
                setattr(mod, name, wrappers[name])
        try:
            yield
        finally:
            for mod, name, fn in patched:
                setattr(mod, name, fn)

    def finish_calls(self) -> list:
        """The recorded calls with their id counts taken (after the trace)."""
        out = []
        for name, call in self.calls:
            ids = call.pop("ids", None)
            if ids is not None:
                rows = call.pop("rows")
                ids = ids.to(torch.int64)
                live = (ids >= 0) & (ids < rows)
                call["live"] = int(live.sum())
                base = torch.arange(ids.shape[0], device=ids.device)[:, None] * rows
                call["reached"] = int(torch.unique((base + ids)[live]).numel())
            out.append((name, call))
        self.calls = []
        return out

    def traced(self, fn):
        """``(fn(), events)``: ``fn`` under ``torch.profiler`` with the
        host and op ranges on, opened by ``LEAD_FILLS`` fills whose device
        events are left out; fails when every fill lost its event."""
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        fill = torch.empty(1, device="cuda" if cuda else "cpu")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        if cuda:
            torch.cuda.synchronize()
        self.active = True
        try:
            with self.op_ranges(), profile(activities=activities) as prof:
                with record_function(LEAD_LABEL):
                    for _ in range(LEAD_FILLS):
                        fill.zero_()
                out = fn()
                if cuda:
                    torch.cuda.synchronize()
                time.sleep(TRAIL_S)
        finally:
            self.active = False
        events, kept = without_lead(trace_events(prof))
        if cuda and kept == 0:
            raise RuntimeError(f"the trace lost the device events of all {LEAD_FILLS} "
                               f"fills that open it")
        return out, events


def trace_events(prof) -> list:
    """The complete events of a finished trace (chrome-trace dicts)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _is_range(e, name=None, prefix=None) -> bool:
    if e.get("cat", "").lower() != "user_annotation":
        return False
    n = e.get("name", "")
    return n == name if name is not None else n.startswith(prefix)


def without_lead(events: list):
    """``(events, kept)``: the trace without the device events launched in
    its ``LEAD_LABEL`` range, and how many of those it held."""
    lead = next((e for e in events if _is_range(e, LEAD_LABEL)), None)
    if lead is None:
        return events, 0
    lo, hi = lead["ts"], lead["ts"] + lead["dur"]
    corr = {e["args"]["correlation"] for e in events if e.get("cat") in LAUNCH_CATS
            and "correlation" in e.get("args", {}) and lo <= e["ts"] <= hi}
    rest = [e for e in events if e.get("cat") not in DEVICE_CATS
            or e.get("args", {}).get("correlation") not in corr]
    return rest, len(events) - len(rest)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_events(events: list) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def window(events: list):
    """(start, end) in us of the traced items: the first item range's
    start to the last one's end."""
    items = [(e["ts"], e["ts"] + e["dur"]) for e in events if _is_range(e, ITEM_LABEL)]
    if not items:
        raise RuntimeError("the trace holds no item range")
    return min(a for a, _ in items), max(b for _, b in items)


def busy_in_window(events: list):
    """(busy s, window s): the union of the device intervals clipped to
    the items' window, and the window's length."""
    lo, hi = window(events)
    clipped = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device_events(events)
               if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    return union_us(clipped) / 1e6, (hi - lo) / 1e6


def device_by_range(events: list, prefix: str) -> dict:
    """range name -> the device events launched inside it: a device event
    belongs to the range whose host interval holds its launch (the host
    API call with the same correlation id), the innermost one that starts
    last."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if _is_range(e, prefix=prefix))
    starts = [a for a, _, _ in ranges]
    owner = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            at = bisect.bisect_right(starts, e["ts"]) - 1
            while at >= 0 and ranges[at][1] < e["ts"]:
                at -= 1
            if at >= 0:
                owner[corr] = ranges[at][2]
    out = {name: [] for _, _, name in ranges}
    for e in device_events(events):
        name = owner.get(e.get("args", {}).get("correlation"))
        if name is not None:
            out[name].append(e)
    return out


def short_name(name: str) -> str:
    bare = re.sub(r"^(void )?\(anonymous namespace\)::", "", name)
    return bare.split("<")[0].split("(")[0].strip()[:80]


def breakdown(events: list) -> dict:
    """The ten device operations with the most time in the items' window,
    and its ten longest idle gaps, each named by the harness's host range
    open at the gap's middle."""
    lo, hi = window(events)
    dev = [e for e in device_events(events) if lo <= e["ts"] <= hi]
    by_name = {}
    for e in dev:
        key = short_name(e["name"])
        by_name[key] = by_name.get(key, 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], lo
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    hosts = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(HOST_PREFIX):])
                   for e in events if _is_range(e, prefix=HOST_PREFIX))

    def doing(t):
        name = "loop"
        for a, b, n in hosts:
            if a <= t <= b:
                name = n
        return name

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[doing((a + b) / 2), (b - a) / 1e6] for a, b in longest]}

