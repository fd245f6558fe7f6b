#!/usr/bin/env python3
"""Where torch.profiler loses the device events of short calls, on one
NVIDIA GPU.

    python3 scripts/torch_profiler_probe.py [--calls 100] [--ages 0,60,120]
        [--waits 0,2,20,200] [--bursts 0]

``chip_smoke.device_split`` traces 20 calls of a kernel, each in a
``record_function`` range of its own, and ties each device event to its
call through the launch's correlation id. On short calls (tens of us) the
first calls of a trace now and then come back with no device event at all,
the later ones whole. This script traces, for two calls of that kind,

- ``add``: PyTorch's own elementwise add on 262,144 floats, and
- ``k5``: ``sorted_gather_rows`` (K5) at the downstream shape, 1 x 32,768
  ids sorted over 512^2 rows of 64 channels,

``--calls`` calls a trace, with each wait in ``--waits`` (ms) between the
trace's start and the first call (the device idle), after each burst in
``--bursts`` of that many one-element fills (a kernel of PyTorch's own, one
device event each) launched first in the trace, at each process age in
``--ages`` (seconds since the first trace). Per trace it writes one JSON
object: the calls that kept no device event (``lost``, and which:
``lost_at``) and how many of
those also lost their launch's runtime event (``lost_launch``); the
burst's fills that kept no device event (``burst_lost``); the time
from the trace's start to the first call that kept its events
(``first_kept_us``, host clock); and, over the calls that kept both, the
least and median time from the launch to its kernel's start
(``launch_to_kernel_us``; negative means that the device's timestamps run
behind the host's). All objects go to standard output and to
``chiprun_out/profiler_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _inputs(device):
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    rows, n, c = 512 * 512, 32768, 64
    pids = torch.randint(0, rows, (1, n), device=device, generator=gen, dtype=torch.int32)
    spids, order = torch.sort(pids, dim=1, stable=True)
    image = torch.randn(1, rows, c, device=device, generator=gen)
    x = torch.randn(262144, device=device, generator=gen)
    return image, spids.contiguous(), order.to(torch.int32).contiguous(), x


def trace(fn, calls: int, wait_ms: float, burst: int = 0) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs

    fill = torch.empty(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(wait_ms / 1e3)
        with record_function(f"{cs.SPLIT_LABEL}{calls}"):
            for _ in range(burst):
                fill.zero_()
        for i in range(calls):
            with record_function(f"{cs.SPLIT_LABEL}{i}"):
                fn()
        torch.cuda.synchronize()
    events = cs._trace_events(prof)
    per_call = cs.split_calls(events, range(calls + 1))
    burst_kept = len(per_call.pop())
    starts = {int(e["name"][len(cs.SPLIT_LABEL):]): e["ts"] for e in events
              if e.get("name", "").startswith(cs.SPLIT_LABEL)
              and e.get("cat", "").lower() == "user_annotation"
              and int(e["name"][len(cs.SPLIT_LABEL):]) < calls}
    trace_start = min(e["ts"] for e in events)
    launches = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in cs.LAUNCH_CATS and corr is not None and "aunch" in e["name"]:
            launches[corr] = e
    # A call's own launches: the runtime events inside its range.
    ends = sorted(starts.items())
    launched = [0] * calls
    for e in launches.values():
        for i, t in reversed(ends):
            if e["ts"] >= t:
                launched[i] += 1
                break
    lost = [i for i, c in enumerate(per_call) if not c]
    kept = [i for i, c in enumerate(per_call) if c]
    gaps = [k["ts"] - launches[k["args"]["correlation"]]["ts"]
            for i in kept for k in per_call[i]]
    return dict(
        lost=len(lost), lost_at=lost, burst_lost=burst - burst_kept,
        lost_launch=sum(1 for i in lost if launched[i] == 0),
        first_kept=kept[0] if kept else None,
        first_kept_us=(starts[kept[0]] - trace_start) if kept else None,
        last_lost_us=(starts[lost[-1]] - trace_start) if lost else None,
        launch_to_kernel_us=dict(min=min(gaps), median=statistics.median(gaps)) if gaps else None,
        device_events=sum(len(c) for c in per_call))


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=100)
    parser.add_argument("--ages", default="0,60,120")
    parser.add_argument("--waits", default="0,2,20,200")
    parser.add_argument("--bursts", default="0")
    args = parser.parse_args(argv)
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    device = torch.device("cuda")
    image, spids, order, x = _inputs(device)
    fns = {"add": lambda: x + 1.0,
           "k5": lambda: pvox.sorted_gather_rows(image, spids, order)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    records = []
    begin = time.monotonic()
    for age in (float(a) for a in args.ages.split(",")):
        time.sleep(max(0.0, age - (time.monotonic() - begin)))
        for name, fn in fns.items():
            for wait_ms in (float(w) for w in args.waits.split(",")):
                for burst in (int(b) for b in args.bursts.split(",")):
                    rec = dict(name=name, age_s=round(time.monotonic() - begin, 1),
                               wait_ms=wait_ms, burst=burst, calls=args.calls,
                               **trace(fn, args.calls, wait_ms, burst))
                    print(json.dumps(rec), flush=True)
                    records.append(rec)
    (out_dir / "profiler_probe.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
