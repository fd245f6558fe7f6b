#!/usr/bin/env python3
"""Hold the kernel wrappers' host cost per call against another
checkout's, and against this checkout's with the launch helper's device
guard taken out, on one NVIDIA GPU.

    python3 scripts/host_cost_ab.py ROOT

First ``PAIRS`` (12) pairs of processes, each ``python3
chip_smoke.py --host-cost R`` (every wrapper's host microseconds per call
at the tiny shape, ``chip_smoke.wrapper_host_us``), for R this checkout and
ROOT; this checkout runs first in the even pairs and ROOT in the odd ones.
Then, in one process, this checkout's wrappers in turns with
``_build.Entry.launch`` as it is and with a launch that calls the entry
point on the given device's stream without the device guard (the launch
as it was before the guard), ``PAIRS`` turns a side, alternating which goes
first. For each wrapper the median and quartiles of each side and the
median of the paired differences are printed; the whole goes to
standard output as JSON lines and to ``chiprun_out/host_cost_ab.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

PAIRS = 12


def summary(runs: list, other: list | None = None) -> dict:
    """Each wrapper's median and quartiles (µs) over ``runs`` (dicts of
    wrapper -> µs), and with ``other`` the median of the differences
    ``runs[k] - other[k]``."""
    out = {}
    for name in runs[0]:
        xs = [r[name] for r in runs]
        q1, _, q3 = statistics.quantiles(xs, n=4)
        out[name] = dict(median=statistics.median(xs), q1=q1, q3=q3)
        if other is not None:
            out[name]["median_diff"] = statistics.median(
                r[name] - o[name] for r, o in zip(runs, other))
    return out


def process_pairs(root: Path, pairs: int) -> dict:
    """``chip_smoke.py --host-cost`` of this checkout and of ``root`` in
    ``pairs`` pairs of processes, alternating which runs first."""
    runs = {"this": [], "root": []}
    for k in range(pairs):
        order = [("this", HERE), ("root", root)]
        for label, path in order if k % 2 == 0 else order[::-1]:
            got = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"), "--host-cost",
                                  str(path)], capture_output=True, text=True)
            if got.returncode != 0:
                raise RuntimeError(f"chip_smoke.py --host-cost {path}: rc {got.returncode}\n"
                                   f"{got.stderr[-2000:]}")
            runs[label].append(json.loads(got.stdout.strip().splitlines()[-1])["host_us"])
    return runs


def guard_turns(device, turns: int) -> dict:
    """This checkout's ``wrapper_host_us`` with the device guard and
    without it, in ``turns`` turns a side, alternating which goes first."""
    from himo_tpu_torch.kernels import _build

    guarded = _build.Entry.launch

    def unguarded(self, device_index, *args):
        fn = self._fn or self.bind()
        _build.check(fn(*args, self._stream(device_index)), self.name)

    runs = {"guard": [], "no guard": []}
    sides = [("guard", guarded), ("no guard", unguarded)]
    try:
        for k in range(turns):
            for label, launch in sides if k % 2 == 0 else sides[::-1]:
                _build.Entry.launch = launch
                runs[label].append(cs.wrapper_host_us(device))
    finally:
        _build.Entry.launch = guarded
    return runs


def main(argv) -> int:
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print("usage: host_cost_ab.py ROOT (needs a CUDA device)", file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    device, smi = cs.phase_device()
    cs.phase_build()
    processes = process_pairs(root, PAIRS)
    turns = guard_turns(device, PAIRS)
    result = dict(card=smi, pairs=PAIRS, root=str(root),
                  processes=dict(this=summary(processes["this"], processes["root"]),
                                 root=summary(processes["root"])),
                  in_process=dict(guard=summary(turns["guard"], turns["no guard"]),
                                  no_guard=summary(turns["no guard"])),
                  raw=dict(processes=processes, in_process=turns))
    for name in result["processes"]["this"]:
        this, there = result["processes"]["this"][name], result["processes"]["root"][name]
        on, off = result["in_process"]["guard"][name], result["in_process"]["no_guard"][name]
        cs.log(f"{name}: processes this {this['median']:.2f} [{this['q1']:.2f}, "
               f"{this['q3']:.2f}] root {there['median']:.2f} [{there['q1']:.2f}, "
               f"{there['q3']:.2f}] paired diff {this['median_diff']:+.2f}; one process "
               f"guard {on['median']:.2f} [{on['q1']:.2f}, {on['q3']:.2f}] no guard "
               f"{off['median']:.2f} [{off['q1']:.2f}, {off['q3']:.2f}] paired diff "
               f"{on['median_diff']:+.2f} us")
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "host_cost_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in ("card", "pairs", "processes", "in_process")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
