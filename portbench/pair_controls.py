"""The readings that the ``pair`` cells' limits are set from, in one
process: for each seed, a short window of the program at the cell's size
and its check, then each control's.

- ``tf32``: the plain reference with its MLP products in TF32 (the
  precision below the configuration's float32) stands in for the
  program's first steps (``check(control=True)``);
- ``atomic``: after set-up, the program's K3 sum (``ops.nn.segment_rows_sum``)
  adds by fp32 atomics in no fixed order, as ``csrc/scatter_sum.cu`` adds
  for K1 sum, through the window and the check's repeat of each pair;
- ``late_lr``: from its 100th update on, each optimizer of the program
  updates at half its rate (a fault that only the run's end shows).

    python3 portbench/pair_controls.py --workload nsfp-cold.pair-65k \\
        --seeds 11,12,13 --items 2 --sample 2

Prints one JSON line per seed.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


@contextlib.contextmanager
def atomic_sum():
    """``ops.nn.segment_rows_sum`` by the atomic kernel for the block
    (K1 sum's entry point); on the CPU, which has no atomics, a sum in a
    fresh random order of the points each call."""
    import torch

    from himo_tpu_torch.ops import nn, voxelize

    def unordered(vals, idx, num_segments):
        if vals.is_cpu:
            perm = torch.randperm(vals.shape[1])
            return nn._segment_rows_sum_plain(vals[:, perm], idx[:, perm], num_segments)
        return voxelize._run_rows_kernel(voxelize._SCATTER_SUM, idx, vals, num_segments)

    saved = nn.segment_rows_sum
    nn.segment_rows_sum = unordered
    try:
        yield
    finally:
        nn.segment_rows_sum = saved


@contextlib.contextmanager
def late_rate(after: int = 100, factor: float = 0.5):
    """Each ``torch.optim`` optimizer's rate times ``factor`` from its
    update ``after + 1`` on."""
    from torch.optim import optimizer

    def pre(opt, args, kwargs):
        first = opt.param_groups[0]["params"][0]
        state = opt.state.get(first)
        if state and int(state["step"]) == after:
            for group in opt.param_groups:
                group["lr"] *= factor

    handle = optimizer.register_optimizer_step_pre_hook(pre)
    try:
        yield
    finally:
        handle.remove()


def _window(driver, items: int) -> float:
    t0 = time.perf_counter()
    for i in range(items):
        driver.item(i)
    return time.perf_counter() - t0


def _values(compared: dict) -> dict:
    return {name: c["value"] for name, c in compared.items()}


def readings(cell, seed: int, items: int) -> dict:
    import harness
    from tracing import Tracer

    cell.seed = seed
    kind = harness.HERE / "drivers" / f"{cell.traffic['kind']}.py"
    out = {"seed": seed}
    driver = harness.load_module(kind).setup(cell, Tracer())
    out["window_s"] = _window(driver, items)
    out["program"] = _values(driver.check())
    out["tf32"] = _values(driver.check(control=True))
    del driver
    driver = harness.load_module(kind).setup(cell, Tracer())
    with atomic_sum():
        out["atomic_window_s"] = _window(driver, items)
        out["atomic"] = _values(driver.check())
    del driver
    with late_rate():
        driver = harness.load_module(kind).setup(cell, Tracer())
        _window(driver, items)
        out["late_lr"] = _values(driver.check())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--items", type=int, default=2)
    parser.add_argument("--sample", type=int, default=None,
                        help="pairs the check samples (default: the cell's)")
    args = parser.parse_args(argv)
    import harness

    cell = harness.load_cell(args.workload)
    if args.sample:
        cell.traffic["sample"] = args.sample
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.items)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
