"""The readings that a cell's limits are set from, in one process: for
each seed, a short window of the program at the cell's size, then the
compared numbers of the program's answers and of the control (the
reference one precision below the configuration's: an fp8 backbone for
bf16, TF32 for float32) against the reference.

    python3 portbench/control.py --workload seflowpp-512.infer-65k \
        --seeds 11,12,13 --items 8

Prints one JSON line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def readings(cell, seed: int, items: int) -> dict:
    import harness
    from tracing import Tracer

    cell.seed = seed
    kind = harness.HERE / "drivers" / f"{cell.traffic['kind']}.py"
    out = {"seed": seed}
    for control in (False, True):
        driver = harness.load_module(kind).setup(cell, Tracer())
        t0 = time.perf_counter()
        for i in range(items):
            driver.item(i)
        out["window_s" if not control else "control_window_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compared = driver.check(control=control)
        key = "control" if control else "program"
        out[key] = {name: c["value"] for name, c in compared.items()}
        out[key + "_check_s"] = time.perf_counter() - t0
        del driver
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--items", type=int, default=4)
    args = parser.parse_args(argv)
    import harness

    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.items)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
