"""The benchmark of ``himo_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload seflowpp-512.infer-65k --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` traces the window's first items and reports its
per-layer metrics. Either way the answers the window produced are checked
against the plain reference once the window has closed. The last line of
standard output is the result as JSON; the numbers compared, each with its
limit, are the last lines of standard error.

Exits 2 without a result when CUDA is absent or has fewer devices than the
cell asks for, and 3 when a JAX module or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from harness import banned_modules, load_cell, run

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), T_START, log)
    banned = banned_modules()
    if banned:
        log(f"the run loaded {banned}: the benchmark may load neither JAX nor the JAX package")
        return 3
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
