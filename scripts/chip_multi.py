#!/usr/bin/env python3
"""``chip_smoke.py``'s data-parallel phase alone on one NVIDIA GPU: the
device and build phases, ``phase_fleet`` (its scenes and one-rank flows are
what the fleet across ranks is held against), then ``phase_data_parallel``:
(a) the 512x512 train step through the mesh at one NCCL rank, (b) the same
step split over two gloo ranks on the one card, (c) the fleet across those
two ranks; in a temporary directory.

    python3 scripts/chip_multi.py

Prints what the phases print, the launches of each part and the total
seconds. The guard below is needed: the ranks are spawned processes, which
import the main module again.
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    start = time.perf_counter()
    device, smi = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="himo_multi_") as tmp:
        fleet_root = Path(tmp) / "av2_fleet"
        cs.phase_fleet(device, smi, fleet_root)
        for part in cs.phase_data_parallel(device, smi, fleet_root, Path(tmp)):
            print({k: v for k, v in part.items() if v})
    print(f"total {time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
