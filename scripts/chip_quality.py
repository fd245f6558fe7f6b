#!/usr/bin/env python3
"""``chip_smoke.py``'s quality phase alone on one NVIDIA GPU: the device and
build phases, then ``phase_quality`` (``scripts/torch_quality_evidence.py``'s
``run_one`` on three scenes of the benchmark suite, one epoch of
``seflowpp``, the optimisation estimators, the evaluations and both
diagnostics), in a temporary directory that is also the working directory
of the evaluations.

    python3 scripts/chip_quality.py

Prints what ``phase_quality`` prints and the phase's launches.
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
    root = Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory(prefix="himo_quality_") as tmp:
        launches = cs.phase_quality(device, smi, root, Path(tmp) / "quality")
    print({k: v for k, v in launches.items() if v})
    print(f"total {time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
