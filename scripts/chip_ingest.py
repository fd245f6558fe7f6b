#!/usr/bin/env python3
"""``chip_smoke.py``'s ingestion phase alone on one NVIDIA GPU: the device
and build phases, then ``phase_ingest`` (raw AV2 and Scania logs written,
extracted on the card and on the CPU, checked, then ``cli.save`` and
``cli.eval`` on the AV2 scenes), in a temporary directory.

    python3 scripts/chip_ingest.py

Prints what ``phase_ingest`` prints and the launches of its ``cli.save``.
The guard below is needed: ``extract_scania``'s spawn pool imports the
main module again in each worker.
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
    with tempfile.TemporaryDirectory(prefix="himo_ingest_") as tmp:
        launches = cs.phase_ingest(device, smi, Path(tmp) / "ingest")
    print({k: v for k, v in launches.items() if v})
    print(f"total {time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
