"""AV2 sensor logs -> .h5 scenes CLI (port of ``himo_tpu/cli/extract_av2.py``):

    python -m himo_tpu_torch.cli.extract_av2 origin_data=/data/av2/sensor/val \\
        output_dir=/data/av2/h5 nproc=8
    python -m himo_tpu_torch.cli.extract_av2 output_dir=... create_index_only=True

Logs go to ``nproc`` spawned worker processes (one log each at a time),
then the reading index is built. The box test and the ground mask run on
the GPU, one CUDA context per worker; ``device=cpu`` runs them on the CPU
(without CUDA and without ``device=cpu`` it raises).
"""

from __future__ import annotations

import multiprocessing
import os
from pathlib import Path

from himo_tpu_torch.utils.cli import run_cli


def _proc(item):
    from himo_tpu_torch.data.av2 import process_log

    args, device = item
    return process_log(*args, device=device)


def main(
    origin_data: str = "",
    output_dir: str = "",
    nproc: int = max(multiprocessing.cpu_count() - 1, 1),
    create_index_only: bool = False,
    device=None,
):
    from himo_tpu_torch.data.index import create_reading_index
    from himo_tpu_torch.models.feedforward import resolve_device

    if create_index_only:
        create_reading_index(Path(output_dir))
        return
    device = str(resolve_device(device))

    logs = sorted(
        d
        for d in os.listdir(origin_data)
        if (Path(origin_data) / d / "sensors" / "lidar").is_dir()
    )
    args = [((Path(origin_data) / log, Path(output_dir), log), device) for log in logs]
    print(f"Using {nproc} processes for {len(logs)} AV2 logs.")
    if nproc <= 1:
        for a in args:
            _proc(a)
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes=nproc) as pool:
            list(pool.imap_unordered(_proc, args))
    create_reading_index(Path(output_dir))


if __name__ == "__main__":
    run_cli(main)
