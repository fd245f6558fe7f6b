"""Raw Scania superframes -> .h5 scenes with GT-flow autolabels (port of
``himo_tpu/cli/extract_scania.py``), the reference's
``dataprocess/extract_sca.py::main``:

    python -m himo_tpu_torch.cli.extract_scania origin_data=... metadata_pkl=... \\
        output_dir=... nproc=16
    python -m himo_tpu_torch.cli.extract_scania output_dir=... create_index_only=True

Scenes go to ``nproc`` spawned worker processes; completed scenes are
skipped (idempotent resume); the reading index is built at the end. The box
test and the ground mask run on the GPU, one CUDA context per worker;
``device=cpu`` runs them on the CPU (without CUDA and without
``device=cpu`` it raises).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
from pathlib import Path

from himo_tpu_torch.utils.cli import run_cli


def _proc(item):
    from himo_tpu_torch.data.scania import process_scene

    args, device = item
    return process_scene(*args, device=device)


def main(
    origin_data: str = "",
    metadata_pkl: str = "",
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

    with open(metadata_pkl, "rb") as f:
        metadata = pickle.load(f)

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    scenes, metas = [], []
    for scene_id in sorted(os.listdir(origin_data)):
        if not os.path.isdir(os.path.join(origin_data, scene_id)):
            continue
        if "batch" not in scene_id:
            continue
        meta = [m for m in metadata if m.get("sample_idx") == scene_id]
        if meta:
            scenes.append(scene_id)
            metas.append(meta)

    args = [
        ((origin_data, Path(output_dir), scenes[i], metas[i]), device)
        for i in range(len(scenes))
    ]
    print(f"Using {nproc} processes for creating {len(scenes)} scenes.")
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
