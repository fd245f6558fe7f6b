"""Scene-file migration / repair tool (port of ``himo_tpu/cli/repack_h5.py``).

Functional equivalent of the reference's ``tools/test/repack_h5_scania.py``
(:23-94): walk every scene, fix dtypes to the canonical schema (e.g. legacy
uint32 ids -> int64 for torch-compat consumers), rename legacy keys
(``SensorsCenter`` -> ``lidar_center`` with 4x4-ification), and drop keys on
request. Per-scene failures are reported and skipped (repack_h5_scania.py's
exception-swallowing behavior, SURVEY.md §5). Where the JAX package edits
each file in h5py's append mode, this one rewrites a changed scene whole
(:func:`~himo_tpu_torch.data.schema.rewrite_scene`); every dataset it does
not change keeps its bytes.

    python -m himo_tpu_torch.cli.repack_h5 data_dir=... drop_keys='["old_key"]'
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from himo_tpu_torch.data import h5
from himo_tpu_torch.data.schema import rewrite_scene
from himo_tpu_torch.utils.cli import run_cli

RENAMES: Dict[str, str] = {"SensorsCenter": "lidar_center"}
DTYPE_FIXES: Dict[str, str] = {"flow_instance_id": "int64"}


def _fix_center(value: np.ndarray) -> np.ndarray:
    """Legacy (L, 3) sensor centers -> (L, 4, 4) extrinsic matrices."""
    if value.ndim == 2 and value.shape[1] == 3:
        out = np.tile(np.eye(4, dtype=np.float32), (len(value), 1, 1))
        out[:, :3, 3] = value
        return out
    return value.astype(np.float32)


def repack_scene(path, drop_keys: Sequence[str] = ()) -> int:
    """Apply the renames, dtype fixes and drops to one scene file; returns
    the number of datasets changed (the file is rewritten only if any)."""
    changed = 0
    updates: Dict[str, dict] = {}
    with h5.File(path) as f:
        for group_key in f.keys():
            g = f[group_key]
            names = set(g.keys())
            new: dict = {}  # name -> array written, or None where removed

            def value(key):
                return new[key] if key in new else g[key][()]

            for old, renamed in RENAMES.items():
                if old in names:
                    data = value(old)
                    if old == "SensorsCenter":
                        data = _fix_center(data)
                    new[renamed], new[old] = data, None
                    names.discard(old)
                    names.add(renamed)
                    changed += 1
            for key, dtype in DTYPE_FIXES.items():
                if key in names:
                    current = new[key].dtype if key in new else g[key].dtype
                    if current != np.dtype(dtype):
                        new[key] = value(key).astype(dtype)
                        changed += 1
            for key in drop_keys:
                if key in names:
                    new[key] = None
                    names.discard(key)
                    changed += 1
            if new:
                updates[group_key] = new
    if updates:
        rewrite_scene(path, updates)
    return changed


def main(data_dir: str = "", drop_keys=()):
    if isinstance(drop_keys, str):
        drop_keys = [drop_keys]
    total = 0
    for path in sorted(Path(data_dir).glob("*.h5")):
        try:
            n = repack_scene(path, drop_keys)
            total += n
            print(f"{path.name}: {n} changes")
        except Exception as exc:  # keep going on per-scene corruption
            print(f"[ERROR] {path.name}: {exc}")
    print(f"Repacked {total} datasets total.")
    return total


if __name__ == "__main__":
    run_cli(main)
