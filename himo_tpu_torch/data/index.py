"""Reading indices for .h5 scene directories (port of
``himo_tpu/data/index.py``; the same pickles).

``index_total.pkl`` is a list of ``[scene_id, timestamp]`` pairs covering every
frame; ``index_eval.pkl`` is the evaluation subset. This is the surface of the
reference's ``dataprocess.misc_data.create_reading_index`` (consumed at
dataprocess/extract_sca.py:284) and ``tools/pkl_extract.py:5-19``.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional, Sequence

from himo_tpu_torch.data import h5

INDEX_TOTAL = "index_total.pkl"
INDEX_EVAL = "index_eval.pkl"


def create_reading_index(data_dir, save: bool = True) -> List[list]:
    """Scan all .h5 scenes and build the [scene_id, timestamp] frame index."""
    data_dir = Path(data_dir)
    index: List[list] = []
    for h5_path in sorted(data_dir.glob("*.h5")):
        with h5.File(h5_path) as f:
            timestamps = sorted(f.keys(), key=_timestamp_sort_key)
            for ts in timestamps:
                index.append([h5_path.stem, _parse_timestamp(ts)])
    if save:
        with open(data_dir / INDEX_TOTAL, "wb") as f:
            pickle.dump(index, f)
    return index


def _timestamp_sort_key(ts: str):
    try:
        return (0, int(ts))
    except ValueError:
        return (1, ts)


def _parse_timestamp(ts: str):
    """Int when round-trippable; keep the raw string otherwise (group keys
    like '000123' with leading zeros must survive index -> reader)."""
    try:
        value = int(ts)
    except ValueError:
        return ts
    return value if str(value) == ts else ts


def load_index(data_dir, name: str = INDEX_TOTAL) -> List[list]:
    with open(Path(data_dir) / name, "rb") as f:
        return pickle.load(f)


def save_index(index: Sequence, data_dir, name: str) -> None:
    with open(Path(data_dir) / name, "wb") as f:
        pickle.dump(list(index), f)


def extract_eval_index(
    data_dir,
    scene_ids: Optional[Sequence[str]] = None,
    every_n: int = 1,
    max_frames: Optional[int] = None,
) -> List[list]:
    """Subset ``index_total.pkl`` into ``index_eval.pkl``.

    Equivalent role to tools/pkl_extract.py:5-19 (the demo-subset tool), with
    scene filtering and striding for building small eval sets.
    """
    total = load_index(data_dir)
    subset = [
        entry
        for i, entry in enumerate(total)
        if (scene_ids is None or entry[0] in scene_ids) and i % every_n == 0
    ]
    if max_frames is not None:
        subset = subset[:max_frames]
    save_index(subset, data_dir, INDEX_EVAL)
    return subset
