"""The columns of ``lz4_fixture.feather``, and the script that wrote it.

``lz4_fixture.feather`` is a feather file as pandas writes one
(``DataFrame.to_feather`` through pyarrow): two record batches (65,536 and
4,464 rows), every buffer an LZ4 frame with linked 64 KiB blocks, the
schema's ``pandas`` metadata. The Arrow reader's tests and
``chip_smoke.py`` (whose host has no pandas) read it and hold what they
read against :func:`columns`, which needs numpy only. To write it again:

    python tests/data/lz4_fixture.py
"""

from pathlib import Path

import numpy as np

ROWS = 70_000  # more than pandas' 65,536 rows a batch
RUN = 40  # rows a value repeats: long runs keep the file small
PATH = Path(__file__).with_name("lz4_fixture.feather")


def columns(rows: int = ROWS, seed: int = 0) -> dict:
    """The file's columns: float32, uint8, uint32, float64, int64 and bool,
    each made from ``seed``. (A string column's offsets rise row by row and
    do not compress; the reader's string path is tested on files written
    at test time.)"""
    rng = np.random.default_rng(seed)
    runs = rows // RUN + 1

    def stepwise(values):
        return np.repeat(values, RUN)[:rows]

    return {
        "comp_dis_x_m": stepwise(np.round(rng.normal(0, 0.5, runs), 2).astype(np.float32)),
        "flow_category_indices": stepwise(rng.integers(0, 30, runs).astype(np.uint8)),
        "flow_instance_id": (np.arange(rows) // 500).astype(np.uint32),
        "gt_flow_norm": stepwise(np.round(rng.uniform(0, 3, runs), 1)),
        "timestamp_ns": 1_700_000_000_000_000_000 + np.arange(rows) // 1000 * 100_000_000,
        "eval_mask": stepwise(rng.random(runs) < 0.8),
    }


def main() -> None:
    import pandas as pd

    pd.DataFrame(columns()).to_feather(PATH)
    print(f"wrote {PATH} ({PATH.stat().st_size:,} bytes)")


if __name__ == "__main__":
    main()
