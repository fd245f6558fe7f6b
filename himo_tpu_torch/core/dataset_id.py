"""Dataset identification & evaluation-source selection (a copy of
``himo_tpu/core/dataset_id.py``).

Mirrors the path-sniffing behavior of reference utils/__init__.py:4-24
(``check_valid``): the dataset name is inferred from the data directory path
("scania" / "av2", else error), and evaluation either reads a comp_dis zip
(EvalSource.ZIP) or a flow field stored in the .h5 (EvalSource.FLOW).
"""

from __future__ import annotations

import enum
import os
from typing import Optional, Tuple


class EvalSource(enum.Enum):
    ZIP = 1   # compensation distances come from a feather-in-zip submission
    FLOW = 2  # compensation distances derive from an .h5 flow field


def infer_dataset_name(data_dir: str) -> str:
    """Infer 'scania' or 'av2' from the directory path (case tolerant)."""
    lowered = str(data_dir).lower()
    if "scania" in lowered:
        return "scania"
    if "av2" in lowered:
        return "av2"
    raise ValueError(f"Unknown dataset name in data_dir: {data_dir!r}")


def check_valid(
    data_dir: str, flow_mode: str, comp_dis_zip: Optional[str] = None
) -> Tuple[str, EvalSource]:
    """Resolve (dataset_name, evaluation source) like reference check_valid."""
    data_name = infer_dataset_name(data_dir)
    if comp_dis_zip and os.path.exists(comp_dis_zip):
        print(f"Using provided comp_dis_zip: {comp_dis_zip} for evaluation.")
        return data_name, EvalSource.ZIP
    print(f"No valid comp_dis_zip provided, evaluating based on {flow_mode} directly.")
    return data_name, EvalSource.FLOW
