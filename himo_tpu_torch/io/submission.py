"""Leaderboard submission format: feather frames zipped per scene (port of
``himo_tpu/io/submission.py`` on :mod:`himo_tpu_torch.io.arrow`, no pandas).

Bit-compatible with the reference's Codabench loop (save_zip.py:30-100,
tools/test/score.py:96-177): each frame is a feather file with columns
``comp_dis_{x,y,z}_m`` at archive path ``{scene_id}/{timestamp}.feather``.
GT-side archives additionally carry ``eval_mask``, ``flow_category_indices``,
``flow_instance_id``, ``gt_flow_norm`` and ``pc0_{x,y,z}``
(tools/test/save_zip_gt.py:88-105). Frames are written uncompressed, one
record batch each; frames that pandas wrote (LZ4, several batches) read the
same.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from zipfile import ZipFile

import numpy as np

from himo_tpu_torch.io.arrow import read_feather, write_feather

SweepUuid = Tuple[str, str]


def _frame_path(sweep_uuid: SweepUuid) -> str:
    return f"{sweep_uuid[0]}/{sweep_uuid[1]}.feather"


def _read_frame(data_path, sweep_uuid: SweepUuid) -> Dict[str, np.ndarray]:
    data_path = Path(data_path)
    rel = _frame_path(sweep_uuid)
    if data_path.is_dir():
        return read_feather(data_path / rel)
    with ZipFile(data_path, "r") as zf:
        return read_feather(zf.read(rel))


def _stack(cols: Dict[str, np.ndarray], names) -> np.ndarray:
    return np.stack([cols[name].astype(np.float32) for name in names], axis=1)


COMP_DIS = ("comp_dis_x_m", "comp_dis_y_m", "comp_dis_z_m")
PC0 = ("pc0_x", "pc0_y", "pc0_z")


def read_comp_dis_zip(zip_path, sweep_uuid: SweepUuid) -> np.ndarray:
    """(N, 3) float32 compensation distances for one sweep."""
    return _stack(_read_frame(zip_path, sweep_uuid), COMP_DIS)


def read_submission_frame(data_path, sweep_uuid: SweepUuid) -> Dict[str, np.ndarray]:
    """Read a frame with all optional GT columns (scorer-side read).

    Returns a dict with 'comp_dis' plus any of: eval_mask, category,
    instance, gt_flow_norm, pc0 that are present.
    """
    cols = _read_frame(data_path, sweep_uuid)
    out: Dict[str, np.ndarray] = {"comp_dis": _stack(cols, COMP_DIS)}
    n = len(out["comp_dis"])
    out["eval_mask"] = (
        cols["eval_mask"].astype(bool) if "eval_mask" in cols else np.ones(n, dtype=bool)
    )
    if "flow_category_indices" in cols:
        out["category"] = cols["flow_category_indices"].astype(np.uint8)
    if "flow_instance_id" in cols:
        out["instance"] = cols["flow_instance_id"].astype(np.uint32)
    if "gt_flow_norm" in cols:
        out["gt_flow_norm"] = cols["gt_flow_norm"].astype(np.float32)
    if set(PC0).issubset(cols):
        out["pc0"] = _stack(cols, PC0)
    return out


def write_comp_dis_feather(
    comp_dis: np.ndarray,
    sweep_uuid: SweepUuid,
    output_dir,
    eval_mask: Optional[np.ndarray] = None,
    flow_category_indices: Optional[np.ndarray] = None,
    flow_instance_id: Optional[np.ndarray] = None,
    gt_flow_norm: Optional[np.ndarray] = None,
    pc0: Optional[np.ndarray] = None,
) -> Path:
    """Write one frame's feather file; optional columns build GT archives."""
    out_dir = Path(output_dir) / sweep_uuid[0]
    out_dir.mkdir(exist_ok=True, parents=True)
    columns: Dict[str, np.ndarray] = {
        name: comp_dis[:, i].astype(np.float32) for i, name in enumerate(COMP_DIS)
    }
    if eval_mask is not None:
        columns["eval_mask"] = eval_mask.astype(np.uint8)
    if flow_category_indices is not None:
        columns["flow_category_indices"] = flow_category_indices.astype(np.uint8)
    if flow_instance_id is not None:
        columns["flow_instance_id"] = flow_instance_id.astype(np.uint32)
    if gt_flow_norm is not None:
        columns["gt_flow_norm"] = gt_flow_norm.astype(np.float32)
    if pc0 is not None:
        columns.update({name: pc0[:, i].astype(np.float32) for i, name in enumerate(PC0)})
    path = out_dir / f"{sweep_uuid[1]}.feather"
    write_feather(columns, path)
    return path


def zip_results(res_folder, output_file: str = "submit.zip") -> str:
    """Zip per-scene feather folders into a submission archive.

    Matches reference save_zip.py:84-100 including removal of the source
    scene folders after zipping.
    """
    res_folder = str(res_folder)
    scenes = sorted(
        d for d in os.listdir(res_folder) if os.path.isdir(os.path.join(res_folder, d))
    )
    with ZipFile(output_file, "w") as zf:
        for scene in scenes:
            scene_dir = os.path.join(res_folder, scene)
            for name in sorted(os.listdir(scene_dir)):
                if name.endswith(".feather") and os.path.isfile(
                    os.path.join(scene_dir, name)
                ):
                    zf.write(os.path.join(scene_dir, name), arcname=f"{scene}/{name}")
    for scene in scenes:
        shutil.rmtree(os.path.join(res_folder, scene))
    print(
        f"Zipped results to {res_folder} into {output_file}. "
        "Submit your result by uploading this zip file."
    )
    return output_file


def list_sweep_uuids(data_path) -> List[SweepUuid]:
    """All (scene_id, timestamp) pairs in a zip archive or extracted dir."""
    data_path = Path(data_path)
    uuids: List[SweepUuid] = []
    if data_path.is_dir():
        for feather in data_path.rglob("*.feather"):
            parts = feather.relative_to(data_path).parts
            if len(parts) == 2:
                uuids.append((parts[0], parts[1][: -len(".feather")]))
    else:
        with ZipFile(data_path, "r") as zf:
            for name in zf.namelist():
                if name.endswith(".feather"):
                    parts = name.split("/")
                    if len(parts) == 2:
                        uuids.append((parts[0], parts[1][: -len(".feather")]))
    return uuids
