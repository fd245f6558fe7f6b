"""Host-side per-frame preparation of the eval (port of
``himo_tpu/eval/pipeline.py``, the same numpy).

Mirrors the exact numpy math of reference eval.py:283-302 and
save_zip.py:113-121 so metrics are bit-compatible. The device-batched
equivalent lives in :mod:`himo_tpu_torch.core.deskew`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from himo_tpu_torch.core.compensation import (
    AV2_EGO_BOX,
    CLOSE_DISTANCE_THRESHOLD,
    SCANIA_EGO_BOX,
)


def _ego_mask_np(pts: np.ndarray, min_bound, max_bound) -> np.ndarray:
    inside = (
        (pts[:, 0] > min_bound[0])
        & (pts[:, 0] < max_bound[0])
        & (pts[:, 1] > min_bound[1])
        & (pts[:, 1] < max_bound[1])
        & (pts[:, 2] > min_bound[2])
        & (pts[:, 2] < max_bound[2])
    )
    return ~inside


def prepare_frame(
    data: Dict[str, np.ndarray],
    data_name: str,
    res_name: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Compute pose flow, GT motion flow, eval mask, dt0 and est motion flow.

    ``res_name='raw'`` yields zero motion flow (the uncompensated baseline);
    any other name reads ``data[res_name]`` (total flow) and removes the pose
    flow. ``res_name=None`` skips the estimate (GT-only consumers).
    """
    pc0 = np.asarray(data["pc0"], dtype=np.float32)
    xyz = pc0[:, :3]
    pose0, pose1 = data["pose0"], data["pose1"]
    ego_pose = np.linalg.inv(pose1) @ pose0
    pose_flow = (xyz @ ego_pose[:3, :3].T + ego_pose[:3, 3] - xyz).astype(np.float32)
    # Test-split scenes carry no GT flow (the submission path never needs it).
    gt_flow = (
        data["flow"].astype(np.float32) - pose_flow if "flow" in data else None
    )

    dis_mask = np.linalg.norm(xyz[:, :2], axis=1) <= CLOSE_DISTANCE_THRESHOLD
    notgm = ~np.asarray(data["gm0"], dtype=bool)
    if data_name == "scania":
        mask_eval = dis_mask & notgm & _ego_mask_np(xyz, *SCANIA_EGO_BOX)
        if "flow_is_valid" in data:
            mask_eval &= np.asarray(data["flow_is_valid"], dtype=bool)
    else:
        mask_eval = dis_mask & notgm & _ego_mask_np(xyz, *AV2_EGO_BOX)

    lidar_dt = np.asarray(data["lidar_dt"], dtype=np.float32)
    dt0 = lidar_dt.max() - lidar_dt

    out = {
        "xyz": xyz,
        "pc_full": pc0,  # all stored columns (strict_parity distance quirk)
        "pose_flow": pose_flow,
        "gt_flow": gt_flow,
        "mask_eval": mask_eval,
        "dt0": dt0,
    }
    if res_name is not None:
        if res_name == "raw":
            est_flow = np.zeros_like(pose_flow)
        else:
            est_flow = np.asarray(data[res_name], dtype=np.float32) - pose_flow
        out["est_flow"] = est_flow
    return out
