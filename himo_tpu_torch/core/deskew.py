"""The de-skew pipeline (port of ``himo_tpu/core/deskew.py``).

One function over fixed-size padded clouds. It takes any leading batch
dimensions, so ``deskew_batch`` is the same function applied to (B, N, ...)
frames with (B, 4, 4) poses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from himo_tpu_torch.core.compensation import (
    dt0_from_lidar_dt,
    evaluation_mask,
    flow_to_comp_dis,
    relative_se3,
)


class DeskewResult(NamedTuple):
    comp_dis: torch.Tensor  # (..., N, 3) compensation displacement
    refined: torch.Tensor  # (..., N, 3) de-skewed points
    motion_flow: torch.Tensor  # (..., N, 3) flow with ego motion removed
    eval_mask: torch.Tensor  # (..., N) metric-eligible points
    dt0: torch.Tensor  # (..., N) time gap to latest observation


def deskew_frame(
    pc0: torch.Tensor,
    lidar_dt: torch.Tensor,
    valid: torch.Tensor,
    pose0: torch.Tensor,
    pose1: torch.Tensor,
    est_flow: torch.Tensor,
    ground_mask: torch.Tensor,
    flow_is_valid: torch.Tensor | None = None,
    dataset: str = "av2",
    sensor_dt: float = 0.1,
) -> DeskewResult:
    """Per-frame de-skew.

    Args:
        pc0: (..., N, >=3) padded point cloud in ego0 frame.
        lidar_dt: (..., N) intra-sweep capture offsets (seconds).
        valid: (..., N) real-point mask (False rows are padding).
        pose0 / pose1: (..., 4, 4) ego poses of this and the next frame.
        est_flow: (..., N, 3) estimated TOTAL flow (including ego motion).
        ground_mask: (..., N) ground points (True = ground).
        flow_is_valid: (..., N) optional GT-validity gate (Scania only).
        dataset: 'av2' or 'scania' — picks the ego-box and mask recipe.
        sensor_dt: sweep period, seconds.
    """
    xyz = pc0[..., :3]
    rot, t = relative_se3(pose0, pose1)
    rot = rot.to(xyz.dtype)
    t = t.to(xyz.dtype)
    pose_flow = xyz @ rot.transpose(-1, -2) + t[..., None, :] - xyz

    motion_flow = est_flow - pose_flow
    dt0 = dt0_from_lidar_dt(lidar_dt, valid)
    comp_dis = flow_to_comp_dis(motion_flow, dt0, sensor_dt)
    comp_dis = torch.where(valid[..., None], comp_dis, torch.zeros_like(comp_dis))
    refined = xyz + comp_dis

    mask = evaluation_mask(xyz, ground_mask, flow_is_valid, dataset, valid)

    return DeskewResult(comp_dis, refined, motion_flow, mask, dt0)


def deskew_batch(pc0, lidar_dt, valid, pose0, pose1, est_flow, ground_mask):
    """``deskew_frame`` over a leading batch of frames with the 'av2' recipe
    (the JAX ``vmap`` form); every argument gains a leading B axis."""
    return deskew_frame(pc0, lidar_dt, valid, pose0, pose1, est_flow, ground_mask)
