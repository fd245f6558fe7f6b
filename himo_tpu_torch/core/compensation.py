"""Motion-compensation math (port of ``himo_tpu/core/compensation.py``).

Every function takes any number of leading batch dimensions: ``(N, 3)``
clouds as the JAX reference does, or ``(B, N, 3)`` batches of frames, with
poses ``(4, 4)`` or ``(B, 4, 4)`` to match. Everything runs in float32 (the
package turns TF32 off, so the small pose matmuls are exact float32).
"""

from __future__ import annotations

import torch

# 2-D range gate for evaluation (AV2 devkit CLOSE_DISTANCE_THRESHOLD).
CLOSE_DISTANCE_THRESHOLD: float = 35.0

# Ego-vehicle exclusion boxes: (min_bound, max_bound).
SCANIA_EGO_BOX = (
    (-9.5, -1.5, 0.0),
    (5.0, 1.380002, 5.0),
)
AV2_EGO_BOX = (
    (-1.5, -1.5, -2.0),
    (1.5, 1.5, 2.0),
)


def flow_to_comp_dis(
    flow: torch.Tensor, dt0: torch.Tensor, sensor_dt: float = 0.1
) -> torch.Tensor:
    """``flow / sensor_dt * dt0``: (..., N, 3) flow in m/sweep and (..., N)
    seconds to the sweep's latest observation -> (..., N, 3) displacement."""
    return flow * (dt0 / sensor_dt)[..., None]


def refine_points(pc: torch.Tensor, comp_dis: torch.Tensor) -> torch.Tensor:
    """De-skew a point cloud: ``pc[..., :3] + comp_dis``."""
    return pc[..., :3] + comp_dis


def ego_points_mask(
    pts: torch.Tensor,
    min_bound=SCANIA_EGO_BOX[0],
    max_bound=SCANIA_EGO_BOX[1],
) -> torch.Tensor:
    """True for points strictly OUTSIDE the axis-aligned ego-vehicle box."""
    lo = torch.as_tensor(min_bound, dtype=pts.dtype, device=pts.device)
    hi = torch.as_tensor(max_bound, dtype=pts.dtype, device=pts.device)
    xyz = pts[..., :3]
    inside = torch.all((xyz > lo) & (xyz < hi), dim=-1)
    return ~inside


def relative_se3(
    pose0: torch.Tensor, pose1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, t) of ``inv(pose1) @ pose0`` via the analytic SE(3) inverse
    ``inv([R1, t1]) = [R1^T, -R1^T t1]``."""
    r0, t0 = pose0[..., :3, :3], pose0[..., :3, 3]
    r1, t1 = pose1[..., :3, :3], pose1[..., :3, 3]
    r1t = r1.transpose(-1, -2)
    rot = r1t @ r0
    t = (r1t @ (t0 - t1)[..., None])[..., 0]
    return rot, t


def pose_flow(
    pc0: torch.Tensor, pose0: torch.Tensor, pose1: torch.Tensor
) -> torch.Tensor:
    """Rigid flow induced by ego motion: ``pc0 @ R^T + t - pc0`` with
    ``(R, t)`` from ``inv(pose1) @ pose0``."""
    rot, t = relative_se3(pose0, pose1)
    rot = rot.to(pc0.dtype)
    t = t.to(pc0.dtype)
    xyz = pc0[..., :3]
    return xyz @ rot.transpose(-1, -2) + t[..., None, :] - xyz


def dt0_from_lidar_dt(
    lidar_dt: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-point time gap to the LATEST observation of its sweep:
    ``max(lidar_dt) - lidar_dt`` over the last axis. With ``valid``, the max
    ignores padded entries and padded outputs are zero."""
    if valid is None:
        return lidar_dt.amax(dim=-1, keepdim=True) - lidar_dt
    neg_inf = torch.full_like(lidar_dt, float("-inf"))
    sweep_end = torch.where(valid, lidar_dt, neg_inf).amax(dim=-1, keepdim=True)
    return torch.where(valid, sweep_end - lidar_dt, torch.zeros_like(lidar_dt))
