"""SE(3) helpers for host-side batch building and synthetic scenes (numpy;
a copy of ``himo_tpu/core/transforms.py``, so the port imports nothing of
the JAX package).

- ``pose_from_yaw_xy``: planar yaw + xy translation -> 4x4 pose;
- ``relative_pose``: ``inv(pose1) @ pose0``;
- ``transform_points`` / ``rigid_flow``: point transforms.
"""

from __future__ import annotations

import numpy as np


def pose_from_yaw_xy(yaw: float, x: float, y: float) -> np.ndarray:
    """4x4 SE(3) from planar yaw rotation and xy translation (z = 0)."""
    pose = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    pose[:3, :3] = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    pose[0, 3] = x
    pose[1, 3] = y
    return pose


def relative_pose(pose0: np.ndarray, pose1: np.ndarray) -> np.ndarray:
    """SE(3) taking ego frame at t0 into ego frame at t1: ``inv(pose1) @ pose0``."""
    return np.linalg.inv(pose1) @ pose0


def transform_points(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply a 4x4 pose to (N, 3) points."""
    return points @ pose[:3, :3].T + pose[:3, 3]


def rigid_flow(points: np.ndarray, pose0: np.ndarray, pose1: np.ndarray) -> np.ndarray:
    """Flow of static points induced by ego motion."""
    rel = relative_pose(pose0, pose1)
    return transform_points(points[:, :3], rel) - points[:, :3]
