"""SE(3) helpers for host-side batch building (numpy; a copy of
``himo_tpu/core/transforms.py``'s functions that ``build_frame_arrays``
needs, so the port imports nothing of the JAX package).

- ``relative_pose``: ``inv(pose1) @ pose0``;
- ``transform_points`` / ``rigid_flow``: point transforms.
"""

from __future__ import annotations

import numpy as np


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
