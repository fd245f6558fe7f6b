"""Point-in-rotated-box assignment (port of ``himo_tpu/ops/points_in_boxes.py``),
the GT autolabeler's box test (the reference's ``mmcv.ops.points_in_boxes_part``,
dataprocess/extract_sca.py:116-118).

Boxes are ``(x, y, z_bottom, l, w, h, heading)`` with z at the box BOTTOM. A
point is inside if, rotated into the box frame, ``|lx| <= l/2``,
``|ly| <= w/2`` and ``0 <= z - z_bottom <= h``. The returned id is the FIRST
containing box, -1 for background.

Plain PyTorch on the device of its inputs, in the reference's float32 order
of operations (``c*dx + s*dy``, ``-s*dx + c*dy``, then ``<=`` against half
the dims), each op its own kernel, so no multiply-add is fused. The (N, B)
test runs in chunks of points, which changes no result. Only ``cos`` and
``sin`` may differ from the JAX package's by an ulp, which can flip the
test for a point within rounding of a face: :func:`face_margin` finds those
points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_CHUNK_ELEMENTS = 1 << 22  # (points, boxes) pairs tested at once


def points_in_boxes(
    points: torch.Tensor,
    boxes: torch.Tensor,
    boxes_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Assign each point the id of the first box containing it, else -1.

    Args:
        points: (N, >=3) float32.
        boxes: (B, 7) float32 = x, y, z_bottom, l, w, h, heading (radians, about +z).
        boxes_valid: (B,) optional bool mask for padded box slots.

    Returns:
        (N,) int32 box index in [0, B) or -1, on the points' device.
    """
    xyz = points[:, :3]
    n, b = xyz.shape[0], boxes.shape[0]
    out = torch.full((n,), -1, dtype=torch.int32, device=xyz.device)
    if b == 0 or n == 0:
        return out
    centers = boxes[:, :3]  # z is the bottom face
    half_l = boxes[:, 3] * 0.5
    half_w = boxes[:, 4] * 0.5
    height = boxes[:, 5]
    c = torch.cos(boxes[:, 6])
    s = torch.sin(boxes[:, 6])
    slot = torch.arange(b, dtype=torch.int32, device=xyz.device)
    step = max(1, _CHUNK_ELEMENTS // b)
    for start in range(0, n, step):
        d = xyz[start:start + step, None, :] - centers[None, :, :]  # (n, B, 3)
        dx, dy, lz = d[:, :, 0], d[:, :, 1], d[:, :, 2]
        lx = c * dx + s * dy
        ly = -s * dx + c * dy
        inside = (lx.abs() <= half_l) & (ly.abs() <= half_w) & (lz >= 0.0) & (lz <= height)
        if boxes_valid is not None:
            inside &= boxes_valid[None, :]
        first = torch.where(inside, slot, b).amin(dim=1)
        out[start:start + step] = torch.where(first < b, first, -1)
    return out


def face_margin(points: np.ndarray, boxes: np.ndarray,
                boxes_valid: Optional[np.ndarray] = None, device="cpu") -> np.ndarray:
    """(N,) float64: for each point, the least over the boxes of ``|min
    slack|``, where the slacks are ``l/2 - |lx|``, ``w/2 - |ly|``, ``lz``
    and ``h - lz`` in float64. A point whose margin exceeds a tolerance is
    inside or outside every box by more than it, so an error below the
    tolerance in ``cos``, ``sin`` or the rounding of the products cannot
    change its id; +inf without boxes. Host arrays in and out, computed on
    ``device`` in chunks like the test."""
    bx = np.asarray(boxes, np.float64).reshape(-1, 7)
    if boxes_valid is not None:
        bx = bx[np.asarray(boxes_valid, bool)]
    n = len(points)
    if not len(bx):
        return np.full(n, np.inf)
    xyz = torch.as_tensor(np.asarray(points)[:, :3], dtype=torch.float64, device=device)
    bx = torch.as_tensor(bx, device=device)
    c, s = torch.cos(bx[:, 6]), torch.sin(bx[:, 6])
    out = torch.empty(n, dtype=torch.float64, device=device)
    step = max(1, _CHUNK_ELEMENTS // len(bx))
    for start in range(0, n, step):
        d = xyz[start:start + step, None, :] - bx[None, :, :3]
        lx = c * d[..., 0] + s * d[..., 1]
        ly = -s * d[..., 0] + c * d[..., 1]
        slack = torch.minimum(
            torch.minimum(bx[:, 3] * 0.5 - lx.abs(), bx[:, 4] * 0.5 - ly.abs()),
            torch.minimum(d[..., 2], bx[:, 5] - d[..., 2]))
        out[start:start + step] = slack.abs().amin(dim=1)
    return out.cpu().numpy()


def points_in_boxes_host(points: np.ndarray, boxes: np.ndarray, device) -> np.ndarray:
    """:func:`points_in_boxes` of host arrays (float32 points and boxes) on
    ``device``; the ids back on the host."""
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    bx = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(device)
    return points_in_boxes(pts, bx).cpu().numpy()
