"""Ground-point classification by the grid's lowest z (port of
``himo_tpu/ops/ground.py``), the ``ground_mask`` that ingestion writes.

Rasterize the cloud into BEV cells, take each cell's minimum z (a scatter
``amin``), smooth with a 3x3 neighbourhood min (ground is locally planar),
and mark points within ``threshold`` above the local floor as ground.

Plain PyTorch on the device of its inputs. Every step is exact in IEEE
float32 (subtraction, true division, ``floor``, ``min``, one addition), so
the mask is bitwise the JAX package's: the cell size is a float32 tensor on
the device, not a Python scalar, because CUDA divides by a host scalar as a
multiply by its reciprocal. Cells start at the same
``1e9`` sentinel that pads the neighbourhood (JAX's ``segment_min`` fills
empty cells with +inf); a point's own cell is never empty, so the two
differ only in cells whose floor lies above both, which no
``max_ground_z`` below 1e9 calls ground.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_BIG = 1e9
# float32 bounds of an int32: conversions saturate, and NaN becomes 0, as
# XLA's float-to-int conversion does.
_INT32_LO, _INT32_HI = -2.0 ** 31, 2.0 ** 31 - 128


@dataclasses.dataclass(frozen=True)
class GroundConfig:
    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    cell_size: float = 1.6
    threshold: float = 0.25  # meters above the local floor counted as ground
    max_ground_z: float = 1.0  # absolute cap: cells floored above this aren't ground

    @property
    def grid_shape(self) -> Tuple[int, int]:
        h = round((self.y_range[1] - self.y_range[0]) / self.cell_size)
        w = round((self.x_range[1] - self.x_range[0]) / self.cell_size)
        return h, w


def _cell_index(offset: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    f = torch.floor(offset / size)
    return torch.nan_to_num(f, nan=0.0).clamp(_INT32_LO, _INT32_HI).to(torch.int32)


def ground_mask(
    points: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    config: GroundConfig = GroundConfig(),
) -> torch.Tensor:
    """(N,) bool — True for points classified as ground. Out-of-grid points
    are never ground (conservative)."""
    h, w = config.grid_shape
    xyz = points[:, :3]
    size = torch.tensor(config.cell_size, dtype=xyz.dtype, device=xyz.device)
    ix = _cell_index(xyz[:, 0] - config.x_range[0], size)
    iy = _cell_index(xyz[:, 1] - config.y_range[0], size)
    in_grid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    if valid is not None:
        in_grid &= valid
    cell = torch.where(in_grid, iy * w + ix, h * w).long()

    z = torch.where(in_grid, xyz[:, 2], _BIG)
    floor = torch.full((h * w + 1,), _BIG, dtype=xyz.dtype, device=xyz.device)
    floor.scatter_reduce_(0, cell, z, "amin")
    floor = floor[: h * w].reshape(h, w)

    # 3x3 neighbourhood min: a cell whose floor sits on an object (a car roof
    # over a fully occluded cell) inherits the true floor from its neighbours.
    padded = torch.nn.functional.pad(floor, (1, 1, 1, 1), value=_BIG)
    neighborhood = torch.stack([
        padded[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ]).amin(dim=0)

    local_floor = neighborhood.reshape(-1)[torch.clamp(cell, max=h * w - 1)]
    return (
        in_grid
        & (xyz[:, 2] <= local_floor + config.threshold)
        & (local_floor <= config.max_ground_z)
    )


def ground_mask_host(points: np.ndarray, device,
                     config: GroundConfig = GroundConfig()) -> np.ndarray:
    """:func:`ground_mask` of a host float32 (N, >=3) cloud on ``device``;
    the mask back on the host."""
    pts = torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32)).to(device)
    return ground_mask(pts, config=config).cpu().numpy()
