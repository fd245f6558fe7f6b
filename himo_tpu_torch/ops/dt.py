"""Euclidean distance transform on a voxel grid and trilinear sampling
(port of ``himo_tpu/ops/dt.py``), the loss field of ``fastnsf``.

The squared distance field of a cloud is exact on the grid: occupied cells
start at 0 (cell centre to cell centre), then three separable lower-envelope
passes, one per axis, each ``out[x] = min_y f(y) + ((x - y) * spacing)^2``
as a broadcast min over rows. :func:`sample_dt` interpolates it
trilinearly at arbitrary points, clamped to the grid. Plain PyTorch: the
reference has no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

_BIG = 1.0e12  # "infinite" squared distance of an empty cell
_ENVELOPE_ELEMENTS = 1 << 26  # (rows, L, L) elements per envelope chunk


@dataclasses.dataclass(frozen=True)
class DTConfig:
    """Voxel grid geometry of the distance field."""

    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    z_range: Tuple[float, float] = (-3.2, 3.2)
    voxel_size: Tuple[float, float, float] = (0.4, 0.4, 0.4)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (
            round((self.x_range[1] - self.x_range[0]) / self.voxel_size[0]),
            round((self.y_range[1] - self.y_range[0]) / self.voxel_size[1]),
            round((self.z_range[1] - self.z_range[0]) / self.voxel_size[2]),
        )

    @property
    def origin(self) -> Tuple[float, float, float]:
        return (self.x_range[0], self.y_range[0], self.z_range[0])


class DTGrid(NamedTuple):
    dist_sq: torch.Tensor  # (X, Y, Z) squared distance to the cloud, m^2
    config: DTConfig


def _envelope_last_axis(f: torch.Tensor, spacing: float) -> torch.Tensor:
    """1-D squared-distance lower envelope along the last axis."""
    length = f.shape[-1]
    idx = torch.arange(length, dtype=torch.float32, device=f.device)
    d2 = ((idx[:, None] - idx[None, :]) * spacing) ** 2  # (L, L)
    flat = f.reshape(-1, length)
    chunk = max(1, _ENVELOPE_ELEMENTS // (length * length))
    out = [
        (flat[s : s + chunk, None, :] + d2[None]).amin(dim=-1)
        for s in range(0, flat.shape[0], chunk)
    ]
    return torch.cat(out).reshape(f.shape)


@torch.no_grad()
def distance_transform(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    config: DTConfig = DTConfig(),
) -> DTGrid:
    """Squared-distance field of an (N, >=3) cloud over the static voxel
    grid of ``config``, on the cloud's device; points outside the grid or
    not ``valid`` are left out."""
    gx, gy, gz = config.grid_shape
    ox, oy, oz = config.origin
    vx, vy, vz = config.voxel_size
    xyz = points[:, :3].to(torch.float32)
    ix = torch.floor((xyz[:, 0] - ox) / vx).to(torch.int64)
    iy = torch.floor((xyz[:, 1] - oy) / vy).to(torch.int64)
    iz = torch.floor((xyz[:, 2] - oz) / vz).to(torch.int64)
    in_range = (ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy) & (iz >= 0) & (iz < gz)
    if valid is not None:
        in_range &= valid
    cells = gx * gy * gz
    flat = torch.where(in_range, (ix * gy + iy) * gz + iz, torch.full_like(ix, cells))
    occupied = torch.zeros(cells + 1, dtype=torch.bool, device=xyz.device)
    occupied[flat] = True
    f = torch.where(occupied[:-1], 0.0, _BIG).to(torch.float32).reshape(gx, gy, gz)
    f = _envelope_last_axis(f, vz)  # along z
    f = _envelope_last_axis(f.transpose(1, 2), vy).transpose(1, 2)  # along y
    f = _envelope_last_axis(f.permute(1, 2, 0), vx).permute(2, 0, 1)  # along x
    return DTGrid(f.contiguous(), config)


def _clip(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, low), high), whose gradient is 0.5 exactly
    at either bound (``torch.clamp`` passes 1 there)."""
    x = torch.maximum(x, torch.full_like(x, low))
    return torch.minimum(x, torch.full_like(x, high))


def sample_dt(grid: DTGrid, points: torch.Tensor) -> torch.Tensor:
    """Trilinear squared distance at (N, >=3) points -> (N,). Cell centres
    are the sample sites; points are clamped to the grid, so points outside
    it read the border (finite). Differentiable in ``points``."""
    cfg = grid.config
    gx, gy, gz = cfg.grid_shape
    ox, oy, oz = cfg.origin
    vx, vy, vz = cfg.voxel_size
    u = _clip((points[:, 0] - ox) / vx - 0.5, 0.0, gx - 1.0)
    v = _clip((points[:, 1] - oy) / vy - 0.5, 0.0, gy - 1.0)
    w = _clip((points[:, 2] - oz) / vz - 0.5, 0.0, gz - 1.0)
    u0, v0, w0 = (torch.floor(c).detach() for c in (u, v, w))
    fu, fv, fw = u - u0, v - v0, w - w0
    i0, j0, k0 = (c.to(torch.int64) for c in (u0, v0, w0))
    i1 = torch.clamp(i0 + 1, max=gx - 1)
    j1 = torch.clamp(j0 + 1, max=gy - 1)
    k1 = torch.clamp(k0 + 1, max=gz - 1)
    d = grid.dist_sq.reshape(-1)

    def at(i, j, k):
        return d[(i * gy + j) * gz + k]

    c00 = at(i0, j0, k0) * (1 - fu) + at(i1, j0, k0) * fu
    c10 = at(i0, j1, k0) * (1 - fu) + at(i1, j1, k0) * fu
    c01 = at(i0, j0, k1) * (1 - fu) + at(i1, j0, k1) * fu
    c11 = at(i0, j1, k1) * (1 - fu) + at(i1, j1, k1) * fu
    c0 = c00 * (1 - fv) + c10 * fv
    c1 = c01 * (1 - fv) + c11 * fv
    return c0 * (1 - fw) + c1 * fw
