"""Pillar (2-D voxel) encoding of point clouds (port of ``himo_tpu/ops/voxelize.py``).

Points are batched ``(B, N, 3)``; pillar ids are flat ``iy * w + ix`` into a
row-major ``(H, W, C)`` image, with the trash id ``h * w`` for points outside
the grid or masked out, exactly as the JAX reference computes them.

The per-pillar max goes through a hand-written CUDA kernel
(``csrc/scatter_max.cu``) on the GPU. Its plain PyTorch version sits beside
it: :func:`scatter_max_rows` takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises. The gather back to
points is plain indexing, as the JAX 512x512 forward is a plain take too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from himo_tpu_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class PillarConfig:
    """Geometry of the pillar grid."""

    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    z_range: Tuple[float, float] = (-3.0, 3.0)
    voxel_size: Tuple[float, float] = (0.2, 0.2)

    @property
    def grid_shape(self) -> Tuple[int, int]:
        h = round((self.y_range[1] - self.y_range[0]) / self.voxel_size[1])
        w = round((self.x_range[1] - self.x_range[0]) / self.voxel_size[0])
        return h, w

    @property
    def num_pillars(self) -> int:
        h, w = self.grid_shape
        return h * w


class PillarGrid(NamedTuple):
    """Result of pillar assignment for a batch of clouds."""

    pillar_ids: torch.Tensor  # (B, N) int32 flat pillar index; h*w = trash
    in_range: torch.Tensor  # (B, N) bool — inside the grid AND caller-valid
    centers_offset: torch.Tensor  # (B, N, 3) offset from the pillar center
    grid_shape: Tuple[int, int]


def voxelize_pillars(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    config: PillarConfig = PillarConfig(),
) -> PillarGrid:
    """Assign each point of (B, N, >=3) clouds to a pillar; no scatter here."""
    h, w = config.grid_shape
    xyz = points[..., :3]
    vx, vy = config.voxel_size
    ix = torch.floor((xyz[..., 0] - config.x_range[0]) / vx).to(torch.int32)
    iy = torch.floor((xyz[..., 1] - config.y_range[0]) / vy).to(torch.int32)
    in_range = (
        (ix >= 0)
        & (ix < w)
        & (iy >= 0)
        & (iy < h)
        & (xyz[..., 2] >= config.z_range[0])
        & (xyz[..., 2] <= config.z_range[1])
    )
    if valid is not None:
        in_range &= valid
    trash = torch.full_like(ix, h * w)
    flat = torch.where(in_range, iy * w + ix, trash)
    cx = (ix.to(torch.float32) + 0.5) * vx + config.x_range[0]
    cy = (iy.to(torch.float32) + 0.5) * vy + config.y_range[0]
    cz = torch.full_like(cx, 0.5 * (config.z_range[0] + config.z_range[1]))
    offset = xyz - torch.stack([cx, cy, cz], dim=-1)
    return PillarGrid(flat, in_range, offset, (h, w))


def _scatter_max_rows_plain(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """Plain version of the kernel: (B, N) pids, (B, N, C) fp32 feats ->
    (B, rows, C) per-row max; unreached rows are 0, pids >= rows skipped,
    and -0.0 comes out as +0.0 (as the kernel's finalize pass does)."""
    b, n, c = feats.shape
    base = torch.arange(b, device=pids.device, dtype=torch.int64)[:, None] * rows
    pid = pids.to(torch.int64)
    live = (pid >= 0) & (pid < rows)
    flat = torch.where(live, base + pid, torch.full_like(pid, b * rows))
    out = torch.full(
        (b * rows + 1, c), float("-inf"), dtype=torch.float32, device=feats.device
    )
    out.scatter_reduce_(
        0, flat.reshape(-1, 1).expand(-1, c), feats.reshape(-1, c), "amax"
    )
    out = out[: b * rows].reshape(b, rows, c)
    out = torch.where(out == float("-inf"), torch.zeros_like(out), out)
    return out + 0.0


_SCATTER_SIGNATURES = {
    "himo_scatter_max_f32": (
        _build.PTR, _build.PTR, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR,
    ),
}


def scatter_max_rows(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """Per-row max of (B, N, C) fp32 features at (B, N) int32 row ids into a
    (B, rows, C) image; rows no point reaches read 0, ids >= rows are
    skipped.

    CPU tensors take the plain PyTorch version. CUDA tensors launch
    ``csrc/scatter_max.cu`` (counted in ``scatter_max_rows.launches``) or
    raise: the kernel takes contiguous fp32 features and int32 ids, and has
    no backward yet, so inputs that require grad raise too."""
    if feats.device.type == "cpu":
        return _scatter_max_rows_plain(pids, feats, rows)
    if feats.dtype != torch.float32 or pids.dtype != torch.int32:
        raise TypeError(
            f"scatter_max_rows kernel takes fp32 feats and int32 pids, got "
            f"{feats.dtype} and {pids.dtype}"
        )
    if not (feats.is_contiguous() and pids.is_contiguous()):
        raise ValueError("scatter_max_rows kernel needs contiguous inputs")
    if feats.requires_grad:
        raise RuntimeError("scatter_max_rows kernel has no backward yet")
    if feats.dim() != 3 or pids.shape != feats.shape[:2]:
        raise ValueError(f"shapes {tuple(pids.shape)} / {tuple(feats.shape)}")
    if pids.device != feats.device:
        raise ValueError("pids and feats on different devices")
    b, n, c = feats.shape
    out = torch.empty((b, rows, c), dtype=torch.float32, device=feats.device)
    lib = _build.load("scatter_max", _SCATTER_SIGNATURES)
    code = lib.himo_scatter_max_f32(
        pids.data_ptr(), feats.data_ptr(), out.data_ptr(), b, n, c, rows,
        _build.stream_handle(feats.device),
    )
    scatter_max_rows.launches += 1
    _build.check(code, "scatter_max kernel")
    return out


scatter_max_rows.launches = 0


def scatter_max(features: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Per-pillar max of (B, N, C) point features -> (B, H, W, C) image.

    Empty pillars come out as 0. Lower precisions are scattered in fp32 and
    cast back (exact: a max of bf16 values is a bf16 value)."""
    h, w = grid.grid_shape
    feats = features.to(torch.float32).contiguous()
    pids = grid.pillar_ids.to(torch.int32).contiguous()
    out = scatter_max_rows(pids, feats, h * w)
    return out.reshape(features.shape[0], h, w, -1).to(features.dtype)


def scatter_max_multi(
    features: Sequence[torch.Tensor], grids: Sequence[PillarGrid]
) -> list:
    """Per-pillar max for K sweeps -> K (B, H, W, C) images, one kernel
    launch per sweep (the JAX reference fuses sweeps only when the fused
    point table fits its VMEM budget, which the 512x512 grid does not)."""
    if len(features) != len(grids) or not features:
        raise ValueError("need one grid per feature tensor")
    return [scatter_max(f, g) for f, g in zip(features, grids)]


def gather_pillars(image: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Gather each point's pillar feature from a (B, H, W, C) image ->
    (B, N, C). Out-of-range points get zeros."""
    h, w = grid.grid_shape
    b = image.shape[0]
    flat = image.reshape(b, h * w, -1)
    safe = torch.clamp(grid.pillar_ids.to(torch.int64), max=h * w - 1)
    batch = torch.arange(b, device=image.device)[:, None]
    out = flat[batch, safe]
    return torch.where(grid.in_range[..., None], out, torch.zeros_like(out))
