"""Pillar (2-D voxel) encoding of point clouds (port of ``himo_tpu/ops/voxelize.py``).

Points are batched ``(B, N, 3)``; pillar ids are flat ``iy * w + ix`` into a
row-major ``(H, W, C)`` image, with the trash id ``h * w`` for points outside
the grid or masked out, exactly as the JAX reference computes them.

Two hand-written CUDA kernels run on the GPU: the per-pillar max
(``csrc/scatter_max.cu``, :func:`scatter_max_rows`) and the row scatter-add
(``csrc/scatter_sum.cu``, :func:`scatter_sum_rows`). Their plain PyTorch
versions sit beside them; each wrapper takes its plain version only for
tensors on the CPU, and for a CUDA tensor launches the kernel or raises.

Gradients follow the JAX package's custom VJPs on the 512x512 path
(``_diff_scatter_sorted_fn``, ``_diff_gather_sorted_fn``):

- :func:`scatter_max`'s backward takes ``(g, out)`` at each point's pillar
  in one row take and gives the cotangent to every point whose feature
  equals the max: each tied winner gets all of it (the TPU rule; XLA's CPU
  ``segment_max`` would split it). The take is plain indexing, as it is an
  XLA take in the reference.
- :func:`gather_pillars`' forward is plain indexing; its backward is the
  row scatter-add of the fp32 cotangent into the pillar image.
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


def _scatter_sum_rows_plain(
    ids: torch.Tensor, vals: torch.Tensor, rows: int
) -> torch.Tensor:
    """Plain version of the scatter-add kernel: (B, N) ids, (B, N, C) fp32
    vals -> (B, rows, C) per-row sums (``index_add_`` in index order); rows
    no point reaches read 0, ids outside [0, rows) are skipped."""
    b, n, c = vals.shape
    base = torch.arange(b, device=ids.device, dtype=torch.int64)[:, None] * rows
    idx = ids.to(torch.int64)
    live = (idx >= 0) & (idx < rows)
    flat = torch.where(live, base + idx, torch.full_like(idx, b * rows))
    out = torch.zeros((b * rows + 1, c), dtype=torch.float32, device=vals.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1, c).to(torch.float32))
    return out[: b * rows].reshape(b, rows, c)


_ROWS_ARGTYPES = (
    _build.PTR, _build.PTR, _build.PTR,
    _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR,
)


def _check_rows_args(name: str, ids: torch.Tensor, vals: torch.Tensor) -> None:
    """Raise unless (B, N) int32 ids and (B, N, C) fp32 values are what the
    row kernels take: contiguous, on one device."""
    if vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(
            f"{name} kernel takes fp32 values and int32 ids, got "
            f"{vals.dtype} and {ids.dtype}"
        )
    if not (vals.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if vals.dim() != 3 or ids.shape != vals.shape[:2]:
        raise ValueError(f"shapes {tuple(ids.shape)} / {tuple(vals.shape)}")
    if ids.device != vals.device:
        raise ValueError("ids and values on different devices")


def _run_rows_kernel(
    library: str, entry: str, ids: torch.Tensor, vals: torch.Tensor, rows: int,
    zeroed: bool,
) -> torch.Tensor:
    """Launch a row kernel ``entry(ids, vals, out, B, N, C, rows, stream)``
    of ``csrc/<library>.cu`` into a new (B, rows, C) fp32 table (zeroed
    first when ``zeroed``); raises on inputs it does not take and on a CUDA
    error."""
    _check_rows_args(entry, ids, vals)
    b, n, c = vals.shape
    alloc = torch.zeros if zeroed else torch.empty
    out = alloc((b, rows, c), dtype=torch.float32, device=vals.device)
    lib = _build.load(library, {entry: _ROWS_ARGTYPES})
    code = getattr(lib, entry)(
        ids.data_ptr(), vals.data_ptr(), out.data_ptr(), b, n, c, rows,
        _build.stream_handle(vals.device),
    )
    _build.check(code, entry)
    return out


def scatter_max_rows(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """Per-row max of (B, N, C) fp32 features at (B, N) int32 row ids into a
    (B, rows, C) image; rows no point reaches read 0, ids >= rows are
    skipped. Not differentiable itself: :func:`scatter_max` carries the
    gradient.

    CPU tensors take the plain PyTorch version. CUDA tensors launch
    ``csrc/scatter_max.cu`` (counted in ``scatter_max_rows.launches``) or
    raise: the kernel takes contiguous fp32 features and int32 ids."""
    if feats.device.type == "cpu":
        return _scatter_max_rows_plain(pids, feats, rows)
    out = _run_rows_kernel("scatter_max", "himo_scatter_max_f32", pids, feats, rows,
                           zeroed=False)
    scatter_max_rows.launches += 1
    return out


scatter_max_rows.launches = 0


def scatter_sum_rows(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """Per-row sum of (B, N, C) fp32 values at (B, N) int32 row ids into a
    (B, rows, C) table; rows no point reaches read 0, ids outside [0, rows)
    are skipped. The order of the additions is not fixed on the GPU.

    CPU tensors take the plain version (``index_add_``). CUDA tensors launch
    ``csrc/scatter_sum.cu``'s ``himo_scatter_sum_f32`` (counted in
    ``scatter_sum_rows.launches``) into a zeroed table, or raise."""
    if feats.device.type == "cpu":
        return _scatter_sum_rows_plain(pids, feats, rows)
    out = _run_rows_kernel("scatter_sum", "himo_scatter_sum_f32", pids, feats, rows,
                           zeroed=True)
    scatter_sum_rows.launches += 1
    return out


scatter_sum_rows.launches = 0


def _take_rows_at(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, R, C) table, (B, N) ids in [0, R) -> (B, N, C) rows."""
    idx = ids.to(torch.int64)[..., None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


class _ScatterMax(torch.autograd.Function):
    """Per-row max with the TPU custom VJP: every tied winner gets the whole
    cotangent of its (row, channel)."""

    @staticmethod
    def forward(ctx, pids, feats, rows):
        out = scatter_max_rows(pids, feats, rows)
        ctx.save_for_backward(pids, feats, out)
        return out

    @staticmethod
    def backward(ctx, g):
        pids, feats, out = ctx.saved_tensors
        rows, c = out.shape[1], out.shape[2]
        # One row take of (g, out) together, as the reference does.
        safe = torch.clamp(pids.to(torch.int64), max=rows - 1)
        both = _take_rows_at(torch.cat([g, out], dim=-1), safe)
        winner = (feats == both[..., c:]) & (pids < rows)[..., None]
        return None, torch.where(winner, both[..., :c], torch.zeros_like(feats)), None


class _RowTake(torch.autograd.Function):
    """Row take ``table[b, ids[b]]`` of a (B, R, C) table whose backward
    scatter-adds the fp32 cotangent with ``scatter(ids, g, R)`` and casts it
    back. Ids >= R read row ``R - 1`` and send nothing back (the scatter
    skips them; callers zero their outputs). Behind :func:`gather_pillars`
    (``scatter_sum_rows``) and ``ops.nn.take_rows`` (``segment_rows_sum``)."""

    @staticmethod
    def forward(ctx, table, ids, scatter):
        rows = table.shape[1]
        ctx.save_for_backward(ids)
        ctx.rows = rows
        ctx.scatter = scatter
        return _take_rows_at(table, torch.clamp(ids.to(torch.int64), max=rows - 1))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = ctx.scatter(ids.to(torch.int32).contiguous(),
                        g.to(torch.float32).contiguous(), ctx.rows)
        return d.to(g.dtype), None, None


def scatter_max(features: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Per-pillar max of (B, N, C) point features -> (B, H, W, C) image.

    Empty pillars come out as 0. Lower precisions are scattered in fp32 and
    cast back (exact: a max of bf16 values is a bf16 value). Differentiable
    in ``features`` (see the module docstring)."""
    h, w = grid.grid_shape
    feats = features.to(torch.float32).contiguous()
    pids = grid.pillar_ids.to(torch.int32).contiguous()
    out = _ScatterMax.apply(pids, feats, h * w)
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
    (B, N, C). Out-of-range points get zeros. Differentiable in ``image``:
    the backward scatter-adds the cotangent in fp32 and casts it back to
    the image's dtype, as the reference's fp32 gather does."""
    h, w = grid.grid_shape
    flat = image.reshape(image.shape[0], h * w, -1)
    pids = grid.pillar_ids.to(torch.int32).contiguous()
    out = _RowTake.apply(flat, pids, scatter_sum_rows)
    return torch.where(grid.in_range[..., None], out, torch.zeros_like(out))
