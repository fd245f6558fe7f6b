"""Pillar (2-D voxel) encoding of point clouds (port of ``himo_tpu/ops/voxelize.py``).

Points are batched ``(B, N, 3)``; pillar ids are flat ``iy * w + ix`` into a
row-major ``(H, W, C)`` image, with the trash id ``h * w`` for points outside
the grid or masked out, exactly as the JAX reference computes them.

Each pillar scatter and gather takes the route the reference takes for the
same shapes (:func:`_route`, from its per-frame thresholds), and each route
has its own hand-written CUDA kernel:

- ``resident`` (the reference keeps the image in VMEM; the 256x256 grid):
  per-point max :func:`scatter_max_resident_rows` (``csrc/scatter_max.cu``,
  TPU kernel K3 max), gather :func:`gather_rows` (``csrc/sorted_gather.cu``,
  K4), whose backward and the resident sum are ``ops.nn.segment_rows_sum``
  (``csrc/scatter_sum.cu``, K3 sum);
- ``table`` (the point table fits; the 512x512 grid at up to 81,920 points):
  :func:`scatter_max_rows` (``csrc/scatter_max.cu``, K1 max) and
  :func:`scatter_sum_rows` (``csrc/scatter_sum.cu``, K1 sum);
- ``stream`` (larger clouds): a stable sort by pillar id, then the sorted
  segmented reduce :func:`sorted_scatter_max_rows` /
  :func:`sorted_scatter_sum_rows` (``csrc/sorted_scatter.cu``, K2).

The plain PyTorch versions sit beside the kernels; each wrapper takes its
plain version only for tensors on the CPU, and for a CUDA tensor launches
the kernel or raises.

Gradients follow the JAX package's custom VJPs (``_diff_scatter_fn``,
``_diff_scatter_sorted_fn``, ``_diff_gather_resident_fn``,
``_diff_gather_sorted_fn``):

- :func:`scatter_max`'s backward takes ``(g, out)`` at each point's pillar
  in one row take and gives the cotangent to every point whose feature
  equals the max: each tied winner gets all of it (the TPU rule; XLA's CPU
  ``segment_max`` would split it). On the resident route the take is plain
  indexing, as in the reference's K3 VJP. On the table and stream routes it
  is :func:`sorted_gather_rows` (``csrc/sorted_gather.cu``, K5), the
  reference's take under ``HIMO_MAXBWD_PALLAS=1``: the stream route reuses
  the stable sort its forward made, the table route sorts once. No option
  selects it (a gather is exact, so the values are those of the XLA take).
- :func:`gather_pillars`' forward is K4 on the resident route and plain
  indexing otherwise (an XLA take in the reference); its backward is the
  row scatter-add of the fp32 cotangent on the same route.
- :func:`scatter_mean`'s backward is the plain take of the cotangent.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from himo_tpu_torch.kernels import _build

# The reference's route thresholds, copied from himo_tpu/ops/voxelize.py
# (``_SCATTER_CHUNK``, ``_VMEM_BUDGET_BYTES``, ``_TABLE_BUDGET_BYTES`` and
# ``_window_bytes``' (8, 128) padding). Here they choose which kernel serves
# a pillar scatter or gather, so that each CUDA kernel runs where its TPU
# kernel runs; they are not a memory budget of the GPU. On the H100 the
# stream route is slower than the table route at equal work (PERF.md), so
# these are to be replaced by measured thresholds (ROADMAP.md, Queue 2).
_ROUTE_CHUNK = 2048
_RESIDENT_BYTES = 72 * 1024 * 1024
_TABLE_BYTES = 40 * 1024 * 1024


def _window_bytes(rows: int, channels: int) -> int:
    """The reference's size of a (rows, channels) fp32 window: rows rounded
    up to 8, channels to 128 lanes."""
    return -(-rows // 8) * 8 * (-(-channels // 128) * 128) * 4


def _route(rows: int, n: int, c: int) -> str:
    """The reference's choice of kernel for n points of c channels per
    frame into ``rows`` rows: ``"resident"`` when the (rows + 8, c) image
    passes the first threshold (K3, K4), else ``"table"`` when the point
    table, padded to 2,048 rows, passes the second (K1), else ``"stream"``
    (K2)."""
    if _window_bytes(rows + 8, c) <= _RESIDENT_BYTES:
        return "resident"
    if _window_bytes(n + (-n % _ROUTE_CHUNK), c) <= _TABLE_BYTES:
        return "table"
    return "stream"


def _fuse_sweeps(rows: int, n_total: int, c: int, k: int) -> bool:
    """The reference's gate for one fused max over k sweeps of ``rows``
    rows each and ``n_total`` points in all: only when one sweep is not
    resident and the concatenated stream still takes the table route."""
    return k > 1 and _route(rows, n_total, c) == "table"


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
    (B, rows, C) per-row max; unreached rows and maxima of -inf are 0 (the
    reference's rule for empty pillars), pids outside [0, rows) skipped,
    and -0.0 comes out as +0.0 (as the kernel's decode pass does)."""
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


def _take_rows_at(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, R, C) table, (B, N) ids in [0, R) -> (B, N, C) rows."""
    idx = ids.to(torch.int64)[..., None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx)


def _gather_rows_plain(image: torch.Tensor, pids: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather kernel: ``image[b, pids[b, i]]`` with
    ids clamped to [0, rows - 1]."""
    return _take_rows_at(image, torch.clamp(pids.to(torch.int64), 0, image.shape[1] - 1))


def _take_live_rows(image: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``image[b, ids[b, i]]`` of a (B, R, C) table, 0 for ids outside
    [0, R)."""
    idx = ids.to(torch.int64)
    live = (idx >= 0) & (idx < image.shape[1])
    out = _take_rows_at(image, torch.clamp(idx, 0, max(image.shape[1] - 1, 0)))
    return torch.where(live[..., None], out, torch.zeros_like(out))


def _sorted_gather_rows_plain(
    image: torch.Tensor, spids: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """Plain version of K5: ``out[b, order[b, j]] = image[b, spids[b, j]]``,
    0 for ids >= rows."""
    vals = _take_live_rows(image, spids)
    idx = order.to(torch.int64)[..., None].expand(-1, -1, vals.shape[-1])
    return torch.zeros_like(vals).scatter_(1, idx, vals)


# (ids or pids, values or image, out, B, N, C, rows), then the stream.
_ROWS_ARGTYPES = (_build.PTR,) * 3 + (_build.INT,) * 4
# (pids, feats, out, reached, B, N, C, rows): zeroes its image and its
# (B, rows) byte table of reached rows itself, scatters, decodes those rows
# (every word of the image when ``reached`` is null).
_SCATTER_MAX = _build.Entry("scatter_max", "himo_scatter_max_f32",
                            (_build.PTR,) * 4 + (_build.INT,) * 4)
# Zeroes its (B, rows, C) table itself (cudaMemsetAsync), then adds.
_SCATTER_SUM = _build.Entry("scatter_sum", "himo_scatter_sum_f32", _ROWS_ARGTYPES)


def _check_rows_args(name: str, ids: torch.Tensor, vals: torch.Tensor) -> None:
    """Raise unless (B, N) int32 ids and (B, N, C) fp32 values are what the
    row kernels take: contiguous, on one device. One expression when they
    are (every launch pays for it)."""
    if (vals.dtype is torch.float32 and ids.dtype is torch.int32
            and vals.is_contiguous() and ids.is_contiguous() and ids.device == vals.device
            and vals.dim() == 3 and ids.shape == vals.shape[:2]):
        return
    _build.check_args(name, f32=(vals,), i32=(ids,))
    raise ValueError(f"{name}: shapes {tuple(ids.shape)} / {tuple(vals.shape)}")


def _run_rows_kernel(
    entry: _build.Entry, ids: torch.Tensor, vals: torch.Tensor, rows: int, *flags
) -> torch.Tensor:
    """Launch a row kernel ``entry(ids, vals, out, B, N, C, rows, *flags)``
    into a new (B, rows, C) fp32 table, which the kernel fills; raises on
    inputs it does not take and on a CUDA error."""
    _check_rows_args(entry.name, ids, vals)
    b, n, c = vals.shape
    out = vals.new_empty((b, rows, c))
    entry.launch(vals.get_device(), ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                 b, n, c, rows, *flags)
    return out


# From this many channels on, the max kernel decodes only the rows that a
# (B, rows) byte table marks as reached; below, a 32-byte sector of the
# image holds two rows or more, the flagged decode reaches most sectors
# anyway, and decoding every word of the image measured faster at C = 1, 2
# and 4 (slower at 8 and 32; PERF.md).
_MAX_FLAG_MIN_CHANNELS = 8


def _run_max_kernel(pids: torch.Tensor, feats: torch.Tensor, rows: int,
                    flagged: bool | None = None) -> torch.Tensor:
    """Launch ``csrc/scatter_max.cu`` into a new (B, rows, C) fp32 image,
    with a (B, rows) byte scratch table of the rows points reach when
    ``flagged`` (by default from ``_MAX_FLAG_MIN_CHANNELS`` channels on;
    ``chip_smoke.py`` times both decodes); raises on inputs it does not
    take and on a CUDA error."""
    _check_rows_args(_SCATTER_MAX.name, pids, feats)
    b, n, c = feats.shape
    if flagged is None:
        flagged = c >= _MAX_FLAG_MIN_CHANNELS
    out = feats.new_empty((b, rows, c))
    reached = feats.new_empty((b, rows), dtype=torch.uint8) if flagged else None
    _SCATTER_MAX.launch(feats.get_device(), pids.data_ptr(), feats.data_ptr(), out.data_ptr(),
                        reached.data_ptr() if flagged else None, b, n, c, rows)
    return out


def scatter_max_rows(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """Per-row max of (B, N, C) fp32 features at (B, N) int32 row ids into a
    (B, rows, C) image; rows no point reaches read 0, ids >= rows are
    skipped. The table route (K1 max). Not differentiable itself:
    :func:`scatter_max` carries the gradient.

    CPU tensors take the plain PyTorch version. CUDA tensors launch
    ``csrc/scatter_max.cu`` (counted in ``scatter_max_rows.launches``) or
    raise: the kernel takes contiguous fp32 features and int32 ids."""
    if feats.is_cpu:
        return _scatter_max_rows_plain(pids, feats, rows)
    out = _run_max_kernel(pids, feats, rows)
    scatter_max_rows.launches += 1
    return out


scatter_max_rows.launches = 0


def scatter_max_resident_rows(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """The resident route's per-row max (K3 max): the same function as
    :func:`scatter_max_rows`, where the reference keeps the whole image in
    VMEM (the 256x256 grid).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/scatter_max.cu``'s ``himo_scatter_max_f32``, the kernel behind
    :func:`scatter_max_rows` (counted here in
    ``scatter_max_resident_rows.launches``), or raise."""
    if feats.is_cpu:
        return _scatter_max_rows_plain(pids, feats, rows)
    out = _run_max_kernel(pids, feats, rows)
    scatter_max_resident_rows.launches += 1
    return out


scatter_max_resident_rows.launches = 0


def scatter_sum_rows(
    pids: torch.Tensor, feats: torch.Tensor, rows: int
) -> torch.Tensor:
    """Per-row sum of (B, N, C) fp32 values at (B, N) int32 row ids into a
    (B, rows, C) table; rows no point reaches read 0, ids outside [0, rows)
    are skipped. The table route (K1 sum). The order of the additions is
    not fixed on the GPU.

    CPU tensors take the plain version (``index_add_``). CUDA tensors launch
    ``csrc/scatter_sum.cu``'s ``himo_scatter_sum_f32`` (counted in
    ``scatter_sum_rows.launches``), which zeroes its table and adds, or
    raise."""
    if feats.is_cpu:
        return _scatter_sum_rows_plain(pids, feats, rows)
    out = _run_rows_kernel(_SCATTER_SUM, pids, feats, rows)
    scatter_sum_rows.launches += 1
    return out


scatter_sum_rows.launches = 0


# Each zeroes its (B, rows, C) table itself (cudaMemsetAsync), then writes
# the rows that runs reach.
_SORTED_MAX = _build.Entry("sorted_scatter", "himo_sorted_scatter_max_f32", _ROWS_ARGTYPES)
_SORTED_SUM = _build.Entry("sorted_scatter", "himo_sorted_scatter_sum_f32", _ROWS_ARGTYPES)


def sorted_scatter_max_rows(
    spids: torch.Tensor, sfeats: torch.Tensor, rows: int
) -> torch.Tensor:
    """The stream route's per-row max (K2 max) of a stream already sorted
    by row id in each frame: (B, N) int32 ids, (B, N, C) fp32 rows in that
    order -> (B, rows, C); rows no run reaches read 0, ids >= rows (sorted
    to the end) are skipped. :func:`_sort_rows` makes such a stream.

    CPU tensors take the plain version, the unsorted one (a max does not
    depend on the order). CUDA tensors launch ``csrc/sorted_scatter.cu``'s
    ``himo_sorted_scatter_max_f32`` (counted in
    ``sorted_scatter_max_rows.launches``) or raise."""
    if sfeats.is_cpu:
        return _scatter_max_rows_plain(spids, sfeats, rows)
    out = _run_rows_kernel(_SORTED_MAX, spids, sfeats, rows)
    sorted_scatter_max_rows.launches += 1
    return out


sorted_scatter_max_rows.launches = 0


def sorted_scatter_sum_rows(
    spids: torch.Tensor, svals: torch.Tensor, rows: int
) -> torch.Tensor:
    """The stream route's per-row sum (K2 sum) of a stream sorted as for
    :func:`sorted_scatter_max_rows`. Each row adds its values in stream
    order from +0.0 (the reference's order), so the kernel is deterministic.

    CPU tensors take the plain version, ``index_add_`` over the sorted
    stream, which on the CPU adds in the same order (on the GPU its atomics
    add in no fixed order). CUDA tensors launch ``csrc/sorted_scatter.cu``'s
    ``himo_sorted_scatter_sum_f32`` (counted in
    ``sorted_scatter_sum_rows.launches``) or raise."""
    if svals.is_cpu:
        return _scatter_sum_rows_plain(spids, svals, rows)
    out = _run_rows_kernel(_SORTED_SUM, spids, svals, rows)
    sorted_scatter_sum_rows.launches += 1
    return out


sorted_scatter_sum_rows.launches = 0


def _check_gather_args(entry: str, image: torch.Tensor, *ids: torch.Tensor,
                       min_rows: int = 0) -> None:
    """Raise unless a (B, rows, C) fp32 image with at least ``min_rows``
    rows and (B, N) int32 id tensors of one shape are what the gather
    kernels take: contiguous, on one device."""
    _build.check_args(entry, f32=(image,), i32=ids)
    first = ids[0]
    if (image.dim() != 3 or first.dim() != 2 or first.shape[0] != image.shape[0]
            or image.shape[1] < min_rows or any(t.shape != first.shape for t in ids[1:])):
        raise ValueError(f"{entry}: shapes {[tuple(t.shape) for t in ids]} / "
                         f"{tuple(image.shape)}")


_GATHER = _build.Entry("sorted_gather", "himo_gather_rows_f32", _ROWS_ARGTYPES)
# (spids, order, image, out, B, N, C, rows), then the stream.
_SORTED_GATHER = _build.Entry("sorted_gather", "himo_sorted_gather_rows_f32",
                              (_build.PTR,) * 4 + (_build.INT,) * 4)


def gather_rows(image: torch.Tensor, pids: torch.Tensor) -> torch.Tensor:
    """The resident route's gather (K4): ``image[b, pids[b, i]]`` of a
    (B, rows, C) fp32 image at (B, N) int32 ids -> (B, N, C), ids clamped to
    [0, rows - 1]. Not differentiable itself: :func:`gather_pillars`
    carries the gradient.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/sorted_gather.cu``'s ``himo_gather_rows_f32`` (counted in
    ``gather_rows.launches``) or raise: the kernel takes a contiguous fp32
    image with at least one row and contiguous int32 ids."""
    if image.is_cpu:
        return _gather_rows_plain(image, pids)
    _check_gather_args(_GATHER.name, image, pids, min_rows=1)
    b, rows, c = image.shape
    n = pids.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=image.device)
    _GATHER.launch(image.get_device(), pids.data_ptr(), image.data_ptr(), out.data_ptr(),
                   b, n, c, rows)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def sorted_gather_rows(
    image: torch.Tensor, spids: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """K5, the scatter-max backward's row take on the table and stream
    routes: ``out[b, order[b, j]] = image[b, spids[b, j]]`` for (B, N) ids
    sorted in each frame and ``order``, the stable sort that sorted them (a
    permutation of 0..N-1 per frame, int32), from a (B, rows, C) fp32 image
    -> (B, N, C) in the points' own order; ids >= rows read 0.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/sorted_gather.cu``'s ``himo_sorted_gather_rows_f32`` (counted in
    ``sorted_gather_rows.launches``) or raise: the kernel takes a
    contiguous fp32 image and contiguous int32 ids and order."""
    if image.is_cpu:
        return _sorted_gather_rows_plain(image, spids, order)
    _check_gather_args(_SORTED_GATHER.name, image, spids, order)
    b, rows, c = image.shape
    n = spids.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=image.device)
    _SORTED_GATHER.launch(image.get_device(), spids.data_ptr(), order.data_ptr(),
                          image.data_ptr(), out.data_ptr(), b, n, c, rows)
    sorted_gather_rows.launches += 1
    return out


sorted_gather_rows.launches = 0


def _stable_sort(ids: torch.Tensor):
    """(sorted ids, order): each frame's (N,) ids in the order of a stable
    sort, as the reference's argsort (equal ids keep their point order),
    and that order (int32); both contiguous."""
    order = torch.argsort(ids, dim=1, stable=True)
    return (torch.gather(ids, 1, order).contiguous(),
            order.to(torch.int32).contiguous())


def _sort_rows(ids: torch.Tensor, vals: torch.Tensor):
    """Each frame's (N,) ids and (N, C) rows in the order of a stable sort
    of the ids: the reference's argsort plus one row take
    (``_sort_rows_by_key``)."""
    sids, order = _stable_sort(ids)
    return sids, _take_rows_at(vals, order).contiguous()


def _sorted_max_rows(pids: torch.Tensor, feats: torch.Tensor, rows: int):
    """The stream route's max: a stable sort, then K2 max. Returns the
    image and the sort, which the backward's take reuses."""
    spids, order = _stable_sort(pids)
    out = sorted_scatter_max_rows(spids, _take_rows_at(feats, order).contiguous(), rows)
    return out, (spids, order)


def _sorted_sum_rows(ids: torch.Tensor, vals: torch.Tensor, rows: int) -> torch.Tensor:
    return sorted_scatter_sum_rows(*_sort_rows(ids, vals), rows)


def _resident_sum_rows(ids: torch.Tensor, vals: torch.Tensor, rows: int) -> torch.Tensor:
    """The resident route's sum (K3 sum), ``ops.nn.segment_rows_sum``; read
    from that module at each call (``ops.nn`` imports this one)."""
    from himo_tpu_torch.ops import nn

    return nn.segment_rows_sum(vals, ids, rows)


def _resident_max_rows(pids: torch.Tensor, feats: torch.Tensor, rows: int):
    return scatter_max_resident_rows(pids, feats, rows), ()


def _table_max_rows(pids: torch.Tensor, feats: torch.Tensor, rows: int):
    return scatter_max_rows(pids, feats, rows), ()


def _plain_take(table: torch.Tensor, pids: torch.Tensor, sort) -> torch.Tensor:
    """The resident route's take: plain indexing, ids clamped to the last row."""
    return _take_rows_at(table, torch.clamp(pids.to(torch.int64), max=table.shape[1] - 1))


def _sorted_take(table: torch.Tensor, pids: torch.Tensor, sort) -> torch.Tensor:
    """The table and stream routes' take (K5), at the forward's stable sort
    when it made one (stream), else after one stable argsort (table)."""
    spids, order = sort if sort else _stable_sort(pids)
    return sorted_gather_rows(table, spids, order)


def _routed_max(route: str):
    """(scatter, take) of the route: ``scatter(pids, feats, rows)`` returns
    the image and the sort it made (or ``()``); ``take(table, pids, sort)``
    is the backward's row take."""
    return {"resident": (_resident_max_rows, _plain_take),
            "table": (_table_max_rows, _sorted_take),
            "stream": (_sorted_max_rows, _sorted_take)}[route]


def _routed_sum(route: str):
    return {"resident": _resident_sum_rows, "table": scatter_sum_rows,
            "stream": _sorted_sum_rows}[route]


class _ScatterMax(torch.autograd.Function):
    """Per-row max with the TPU custom VJP: every tied winner gets the whole
    cotangent of its (row, channel). ``scatter(pids, feats, rows)`` returns
    the image and the sort it made; the backward takes (g, out) at each
    point's row with one ``take(table, pids, sort)``, as the reference
    takes them together."""

    @staticmethod
    def forward(ctx, pids, feats, rows, scatter, take):
        out, sort = scatter(pids, feats, rows)
        ctx.save_for_backward(pids, feats, out, *sort)
        ctx.take = take
        return out

    @staticmethod
    def backward(ctx, g):
        pids, feats, out, *sort = ctx.saved_tensors
        rows, c = out.shape[1], out.shape[2]
        both = ctx.take(torch.cat([g, out], dim=-1), pids, tuple(sort))
        winner = (feats == both[..., c:]) & (pids < rows)[..., None]
        return (None, torch.where(winner, both[..., :c], torch.zeros_like(feats)),
                None, None, None)


class _ScatterSum(torch.autograd.Function):
    """Per-row sum ``scatter(ids, vals, rows)``; its backward is the plain
    take of the cotangent at each id (0 for ids >= rows), as the
    reference's sum VJP takes it."""

    @staticmethod
    def forward(ctx, ids, vals, rows, scatter):
        ctx.save_for_backward(ids)
        return scatter(ids, vals, rows)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = g.shape[1]
        d = _take_rows_at(g, torch.clamp(ids.to(torch.int64), max=rows - 1))
        return None, torch.where((ids < rows)[..., None], d, torch.zeros_like(d)), None, None


class _RowTake(torch.autograd.Function):
    """Row take ``take(table, ids)`` of a (B, R, C) table at ids clamped to
    R - 1, whose backward scatter-adds the fp32 cotangent with
    ``scatter(ids, g, R)`` and casts it back. Ids >= R read row ``R - 1``
    and send nothing back (the scatter skips them; callers zero their
    outputs). Behind :func:`gather_pillars` (the K4 kernel or plain
    indexing, then the routed scatter-add) and ``ops.nn.take_rows`` (plain
    indexing, then ``segment_rows_sum``)."""

    @staticmethod
    def forward(ctx, table, ids, take, scatter):
        rows = table.shape[1]
        ctx.save_for_backward(ids)
        ctx.rows = rows
        ctx.scatter = scatter
        return take(table, torch.clamp(ids, max=rows - 1))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = ctx.scatter(ids.to(torch.int32).contiguous(),
                        g.to(torch.float32).contiguous(), ctx.rows)
        return d.to(g.dtype), None, None, None


def _max_rows(pids: torch.Tensor, feats: torch.Tensor, rows: int) -> torch.Tensor:
    """Differentiable per-row max of (B, N, C) fp32 features on the
    reference's route for these shapes."""
    scatter, take = _routed_max(_route(rows, feats.shape[1], feats.shape[2]))
    return _ScatterMax.apply(pids, feats, rows, scatter, take)


def scatter_max(features: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Per-pillar max of (B, N, C) point features -> (B, H, W, C) image.

    Empty pillars come out as 0. Lower precisions are scattered in fp32 and
    cast back (exact: a max of bf16 values is a bf16 value). Differentiable
    in ``features`` (see the module docstring)."""
    h, w = grid.grid_shape
    feats = features.to(torch.float32).contiguous()
    pids = grid.pillar_ids.to(torch.int32).contiguous()
    out = _max_rows(pids, feats, h * w)
    return out.reshape(features.shape[0], h, w, -1).to(features.dtype)


def scatter_max_multi(
    features: Sequence[torch.Tensor], grids: Sequence[PillarGrid]
) -> list:
    """Per-pillar max for K sweeps -> K (B, H, W, C) images.

    As the reference, the sweeps are fused into one max over K * H * W rows
    (sweep k's pillars offset by k * H * W, every trash id moved past the
    last row) only when :func:`_fuse_sweeps` passes: one sweep is not
    resident and the concatenated stream takes the table route (small
    clouds on the 512x512 grid). Otherwise each sweep is its own call. The
    max is exact, so fusion changes the launch count, not the values."""
    if len(features) != len(grids) or not features:
        raise ValueError("need one grid per feature tensor")
    h, w = grids[0].grid_shape
    if any(g.grid_shape != (h, w) for g in grids):
        raise ValueError("every sweep needs the same grid")
    hw, k = h * w, len(features)
    n_total = sum(f.shape[1] for f in features)
    if not _fuse_sweeps(hw, n_total, features[0].shape[-1], k):
        return [scatter_max(f, g) for f, g in zip(features, grids)]
    pids = torch.cat([
        torch.where(g.pillar_ids >= hw, k * hw, g.pillar_ids + i * hw)
        for i, g in enumerate(grids)
    ], dim=1).to(torch.int32).contiguous()
    feats = torch.cat([f.to(torch.float32) for f in features], dim=1).contiguous()
    out = _max_rows(pids, feats, k * hw)
    b = features[0].shape[0]
    return [out[:, i * hw : (i + 1) * hw].reshape(b, h, w, -1).to(f.dtype)
            for i, f in enumerate(features)]


def gather_pillars(image: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Gather each point's pillar feature from a (B, H, W, C) image ->
    (B, N, C). Out-of-range points get zeros. On the resident route the
    image is cast to fp32 for the K4 kernel and the result cast back, as
    the reference does; otherwise the take is plain indexing. Differentiable
    in ``image``: the backward scatter-adds the cotangent in fp32 on the
    route's sum kernel and casts it back to the image's dtype."""
    h, w = grid.grid_shape
    rows = h * w
    flat = image.reshape(image.shape[0], rows, -1)
    pids = grid.pillar_ids.to(torch.int32).contiguous()
    route = _route(rows, pids.shape[1], flat.shape[2])
    if route == "resident":
        table = flat.to(dtype=torch.float32, memory_format=torch.contiguous_format)
        out = _RowTake.apply(table, pids, gather_rows, _routed_sum(route)).to(flat.dtype)
    else:
        out = _RowTake.apply(flat, pids, _take_rows_at, _routed_sum(route))
    return torch.where(grid.in_range[..., None], out, torch.zeros_like(out))


def scatter_mean(features: torch.Tensor, grid: PillarGrid) -> torch.Tensor:
    """Per-pillar mean of (B, N, C) point features -> (B, H, W, C) image;
    empty pillars read 0. As the reference, sums and counts come from one
    fp32 scatter-add of the features with a column of ones appended (masked
    points add nothing), on the route's sum kernel, cast back to the
    features' dtype before the division. Differentiable in ``features``."""
    h, w = grid.grid_shape
    rows = h * w
    keep = grid.in_range[..., None]
    feats = torch.where(keep, features, torch.zeros_like(features))
    aug = torch.cat([feats, keep.to(features.dtype)], dim=-1).to(torch.float32).contiguous()
    pids = grid.pillar_ids.to(torch.int32).contiguous()
    scatter = _routed_sum(_route(rows, aug.shape[1], aug.shape[2]))
    out = _ScatterSum.apply(pids, aug, rows, scatter).to(features.dtype)
    mean = out[..., :-1] / torch.clamp(out[..., -1:], min=1.0)
    return mean.reshape(features.shape[0], h, w, -1)
