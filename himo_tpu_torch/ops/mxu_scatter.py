"""Sum-scatter and gather over a pillar-sorted point stream (port of
``himo_tpu/ops/mxu_scatter.py``): the kernels of ``pooling='mean_sorted'``.

The model sorts each sweep's points by pillar id itself (a stable argsort)
and hands these functions the sorted (B, N) ids:

- :func:`scatter_sum_sorted`: per-pillar sums of (B, N, C) rows into a
  (B, num_rows, C) image, on :func:`sorted_segment_sum`
  (``csrc/sorted_scatter.cu``, TPU kernel K10, ``_scatter_sum_band_kernel``);
- :func:`gather_rows_sorted`: its transpose, each point's image row, on
  :func:`sorted_segment_gather` (``csrc/sorted_gather.cu``, K11,
  ``_gather_band_kernel``).

Each is the other's backward, with the same ``mxu_bf16``, as in the
reference's custom VJPs. The reference runs both as one-hot matmuls on the
TPU's matrix unit; ``mxu_bf16=True`` runs them on bf16 operands with fp32
accumulation. On the GPU the flag rounds every value the kernel reads (the
sum's input rows, the gather's image) to bf16, round to nearest even, and
sums in fp32. Two differences from the reference, both stated where they
matter:

- the reference's image carries 8 trash rows past ``num_rows`` (ids >=
  ``num_rows`` sum into them, and read them back); here the image has
  ``num_rows`` rows, the sum skips ids >= ``num_rows`` and the gather reads
  0 for them, as the reference reads its trash rows where the model appends
  8 zero rows;
- the reference's scalar fallback for a 128-point chunk whose ids span
  more than its window adds or copies the values unrounded; here every
  value is rounded when ``mxu_bf16`` is set.

The sums add each row's values in stream order from +0.0 (the TPU adds
window by window), so they agree with the reference within fp32 rounding,
and the kernel is deterministic. CPU tensors take the plain versions; CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

from himo_tpu_torch.kernels import _build
from himo_tpu_torch.ops.voxelize import (
    _check_gather_args,
    _run_rows_kernel,
    _scatter_sum_rows_plain,
    _take_live_rows,
)

# (spids, svals, out, B, N, C, rows, round_bf16), then the stream.
_SEGMENT_SUM = _build.Entry("sorted_scatter", "himo_sorted_segment_sum_f32",
                            (_build.PTR,) * 3 + (_build.INT,) * 5)
# (spids, image, out, B, N, C, rows, round_bf16), then the stream.
_SEGMENT_GATHER = _build.Entry("sorted_gather", "himo_sorted_segment_gather_f32",
                               (_build.PTR,) * 3 + (_build.INT,) * 5)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (round to nearest even), back in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _sorted_segment_sum_plain(
    spids: torch.Tensor, svals: torch.Tensor, rows: int, bf16: bool = False
) -> torch.Tensor:
    """Plain version of K10: ``index_add_`` of the (rounded when ``bf16``)
    values into a zeroed (B, rows, C) table; ids outside [0, rows) skipped.
    On the CPU it adds in stream order, as the kernel does."""
    return _scatter_sum_rows_plain(spids, _round_bf16(svals) if bf16 else svals, rows)


def sorted_segment_sum(
    spids: torch.Tensor, svals: torch.Tensor, rows: int, bf16: bool = False
) -> torch.Tensor:
    """K10: per-row sums of (B, N, C) fp32 values at (B, N) int32 ids
    sorted in each frame -> (B, rows, C); rows no id reaches read 0, ids >=
    rows are skipped; with ``bf16`` each value is rounded to bf16 first.
    Not differentiable itself: :func:`scatter_sum_sorted` carries the
    gradient.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/sorted_scatter.cu``'s ``himo_sorted_segment_sum_f32`` (counted
    in ``sorted_segment_sum.launches`` and, by width C, in
    ``sorted_segment_sum.launches_by_c``) or raise: the kernel takes
    contiguous fp32 values and int32 ids."""
    if svals.is_cpu:
        return _sorted_segment_sum_plain(spids, svals, rows, bf16)
    out = _run_rows_kernel(_SEGMENT_SUM, spids, svals, rows, int(bf16))
    sorted_segment_sum.launches += 1
    by_c = sorted_segment_sum.launches_by_c
    by_c[svals.shape[-1]] = by_c.get(svals.shape[-1], 0) + 1
    return out


sorted_segment_sum.launches = 0
sorted_segment_sum.launches_by_c = {}


def _sorted_segment_gather_plain(
    image: torch.Tensor, spids: torch.Tensor, bf16: bool = False
) -> torch.Tensor:
    """Plain version of K11: ``image[b, spids[b, j]]`` of the (rounded when
    ``bf16``) image, 0 for ids outside [0, rows)."""
    return _take_live_rows(_round_bf16(image) if bf16 else image, spids)


def sorted_segment_gather(
    image: torch.Tensor, spids: torch.Tensor, bf16: bool = False
) -> torch.Tensor:
    """K11: ``out[b, j] = image[b, spids[b, j]]`` of a (B, rows, C) fp32
    image at (B, N) int32 ids sorted in each frame -> (B, N, C); ids >= rows
    read 0; with ``bf16`` each image value is rounded to bf16. Not
    differentiable itself: :func:`gather_rows_sorted` carries the gradient.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/sorted_gather.cu``'s ``himo_sorted_segment_gather_f32`` (counted
    in ``sorted_segment_gather.launches``) or raise: the kernel takes a
    contiguous fp32 image and contiguous int32 ids."""
    if image.is_cpu:
        return _sorted_segment_gather_plain(image, spids, bf16)
    _check_gather_args(_SEGMENT_GATHER.name, image, spids)
    b, rows, c = image.shape
    n = spids.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=image.device)
    _SEGMENT_GATHER.launch(image.get_device(), spids.data_ptr(), image.data_ptr(),
                           out.data_ptr(), b, n, c, rows, int(bf16))
    sorted_segment_gather.launches += 1
    return out


sorted_segment_gather.launches = 0


class _ScatterSumSorted(torch.autograd.Function):
    """K10 forward; backward K11 on the cotangent, with the same flag."""

    @staticmethod
    def forward(ctx, spids, feats, rows, bf16):
        ctx.save_for_backward(spids)
        ctx.bf16 = bf16
        return sorted_segment_sum(spids, feats, rows, bf16)

    @staticmethod
    def backward(ctx, g):
        (spids,) = ctx.saved_tensors
        return (None, sorted_segment_gather(g.contiguous(), spids, ctx.bf16), None,
                None)


class _GatherRowsSorted(torch.autograd.Function):
    """K11 forward; backward K10 on the cotangent, with the same flag."""

    @staticmethod
    def forward(ctx, spids, image, bf16):
        ctx.save_for_backward(spids)
        ctx.bf16 = bf16
        ctx.rows = image.shape[1]
        return sorted_segment_gather(image, spids, bf16)

    @staticmethod
    def backward(ctx, g):
        (spids,) = ctx.saved_tensors
        return None, sorted_segment_sum(spids, g.contiguous(), ctx.rows, ctx.bf16), None


def scatter_sum_sorted(
    spids: torch.Tensor, feats: torch.Tensor, *, num_rows: int, mxu_bf16: bool = False
) -> torch.Tensor:
    """Sum-scatter (B, N, C) rows at (B, N) pillar ids sorted ascending in
    each frame -> (B, num_rows, C) fp32; ids >= ``num_rows`` are skipped
    (the reference sums them into 8 trash rows, which every caller slices
    off). ``mxu_bf16=True`` rounds each value to bf16 before the fp32 sum
    (the reference's bf16 one-hot matmul). Differentiable in ``feats``: the
    backward is :func:`gather_rows_sorted`'s kernel on the cotangent, with
    the same flag."""
    feats = feats.to(torch.float32).contiguous()
    spids = spids.to(torch.int32).contiguous()
    return _ScatterSumSorted.apply(spids, feats, num_rows, mxu_bf16)


def gather_rows_sorted(
    spids: torch.Tensor, image: torch.Tensor, *, num_rows: int, mxu_bf16: bool = False
) -> torch.Tensor:
    """Each point's row of a (B, num_rows, C) image at (B, N) pillar ids
    sorted ascending in each frame -> (B, N, C) fp32; ids >= ``num_rows``
    read 0 (the reference reads the zero trash rows its callers append).
    ``mxu_bf16=True`` rounds the image to bf16 (the reference's bf16
    one-hot matmul). Differentiable in ``image``: the backward is
    :func:`scatter_sum_sorted`'s kernel on the cotangent, with the same
    flag."""
    if image.shape[1] != num_rows:
        raise ValueError(f"image has {image.shape[1]} rows, num_rows is {num_rows}")
    image = image.to(torch.float32).contiguous()
    spids = spids.to(torch.int32).contiguous()
    return _GatherRowsSorted.apply(spids, image, mxu_bf16)
