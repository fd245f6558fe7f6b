"""The BEV correlation of the correlation stage (``himo.correlation``): two
feature images average-pooled and their local cost volume,

    corr[:, k, y, x] = <P0(y, x), P1(y + dy - r, x + dx - r)> / C,
    k = dy * (2r + 1) + dx,

over the (2r + 1)^2 Chebyshev window, ``P1`` zero past the border.

- :func:`bev_correlation` (one level) and :func:`bev_correlations` (the
  model's levels, one autograd node) take (B, H, W, C) channels-last images,
  as the pillar scatter writes them, and return contiguous (B, (2r + 1)^2,
  H / s, W / s) volumes.
- CPU tensors take the plain form, :func:`_bev_correlation` of
  :func:`_avg_pool` on the NCHW view, as the model always computed it.
- CUDA tensors launch ``csrc/correlation.cu`` or raise: the pooling of both
  images at every level's stride (:func:`correlation_pool`), one volume a
  level (:func:`correlation_volume`) and, in the backward, one gather a level
  (:func:`correlation_backward`). Each kernel wrapper counts its launches in
  ``.launches`` and has a plain version of the same signature
  (``_correlation_*_plain``).

The kernels take any pool stride, up to 64 channels (a count that is not a
multiple of 8 is padded with zero channels) and any radius whose tile fits
in shared memory. Where :func:`torch_order` finds the shapes at which the
kernels reproduce torch 2.11's own reduction orders for the plain form's
``mean``, ``mul``, ``sum`` and ``div`` (the main path's among them), the
volume equals the plain form's on the card bit for bit; elsewhere the
kernels add in their own order, within a few ulps of it. The backward is
the gather form of the plain form's gradient (:func:`_bev_correlation_backward`),
accumulated in fp32 and rounded once to the images' type.

The JAX package has no kernel here: its ``_bev_correlation`` is a
``lax.map`` over the offsets.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from himo_tpu_torch.kernels import _build

# (img0, img1, p0a, p1a, p0b, p1b, B, H, W, C, frame stride, pool_a, lanes_a,
# pool_b, lanes_b, bf16), then the stream.
_POOL = _build.Entry("correlation", "himo_corr_pool", (_build.PTR,) * 6 + (_build.INT,) * 10)
# (p0, p1, out, B, h, w, C in memory, C, radius, bf16), then the stream.
_FORWARD = _build.Entry("correlation", "himo_corr_forward", (_build.PTR,) * 3 + (_build.INT,) * 7)
# (g, p0, p1, extra0, extra1, d0, d1, B, h, w, C in memory, C, radius, g frame
# stride, pool, extra pool, spread, bf16), then the stream.
_BACKWARD = _build.Entry("correlation", "himo_corr_backward",
                         (_build.PTR,) * 7 + (_build.INT,) * 11)

MAX_CHANNELS = 64
_DTYPES = (torch.bfloat16, torch.float32)
_TILE_W = 32  # output pixels a tile row (csrc/correlation.cu's kTileW)
_SMEM_BYTES = 227 * 1024  # shared memory a block may opt into on the H100

Levels = Sequence[Tuple[int, int]]  # (pool stride, radius) per level


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H/s, W/s) mean pool."""
    if stride == 1:
        return x
    b, c, h, w = x.shape
    return x.reshape(b, c, h // stride, stride, w // stride, stride).mean(dim=(3, 5))


def _bev_correlation(f0: torch.Tensor, f1: torch.Tensor, radius: int) -> torch.Tensor:
    """Local cost volume between two (B, C, H, W) BEV feature images ->
    (B, (2r+1)^2, H, W): ``corr[:, k] = <f0(y, x), f1(y+dy, x+dx)> / C`` with
    ``k = dy * win + dx`` over the Chebyshev window. ``f1`` is zero-padded,
    so offsets past the border read 0 (no wrap-around)."""
    _, c, h, w = f0.shape
    win = 2 * radius + 1
    f1p = F.pad(f1, (radius, radius, radius, radius))
    cols = []
    for k in range(win * win):
        dy, dx = divmod(k, win)
        shifted = f1p[:, :, dy : dy + h, dx : dx + w]
        cols.append((f0 * shifted).sum(dim=1) / c)
    return torch.stack(cols, dim=1)


def _bev_correlation_backward(
    g: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, radius: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel's gather: the gradients of
    :func:`_bev_correlation`'s two (B, C, h, w) inputs for the (B, K, h, w)
    cotangent ``g``,

        dP0(p) = sum_k g_k(p) P1(p + d_k) / C,
        dP1(q) = sum_k g_k(q - d_k) P0(q - d_k) / C,

    with ``d_k = (dy - r, dx - r)`` and every term past the border 0."""
    _, c, h, w = p0.shape
    win = 2 * radius + 1
    pad = (radius,) * 4
    p1p, p0p, gp = F.pad(p1, pad), F.pad(p0, pad), F.pad(g, pad)
    d0 = torch.zeros_like(p0)
    d1 = torch.zeros_like(p1)
    for k in range(win * win):
        dy, dx = divmod(k, win)
        d0 = d0 + g[:, k : k + 1] * p1p[:, :, dy : dy + h, dx : dx + w]
        sy, sx = 2 * radius - dy, 2 * radius - dx  # q - d_k, in padded coordinates
        d1 = d1 + gp[:, k : k + 1, sy : sy + h, sx : sx + w] * p0p[:, :, sy : sy + h, sx : sx + w]
    return d0 / c, d1 / c


def _avg_pool_backward(d: torch.Tensor, stride: int) -> torch.Tensor:
    """Plain version of the spread: the gradient of :func:`_avg_pool` for the
    (B, C, h, w) cotangent ``d``, each value over its s x s cell, / s^2."""
    if stride == 1:
        return d
    return d.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3) / stride**2


def _bev_correlations_backward(
    grads: Sequence[torch.Tensor], img0: torch.Tensor, img1: torch.Tensor, levels: Levels
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the whole backward: the gradients of the two (B, H,
    W, C) images for one (B, K, h, w) cotangent a level (None: no gradient),
    every level's spread added into the same image gradient."""
    x0, x1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
    d0 = torch.zeros_like(x0)
    d1 = torch.zeros_like(x1)
    for g, (pool, radius) in zip(grads, levels):
        if g is None:
            continue
        dp0, dp1 = _bev_correlation_backward(g, _avg_pool(x0, pool), _avg_pool(x1, pool), radius)
        d0 = d0 + _avg_pool_backward(dp0, pool)
        d1 = d1 + _avg_pool_backward(dp1, pool)
    return d0.permute(0, 2, 3, 1), d1.permute(0, 2, 3, 1)


# ------------------------------------------------------------ torch 2.11's orders

TORCH_ORDERS = "2.11"  # the torch release whose CUDA reduction orders torch_order copies


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _reduce_block(dim0: int, dim1: int, vec: int) -> Tuple[int, int]:
    """``ReduceConfig::set_block_dimension`` of ATen/native/cuda/Reduce.cuh:
    (block width, block height) for a reduction of ``dim0`` by ``dim1``
    values at output vector size ``vec``."""
    mnt = 512 // vec
    d0 = _last_pow2(dim0) if dim0 < mnt else mnt
    d1 = _last_pow2(dim1) if dim1 < mnt else mnt
    bw = min(d0, 32)
    bh = min(d1, mnt // bw)
    return min(d0, mnt // bh), bh


def torch_order(b: int, c: int, hh: int, ww: int, pool: int) -> Optional[int]:
    """Where one level's bf16 or fp32 volume of (b, hh, ww, c) images equals
    the plain form's on the card bit for bit: the lanes among which torch
    ``TORCH_ORDERS``'s CUDA reductions (ATen/native/cuda/Reduce.cuh) split one
    pooled value, or None where the kernels add in their own order.

    It copies two of that release's choices:

    - the pooling ``mean`` over a channels-last image's (s, s) cells reduces
      along the cell: lane l of ``lanes`` sums cell elements l, l + lanes, ...
      into four accumulators, then a warp shuffle tree with decreasing
      offsets, as ``pool_images`` does for up to 32 lanes of at most 4
      elements each and no split across warps;
    - the channel ``sum`` of the (b, c, h, w) product keeps each output in one
      thread (four accumulators by channel mod 4), as ``corr_forward`` does,
      unless it splits C across warps.

    Pool 1 is never in that order (the plain form's channel sum then runs over
    the channels-last image itself), nor a C that is not a multiple of 8 (its
    rows are padded). Another torch release may choose otherwise: its volume
    is then within a few ulps of the plain form's, like any shape refused
    here."""
    if pool < 2 or c % 8:
        return None
    h, w = hh // pool, ww // pool
    cell = pool * pool
    lanes, bh = _reduce_block(cell, b * c * h * w, 1)
    per_lane = -(-cell // lanes)
    if lanes > 32 or per_lane > 4 or per_lane >= min(bh * 16, 256):
        return None
    hw = h * w
    vec = 4 if hw % 4 == 0 else 2 if hw % 2 == 0 else 1
    _, bh = _reduce_block(max(b * hw // vec, 1), c, vec)
    if c >= min(bh * 16, 256):
        return None
    return lanes


def _pool_lanes(b: int, c: int, hh: int, ww: int, pool: int) -> int:
    """The pooling's lanes for one output: torch's (:func:`torch_order`)
    where the kernels copy its order, else a lane a cell element up to 32."""
    lanes = torch_order(b, c, hh, ww, pool)
    return lanes if lanes is not None else min(_last_pow2(pool * pool), 32)


# ------------------------------------------------------------ kernel wrappers


def _padded(c: int) -> int:
    """Channels a kernel row holds: C rounded up to a multiple of 8."""
    return -(-c // 8) * 8


def _tile_fits(radius: int, c: int, size: int) -> bool:
    """Whether the smallest tile (one row, its halo) of ``c`` channels of
    ``size`` bytes fits in a block's shared memory (``tile_rows`` of
    ``csrc/correlation.cu``)."""
    chunks = c * size // 16
    npix = (1 + 2 * radius) * (_TILE_W + 2 * radius)
    pitch = ((npix + 7) & ~7) + ((8 // chunks) % 8 if chunks & (chunks - 1) == 0 else 1)
    return chunks * pitch * 16 <= _SMEM_BYTES


def _check_images(img0: torch.Tensor, img1: torch.Tensor, levels: Levels) -> None:
    if img0.dtype not in _DTYPES or img1.dtype is not img0.dtype:
        raise TypeError(f"bev_correlation takes bf16 or fp32 images of one type, got "
                        f"{img0.dtype} and {img1.dtype}")
    if img0.dim() != 4 or img0.shape != img1.shape:
        raise ValueError(f"bev_correlation needs two (B, H, W, C) images of one shape, got "
                         f"{tuple(img0.shape)} and {tuple(img1.shape)}")
    if img0.device != img1.device:
        raise ValueError("bev_correlation: images on different devices")
    _, hh, ww, c = img0.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"bev_correlation's kernel takes 1..{MAX_CHANNELS} channels, got {c}")
    if not 1 <= len(levels) <= 2:
        raise ValueError(f"bev_correlation's kernel takes one or two levels, got {len(levels)}")
    smax = max(pool for pool, _ in levels)
    for pool, radius in levels:
        if pool < 1 or smax % pool or hh % pool or ww % pool:
            raise ValueError(f"bev_correlation: pool {pool} does not divide the {hh}x{ww} "
                             f"image or the largest pool {smax}")
        if radius < 0 or not _tile_fits(radius, _padded(c), img0.element_size()):
            raise ValueError(f"bev_correlation: a tile of radius {radius} at {c} channels "
                             f"of {img0.dtype} does not fit in shared memory")


def _frame_ready(img: torch.Tensor) -> torch.Tensor:
    """The image with dense, 16-byte aligned frames of a multiple of 8
    channels (zeros appended), as the pooling kernel reads them (it takes
    any frame stride)."""
    _, h, w, c = img.shape
    if c % 8:
        return F.pad(img, (0, _padded(c) - c))
    size = img.element_size()
    if (img.stride()[1:] != (w * c, c, 1) or img.data_ptr() % 16
            or (img.stride(0) * size) % 16):
        return img.contiguous()
    return img


def _rows(p: torch.Tensor) -> int:
    """Channels in memory of a pooled (B, h, w, C) image as
    :func:`correlation_pool` returns it: dense rows of a multiple of 8."""
    b, h, w, c = p.shape
    cm = p.stride(2)
    if p.stride() != (h * w * cm, w * cm, cm, 1) or cm % 8 or cm < c:
        raise ValueError("correlation: pooled images must be correlation_pool's")
    return cm


def correlation_pool(img0: torch.Tensor, img1: torch.Tensor, pools: Sequence[int]) -> list:
    """Both (B, H, W, C) CUDA images average-pooled at each stride of
    ``pools`` (one or two) -> ``[(P0, P1), ...]``, (B, H/s, W/s, C) in the
    images' type (rows of a multiple of 8 channels, zeros past C), equal to
    PyTorch's ``mean`` over the NCHW view's (s, s) cells: bit for bit where
    :func:`torch_order` says so. One launch of ``csrc/correlation.cu``'s
    ``himo_corr_pool`` (counted in ``correlation_pool.launches``).
    Not differentiable itself."""
    _check_images(img0, img1, [(p, 0) for p in pools])
    b, hh, ww, c = img0.shape
    img0, img1 = _frame_ready(img0), _frame_ready(img1)
    if img1.stride(0) != img0.stride(0):
        img0, img1 = img0.contiguous(), img1.contiguous()
    cm = img0.shape[-1]
    out = []
    args = []
    for pool in pools:
        shape = (b, hh // pool, ww // pool, cm)
        pair = (torch.empty(shape, dtype=img0.dtype, device=img0.device),
                torch.empty(shape, dtype=img0.dtype, device=img0.device))
        out.append(pair)
        args.append((pool, _pool_lanes(b, c, hh, ww, pool)))
    ptrs = [t.data_ptr() for pair in out for t in pair]
    if len(out) == 1:
        ptrs += [None, None]
        args.append((0, 0))
    _POOL.launch(img0.get_device(), img0.data_ptr(), img1.data_ptr(), *ptrs, b, hh, ww, cm,
                 img0.stride(0), *args[0], *args[1], int(img0.dtype is torch.bfloat16))
    correlation_pool.launches += 1
    return [(p0[..., :c], p1[..., :c]) for p0, p1 in out]


correlation_pool.launches = 0


def correlation_volume(p0: torch.Tensor, p1: torch.Tensor, radius: int) -> torch.Tensor:
    """The (B, (2r+1)^2, h, w) volume of two (B, h, w, C) CUDA images pooled
    by :func:`correlation_pool`, equal to :func:`_bev_correlation` of their
    NCHW views on the card (bit for bit where :func:`torch_order` says so).
    One launch of ``himo_corr_forward`` (counted in
    ``correlation_volume.launches``). Not differentiable itself."""
    b, h, w, c = p0.shape
    cm = _rows(p0)
    if _rows(p1) != cm or p1.shape != p0.shape:
        raise ValueError("correlation_volume: pooled images of two layouts")
    win = 2 * radius + 1
    out = torch.empty((b, win * win, h, w), dtype=p0.dtype, device=p0.device)
    _FORWARD.launch(p0.get_device(), p0.data_ptr(), p1.data_ptr(), out.data_ptr(), b, h, w, cm,
                    c, radius, int(p0.dtype is torch.bfloat16))
    correlation_volume.launches += 1
    return out


correlation_volume.launches = 0


def _volume_grad(g: torch.Tensor) -> torch.Tensor:
    """The cotangent with dense frames (any frame stride)."""
    _, _, h, w = g.shape
    return g if g.stride()[1:] == (h * w, w, 1) else g.contiguous()


def correlation_backward(
    grads: Sequence, pooled: Sequence, levels: Levels, image_shape
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two (B, H, W, C) image gradients for one (B, K, h, w) cotangent a
    level (None: none; at least one given), from each level's images pooled
    by :func:`correlation_pool`: one launch of ``himo_corr_backward`` a level
    with a cotangent (counted in ``correlation_backward.launches``). The
    level of the finest pool writes the image gradients; the other one, if
    any, first writes its fp32 contribution, which that launch adds.
    Accumulates in fp32, rounds once."""
    live = [(g, pair, lvl) for g, pair, lvl in zip(grads, pooled, levels) if g is not None]
    dtype, device = pooled[0][0].dtype, pooled[0][0].device
    b, hh, ww, c = image_shape
    cm = _rows(pooled[0][0])
    d0 = torch.empty((b, hh, ww, cm), dtype=dtype, device=device)
    d1 = torch.empty_like(d0)
    live.sort(key=lambda item: -item[2][0])  # coarsest first; the finest spreads
    bf16 = int(dtype is torch.bfloat16)
    index = device.index
    extra = (None, None, 0)
    for i, (g, (p0, p1), (pool, radius)) in enumerate(live):
        g = _volume_grad(g)
        h, w = p0.shape[1:3]
        spread = i == len(live) - 1
        if spread:
            out0, out1 = d0, d1
        else:
            out0 = torch.empty((b, h, w, cm), dtype=torch.float32, device=device)
            out1 = torch.empty_like(out0)
        _BACKWARD.launch(index, g.data_ptr(), p0.data_ptr(), p1.data_ptr(),
                         *(None if e is None else e.data_ptr() for e in extra[:2]),
                         out0.data_ptr(), out1.data_ptr(), b, h, w, cm, c, radius, g.stride(0),
                         pool, extra[2], int(spread), bf16)
        correlation_backward.launches += 1
        if not spread:
            extra = (out0, out1, pool)
    return d0[..., :c], d1[..., :c]


correlation_backward.launches = 0


# ------------------------------------------------------------ plain versions


def _correlation_pool_plain(img0: torch.Tensor, img1: torch.Tensor, pools: Sequence[int]) -> list:
    """Plain version of :func:`correlation_pool`: :func:`_avg_pool` of the
    NCHW views, handed back as (B, h, w, C) views of PyTorch's own result."""
    f0, f1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
    return [(_avg_pool(f0, s).permute(0, 2, 3, 1), _avg_pool(f1, s).permute(0, 2, 3, 1))
            for s in pools]


def _correlation_volume_plain(p0: torch.Tensor, p1: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of :func:`correlation_volume`: :func:`_bev_correlation`
    of the NCHW views."""
    return _bev_correlation(p0.permute(0, 3, 1, 2), p1.permute(0, 3, 1, 2), radius)


def _correlation_backward_plain(
    grads: Sequence, pooled: Sequence, levels: Levels, image_shape
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`correlation_backward`: the gather formula
    (:func:`_bev_correlation_backward`) on each level's pooled images and
    the spread, in fp32, summed and rounded once to the images' type."""
    dtype = pooled[0][0].dtype
    b, hh, ww, c = image_shape
    d0 = torch.zeros((b, c, hh, ww), dtype=torch.float32, device=pooled[0][0].device)
    d1 = torch.zeros_like(d0)
    for g, (p0, p1), (pool, radius) in zip(grads, pooled, levels):
        if g is None:
            continue
        dp0, dp1 = _bev_correlation_backward(g.float(), p0.permute(0, 3, 1, 2).float(),
                                             p1.permute(0, 3, 1, 2).float(), radius)
        d0 = d0 + _avg_pool_backward(dp0, pool)
        d1 = d1 + _avg_pool_backward(dp1, pool)
    return d0.permute(0, 2, 3, 1).to(dtype), d1.permute(0, 2, 3, 1).to(dtype)


# ------------------------------------------------------------ differentiable API


class _BevCorrelation(torch.autograd.Function):
    """Pools and volumes on the kernels; the backward is
    :func:`correlation_backward` on the pooled images saved by the forward
    (2 x 33.5 MB at the fine level of the main path, kept rather than pooled
    again from the images)."""

    @staticmethod
    def forward(ctx, img0, img1, levels):
        pooled = correlation_pool(img0, img1, [pool for pool, _ in levels])
        ctx.set_materialize_grads(False)  # a level without a cotangent costs no launch
        ctx.levels = levels
        ctx.image_shape = img0.shape
        ctx.save_for_backward(*[t for pair in pooled for t in pair])
        return tuple(correlation_volume(p0, p1, radius)
                     for (p0, p1), (_, radius) in zip(pooled, levels))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        pooled = [(saved[2 * i], saved[2 * i + 1]) for i in range(len(ctx.levels))]
        d0, d1 = correlation_backward(grads, pooled, ctx.levels, ctx.image_shape)
        return (d0 if ctx.needs_input_grad[0] else None,
                d1 if ctx.needs_input_grad[1] else None, None)


def _takes_kernels(img: torch.Tensor) -> bool:
    """Whether ``img`` takes the kernels (CUDA tensors) rather than the
    plain form (CPU tensors)."""
    return img.is_cuda


def bev_correlations(img0: torch.Tensor, img1: torch.Tensor, levels: Levels) -> tuple:
    """One volume a level ``(pool, radius)`` of two (B, H, W, C) images:
    ``_bev_correlation(_avg_pool(f0, pool), _avg_pool(f1, pool), radius)``
    of their NCHW views, each contiguous (B, (2r+1)^2, H/pool, W/pool).

    CPU tensors take exactly that plain form. CUDA tensors take the kernels
    (one pooling launch and one launch a level), through one autograd node
    when an image needs a gradient (its backward: one launch a level), or
    raise on what the kernels do not take (:func:`_check_images`)."""
    levels = tuple((int(pool), int(radius)) for pool, radius in levels)
    if not _takes_kernels(img0):
        f0, f1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
        return tuple(_bev_correlation(_avg_pool(f0, pool), _avg_pool(f1, pool), radius)
                     for pool, radius in levels)
    _check_images(img0, img1, levels)
    if torch.is_grad_enabled() and (img0.requires_grad or img1.requires_grad):
        return _BevCorrelation.apply(img0, img1, levels)
    pooled = correlation_pool(img0, img1, [pool for pool, _ in levels])
    return tuple(correlation_volume(p0, p1, radius)
                 for (p0, p1), (_, radius) in zip(pooled, levels))


def bev_correlation(img0: torch.Tensor, img1: torch.Tensor, pool: int, radius: int) -> torch.Tensor:
    """The (B, (2r+1)^2, H/pool, W/pool) volume of two (B, H, W, C) images:
    :func:`bev_correlations` with one level."""
    return bev_correlations(img0, img1, ((pool, radius),))[0]
