"""Connected components on the pillar grid + per-component pooling
(port of ``himo_tpu/ops/components.py``; plain tensor ops, no kernel).

Batched over frames: occupancy (B, H, W), per-point tensors (B, N, ...).

- Labels propagate by iterated windowed MIN over the occupancy grid. The
  min is ``-max_pool2d(-x)`` on float32 labels: labels stay at most ``H*W``
  (65,536 on the 256x256 coarse grid of the 512x512 image), well under
  2^24, so float32 holds them exactly. ``max_pool2d`` pads with -inf, i.e.
  the min pads with +inf, which acts like the reference's "SAME" padding
  with the sentinel ``H*W`` (every label is at most the sentinel).
- Component roots compact to a fixed slot budget via one cumsum; per-point
  pooling is two one-hot matmuls in fp32 (TF32 is off package-wide).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _window_min(x: torch.Tensor, reach: int) -> torch.Tensor:
    """Separable (2*reach+1)^2 windowed min of (B, H, W) float labels."""
    win = 2 * reach + 1
    x = -F.max_pool2d(-x[:, None], (win, 1), stride=1, padding=(reach, 0))
    x = -F.max_pool2d(-x, (1, win), stride=1, padding=(0, reach))
    return x[:, 0]


def connected_components_grid(
    occ: torch.Tensor,  # (B, H, W) bool occupancy
    iters: int = 24,
    reach: int = 2,
) -> torch.Tensor:
    """Label connected blobs of ``occ``; cells within Chebyshev distance
    ``reach`` connect (through occupied cells only).

    Returns (B, H, W) int32: the component's minimum flat index ("root")
    for occupied cells, ``H*W`` for empty ones. ``iters`` bounds the
    labelled diameter at ``iters * reach`` cells."""
    _, h, w = occ.shape
    sentinel = float(h * w)
    cells = torch.arange(h * w, device=occ.device, dtype=torch.float32).reshape(h, w)
    empty = torch.full_like(cells, sentinel)
    lab = torch.where(occ, cells, empty)
    for _ in range(iters):
        lab = torch.where(occ, _window_min(lab, reach), empty)
    return lab.to(torch.int32)


def component_slots(
    labels: torch.Tensor,  # (B, H, W) int32 from connected_components_grid
    max_slots: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact component roots to slot ids in [0, max_slots).

    Returns ``(slot_enc, n_components)``: ``slot_enc`` is (B, H, W) int32
    with ``slot + 1`` for cells in a slotted component and 0 for empty
    cells / overflow components (beyond ``max_slots``, in scan order of
    the root index); ``n_components`` is (B,) int32."""
    b, h, w = labels.shape
    flat = labels.reshape(b, h * w).to(torch.int64)
    occ = flat < h * w
    root = occ & (flat == torch.arange(h * w, device=labels.device))
    rank = torch.cumsum(root.to(torch.int64), dim=1) - 1
    slot_of_cell = torch.where(
        root & (rank < max_slots), rank + 1, torch.zeros_like(rank)
    )
    safe = torch.clamp(flat, max=h * w - 1)
    slot_enc = torch.where(
        occ, torch.gather(slot_of_cell, 1, safe), torch.zeros_like(flat)
    )
    n_components = root.sum(dim=1).to(torch.int32)
    return slot_enc.reshape(b, h, w).to(torch.int32), n_components


def slot_onehot(
    slot: torch.Tensor, valid: torch.Tensor, max_slots: int
) -> torch.Tensor:
    """(B, N) slot ids + (B, N) mask -> (B, N, max_slots) fp32 membership."""
    ids = torch.arange(max_slots, device=slot.device)
    return ((slot[..., None] == ids) & valid[..., None]).to(torch.float32)


def pool_by_slot(
    values: torch.Tensor,  # (B, N, C) per-point values to pool
    weights: torch.Tensor,  # (B, N) pooling weights
    slot: torch.Tensor,  # (B, N) int in [-1, max_slots): -1 = no component
    max_slots: int,
    min_weight: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-component mean, distributed back to the points.

    Returns ``(pooled (B, N, C), ok (B, N) bool)``; ``ok`` marks points
    whose component accumulated at least ``min_weight`` of pooling mass."""
    member = slot >= 0
    s = torch.where(member, slot, torch.zeros_like(slot))
    onehot = slot_onehot(s, member, max_slots)
    w = weights.to(torch.float32)
    aug = torch.cat([values.to(torch.float32) * w[..., None], w[..., None]], dim=-1)
    sums = torch.bmm(onehot.transpose(1, 2), aug)  # (B, S, C+1)
    counts = sums[..., -1]
    means = sums[..., :-1] / torch.clamp(counts, min=1e-6)[..., None]
    ok_slot = counts >= min_weight
    pooled = torch.bmm(
        onehot, torch.where(ok_slot[..., None], means, torch.zeros_like(means))
    )
    ok = member & (
        torch.bmm(onehot, ok_slot.to(torch.float32)[..., None])[..., 0] > 0.5
    )
    return pooled, ok
