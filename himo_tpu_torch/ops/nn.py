"""Nearest-neighbour search and the SSL chamfer terms (port of ``himo_tpu/ops/nn.py``).

Two families, each with a hand-written CUDA kernel on the GPU:

- The streaming search (``csrc/nn.cu``): :func:`nn_min_rows`,
  :func:`nn_argmin_rows`, behind the refine head's :func:`nn_argmin` and
  the differentiable :func:`nn_distance_sq` (the reference's ``_nn_core``
  custom VJP: the argmin kernel forward under grad, the min kernel without,
  and a :func:`segment_rows_sum` backward), which carries
  :func:`truncated_chamfer` and :func:`chamfer_distance`. Padding contract,
  as in the reference: invalid rows are moved to ``SENTINEL`` (1e6 m away)
  before the search, so invalid references lose every min race and need
  no mask inside the kernel; results for invalid queries are masked
  afterwards (0 distance, index 0).
- The fused masked search of the chamfer loss (``csrc/fused_nn.cu``):
  :func:`fused_nn` / :func:`fused_nn_idx`, four masked mins from one
  (query, reference) pair of clouds with additive ``_MASK_BIG`` penalties,
  behind the differentiable :func:`fused_masked_nn`. Its backward, and
  :func:`take_rows`' backward, scatter-add rows with :func:`segment_rows_sum`
  (a stable sort, then ``csrc/sorted_scatter.cu``'s sum in point order).

The kernels compute ``sum((q - r)^2)`` directly in fp32 and walk references
in index order (lowest index wins ties). Their plain PyTorch versions sit
beside them and compute what the reference's CPU path computes,
``|q|^2 + |r|^2 - 2 q.r`` in fp32, so the CPU port agrees with JAX on the
CPU; the two forms differ by a few ulps of ``|q|^2 + |r|^2``. Every wrapper
takes its plain version only for CPU tensors; a CUDA tensor launches the
kernel or raises.

Clouds are batched: queries (B, N, >=3), references (B, M, >=3).
"""

from __future__ import annotations

import torch

from himo_tpu_torch.kernels import _build
from himo_tpu_torch.ops.voxelize import (
    _SORTED_SUM,
    _RowTake,
    _check_rows_args,
    _run_rows_kernel,
    _scatter_sum_rows_plain,
    _take_rows_at,
)

SENTINEL = 1.0e6  # coordinates of padded rows; ~1e12 squared distance
_MASK_BIG = 1.0e14  # additive penalty; SENTINEL^2 distances are ~1e12
_PLAIN_CHUNK = 2048  # queries per block of the plain (B, chunk, M) matrix


def _pad_coords(pts: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """(B, N, >=3) -> contiguous fp32 (B, N, 3) with invalid rows at SENTINEL."""
    xyz = pts[..., :3].to(torch.float32)
    if valid is not None:
        xyz = torch.where(valid[..., None], xyz, torch.full_like(xyz, SENTINEL))
    return xyz.contiguous()


def _d2_plain(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, n, M) squared distances in the reference's ``|q|^2+|r|^2-2q.r``
    form (fp32 throughout)."""
    qn = (q * q).sum(dim=-1, keepdim=True)
    rn = (r * r).sum(dim=-1)[:, None, :]
    dot = torch.bmm(q, r.transpose(1, 2))
    return qn + rn - 2.0 * dot


def _nn_min_plain(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version of the min kernel on (B, N, 3), (B, M, 3) -> (B, N)."""
    return torch.cat(
        [
            _d2_plain(q[:, s : s + _PLAIN_CHUNK], r).amin(dim=-1)
            for s in range(0, q.shape[1], _PLAIN_CHUNK)
        ],
        dim=1,
    )


def _nn_argmin_plain(q: torch.Tensor, r: torch.Tensor):
    """Plain version of the argmin kernel -> ((B, N) d2, (B, N) int32 idx);
    ``torch.min`` returns the first minimal index."""
    d2, idx = [], []
    for s in range(0, q.shape[1], _PLAIN_CHUNK):
        d, i = _d2_plain(q[:, s : s + _PLAIN_CHUNK], r).min(dim=-1)
        d2.append(d)
        idx.append(i.to(torch.int32))
    return torch.cat(d2, dim=1), torch.cat(idx, dim=1)


# (q, r, d2, B, N, M) and (q, r, d2, idx, B, N, M), then the stream.
_NN_MIN = _build.Entry("nn", "himo_nn_min_f32", (_build.PTR,) * 3 + (_build.INT,) * 3)
_NN_ARGMIN = _build.Entry("nn", "himo_nn_argmin_f32",
                          (_build.PTR,) * 4 + (_build.INT,) * 3)


def _check_clouds(q: torch.Tensor, r: torch.Tensor, *penalties: torch.Tensor) -> None:
    """Raise unless (B, N, 3) queries, (B, M, 3) references and any
    penalties are contiguous fp32 tensors on one device (the penalties'
    shapes are the caller's to check)."""
    _build.check_args("nn kernels", f32=(q, r, *penalties))
    if q.dim() != 3 or r.dim() != 3 or q.shape[2] != 3 or r.shape[2] != 3:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(r.shape)}")
    if q.shape[0] != r.shape[0]:
        raise ValueError("queries and references differ in batch")


def _check_kernel_args(q: torch.Tensor, r: torch.Tensor) -> None:
    _check_clouds(q, r)
    if q.requires_grad or r.requires_grad:
        raise RuntimeError("nn kernels have no backward")
    if r.shape[1] == 0:
        raise ValueError("nn kernels need at least one reference point")


def nn_min_rows(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-query min squared distance, (B, N, 3) x (B, M, 3) -> (B, N) fp32.

    CPU tensors take the plain version; CUDA tensors launch ``nn.cu``'s
    ``himo_nn_min_f32`` (counted in ``nn_min_rows.launches``) or raise."""
    if q.is_cpu:
        return _nn_min_plain(q, r)
    _check_kernel_args(q, r)
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if n == 0:
        return d2
    _NN_MIN.launch(q.get_device(), q.data_ptr(), r.data_ptr(), d2.data_ptr(), b, n, m)
    nn_min_rows.launches += 1
    return d2


nn_min_rows.launches = 0


def nn_argmin_rows(q: torch.Tensor, r: torch.Tensor):
    """Per-query (min squared distance, index of the nearest reference),
    (B, N, 3) x (B, M, 3) -> ((B, N) fp32, (B, N) int32); the lowest index
    wins ties.

    CPU tensors take the plain version; CUDA tensors launch ``nn.cu``'s
    ``himo_nn_argmin_f32`` (counted in ``nn_argmin_rows.launches``) or
    raise."""
    if q.is_cpu:
        return _nn_argmin_plain(q, r)
    _check_kernel_args(q, r)
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    if n == 0:
        return d2, idx
    _NN_ARGMIN.launch(q.get_device(), q.data_ptr(), r.data_ptr(), d2.data_ptr(),
                      idx.data_ptr(), b, n, m)
    nn_argmin_rows.launches += 1
    return d2, idx


nn_argmin_rows.launches = 0


def nn_argmin(
    query: torch.Tensor,
    ref: torch.Tensor,
    query_valid: torch.Tensor | None = None,
    ref_valid: torch.Tensor | None = None,
):
    """(min squared distance, index of nearest reference point) per query
    of (B, N, >=3) against (B, M, >=3).

    Invalid refs never win the min race; invalid queries return (0, 0);
    d2 is clamped at >= 0 and idx at <= M - 1. idx is int64, ready for
    indexing."""
    m = ref.shape[1]
    q = _pad_coords(query, query_valid)
    r = _pad_coords(ref, ref_valid)
    d2, idx = nn_argmin_rows(q, r)
    d2 = torch.clamp(d2, min=0.0)
    idx = torch.clamp(idx.to(torch.int64), max=m - 1)
    if query_valid is not None:
        d2 = torch.where(query_valid, d2, torch.zeros_like(d2))
        idx = torch.where(query_valid, idx, torch.zeros_like(idx))
    return d2, idx


class _NNCore(torch.autograd.Function):
    """The reference's ``_nn_core`` custom VJP: the tracking kernel forward
    (K7), and the analytic gradient at the argmin backward,
    ``dq = 2 g (q - r[idx])`` and ``dr = -segment_rows_sum(dq, idx, M)``
    (K3), the latter only when the references need a gradient."""

    @staticmethod
    def forward(ctx, q3, r3):
        d2, idx = nn_argmin_rows(q3.detach(), r3.detach())
        idx = torch.clamp(idx, max=r3.shape[1] - 1)
        ctx.save_for_backward(q3, r3, idx)
        return torch.clamp(d2, min=0.0)

    @staticmethod
    def backward(ctx, g):
        q3, r3, idx = ctx.saved_tensors
        dq = 2.0 * g[..., None] * (q3 - _take_rows_at(r3, idx))
        dr = None
        if ctx.needs_input_grad[1]:
            dr = -segment_rows_sum(dq.contiguous(), idx, r3.shape[1])
        return dq, dr


def _nn_core(q3: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    """Min squared distance per query of contiguous fp32 (B, N, 3) against
    (B, M, 3), clamped at >= 0; differentiable in both clouds. The tracking
    kernel runs only when a gradient is needed, the min-only kernel
    otherwise (as the reference's primal does)."""
    if torch.is_grad_enabled() and (q3.requires_grad or r3.requires_grad):
        return _NNCore.apply(q3, r3)
    return torch.clamp(nn_min_rows(q3, r3), min=0.0)


def nn_distance_sq(
    query: torch.Tensor,
    ref: torch.Tensor,
    query_valid: torch.Tensor | None = None,
    ref_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-query squared distance to the nearest reference point, (B, N)
    fp32; invalid refs never win, invalid queries return 0.

    Differentiable in both clouds (:class:`_NNCore`). Masks act outside the
    core, as in the reference: invalid points move to ``SENTINEL`` through
    a ``where``, which blocks their gradient."""
    d2 = _nn_core(_pad_coords(query, query_valid), _pad_coords(ref, ref_valid))
    if query_valid is not None:
        d2 = torch.where(query_valid, d2, torch.zeros_like(d2))
    return d2


def _frame_mean(values: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Per-frame mean of (B, N) values, over ``valid`` when given -> (B,)."""
    if valid is None:
        return values.mean(dim=-1)
    return _masked_mean(values, valid)


def chamfer_distance(
    pc1: torch.Tensor,
    pc2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Symmetric mean-NN chamfer per frame, (B,): the mean of both
    directions' mean NN distance (not squared), the eval definition."""
    d12 = torch.sqrt(nn_distance_sq(pc1, pc2, valid1, valid2))
    d21 = torch.sqrt(nn_distance_sq(pc2, pc1, valid2, valid1))
    return 0.5 * (_frame_mean(d12, valid1) + _frame_mean(d21, valid2))


def capped(d: torch.Tensor, cap: float) -> torch.Tensor:
    """``min(d, cap)`` whose gradient splits 0.5 / 0.5 at a tie, as
    ``jnp.minimum``'s does (``torch.clamp`` would pass all of it)."""
    return torch.minimum(d, torch.full_like(d, cap))


def truncated_chamfer(
    pc1: torch.Tensor,
    pc2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    max_dist: float = 2.0,
) -> torch.Tensor:
    """Truncated symmetric chamfer on squared distances per frame, (B,):
    distances beyond ``max_dist`` are capped, the scene-flow optimisation
    loss of ``nsfp``."""
    cap = max_dist * max_dist
    d12 = capped(nn_distance_sq(pc1, pc2, valid1, valid2), cap)
    d21 = capped(nn_distance_sq(pc2, pc1, valid2, valid1), cap)
    return _frame_mean(d12, valid1) + _frame_mean(d21, valid2)


# ---------------------------------------------------------------------------
# Row scatter-add (the backward of take_rows and fused_masked_nn).


def _segment_rows_sum_plain(
    vals: torch.Tensor, idx: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain version of :func:`segment_rows_sum` (``index_add_``)."""
    return _scatter_sum_rows_plain(idx, vals, num_segments)


def segment_rows_sum(
    vals: torch.Tensor, idx: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum (B, N, C) fp32 rows into (B, num_segments, C) segments at (B, N)
    int32 ids; ids outside [0, num_segments) are dropped (as
    ``jax.ops.segment_sum`` drops them). The resident route's sum (K3 sum).
    Not differentiable itself: it is the backward of :func:`take_rows`,
    :func:`fused_masked_nn` and, on the resident route,
    ``ops.voxelize.gather_pillars``, and the sum of ``scatter_mean`` there.

    Each segment adds its rows in point order from +0.0, as the reference's
    kernel does, so a result repeats itself bit for bit and equals the
    plain version's sequential ``index_add_``.

    CPU tensors take the plain version. CUDA tensors (counted in
    ``segment_rows_sum.launches``) take a stable sort of each frame's ids,
    which keeps equal ids in point order, and one row take, then
    ``csrc/sorted_scatter.cu``'s ``himo_sorted_scatter_sum_f32``, the K2
    sum, which zeroes its table and adds each run in stream order; they
    raise on inputs the kernel does not take."""
    if vals.is_cpu:
        return _segment_rows_sum_plain(vals, idx, num_segments)
    _check_rows_args("segment_rows_sum", idx, vals)
    sids, order = torch.sort(idx, dim=1, stable=True)
    svals = torch.gather(vals, 1, order[..., None].expand(-1, -1, vals.shape[2]))
    out = _run_rows_kernel(_SORTED_SUM, sids, svals, num_segments)
    segment_rows_sum.launches += 1
    return out


segment_rows_sum.launches = 0


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable row take ``x[b, idx[b]]`` of (B, N, C) at (B, K) ids
    in [0, N) -> (B, K, C); its backward is :func:`segment_rows_sum`."""
    return _RowTake.apply(x, idx, _take_rows_at,
                          lambda ids, g, rows: segment_rows_sum(g, ids, rows))


# ---------------------------------------------------------------------------
# Fused masked NN: the four chamfer mins of the SSL loss from one pair of
# clouds. Masks are additive penalties (0 live, _MASK_BIG masked), so one
# pass serves the all-points and the dynamic-only variants.


def _fused_nn_plain(q, r, qa, qd, ra, rd):
    """Plain version of both fused kernels: (B, N, 3) queries, (B, M, 3)
    references, penalties qa, qd (B, N) and ra, rd (B, M) ->
    ``(dq_a, dq_d, dr_a, dr_d, iq_a, iq_d, ir_a, ir_d)``: per query the min
    of ``d2 + ra`` and ``d2 + rd`` over references, per reference the min
    of ``d2 + qa`` and ``d2 + qd`` over queries, and their int32 indices.

    ``|q|^2 + |r|^2 - 2 q.r`` in fp32, chunked over queries, as the
    reference's CPU path (``_fused_xla``) computes it; the lowest index
    wins ties in both directions (``torch.min`` returns the first minimum,
    and a later chunk replaces a column min only when strictly smaller)."""
    b, m = q.shape[0], r.shape[1]
    row = ([], [], [], [])
    col_d = [torch.full((b, m), float("inf"), dtype=torch.float32, device=q.device)
             for _ in range(2)]
    col_i = [torch.zeros((b, m), dtype=torch.int32, device=q.device) for _ in range(2)]
    for s in range(0, q.shape[1], _PLAIN_CHUNK):
        d2 = _d2_plain(q[:, s : s + _PLAIN_CHUNK], r)
        for k, pen in enumerate((ra, rd)):
            v, i = (d2 + pen[:, None, :]).min(dim=2)
            row[k].append(v)
            row[k + 2].append(i.to(torch.int32))
        for k, pen in enumerate((qa, qd)):
            v, i = (d2 + pen[:, s : s + _PLAIN_CHUNK, None]).min(dim=1)
            better = v < col_d[k]
            col_d[k] = torch.where(better, v, col_d[k])
            col_i[k] = torch.where(better, i.to(torch.int32) + s, col_i[k])
    dq_a, dq_d, iq_a, iq_d = (torch.cat(x, dim=1) for x in row)
    return dq_a, dq_d, col_d[0], col_d[1], iq_a, iq_d, col_i[0], col_i[1]


# (q, r, qa, qd, ra, rd, four mins[, four indices], scratch, B, N, M), then
# the stream.
_FUSED = _build.Entry("fused_nn", "himo_fused_nn_f32", (_build.PTR,) * 11 + (_build.INT,) * 3)
_FUSED_IDX = _build.Entry("fused_nn", "himo_fused_nn_idx_f32",
                          (_build.PTR,) * 15 + (_build.INT,) * 3)


def _run_fused_kernel(entry: _build.Entry, q, r, penalties, with_idx: bool):
    """Launch a ``csrc/fused_nn.cu`` entry on validated inputs; returns the
    four mins and, ``with_idx``, the four int32 indices. The kernel merges
    every min across blocks in a 64-bit key per output, in scratch that it
    fills itself."""
    _check_clouds(q, r, *penalties)
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    if n == 0 or m == 0:
        raise ValueError("fused nn kernels need points on both sides")
    for p, size in zip(penalties, (n, n, m, m)):
        if p.shape != (b, size):
            raise ValueError(f"penalty {tuple(p.shape)}: need ({b}, {size})")
    outs = [torch.empty((b, k), dtype=torch.float32, device=q.device)
            for k in (n, n, m, m)]
    if with_idx:
        outs += [torch.empty((b, k), dtype=torch.int32, device=q.device)
                 for k in (n, n, m, m)]
    scratch = torch.empty(2 * b * (n + m), dtype=torch.int64, device=q.device)
    entry.launch(q.get_device(), q.data_ptr(), r.data_ptr(),
                 *(p.data_ptr() for p in penalties), *(o.data_ptr() for o in outs),
                 scratch.data_ptr(), b, n, m)
    return tuple(outs)


def fused_nn(q, r, qa, qd, ra, rd):
    """The four masked mins ``(dq_a, dq_d, dr_a, dr_d)`` of contiguous fp32
    (B, N, 3) / (B, M, 3) clouds and penalties (see :func:`_fused_nn_plain`).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/fused_nn.cu``'s ``himo_fused_nn_f32`` (counted in
    ``fused_nn.launches``) or raise."""
    if q.is_cpu:
        return _fused_nn_plain(q, r, qa, qd, ra, rd)[:4]
    outs = _run_fused_kernel(_FUSED, q, r, (qa, qd, ra, rd), False)
    fused_nn.launches += 1
    return outs


fused_nn.launches = 0


def fused_nn_idx(q, r, qa, qd, ra, rd):
    """:func:`fused_nn` plus the int32 index of each min
    ``(dq_a, dq_d, dr_a, dr_d, iq_a, iq_d, ir_a, ir_d)``; the lowest index
    wins ties.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/fused_nn.cu``'s ``himo_fused_nn_idx_f32`` (counted in
    ``fused_nn_idx.launches``) or raise."""
    if q.is_cpu:
        return _fused_nn_plain(q, r, qa, qd, ra, rd)
    outs = _run_fused_kernel(_FUSED_IDX, q, r, (qa, qd, ra, rd), True)
    fused_nn_idx.launches += 1
    return outs


fused_nn_idx.launches = 0


def _fused_dispatch(q3, r3, qa, qd, ra, rd, track_idx: bool):
    """Run the fused mins; distances clamped at >= 0 and, with
    ``track_idx``, int64 indices clamped at <= (size of the other side) - 1,
    as the reference does."""
    q = q3.to(torch.float32).contiguous()
    r = r3.to(torch.float32).contiguous()
    pens = tuple(p.to(torch.float32).contiguous() for p in (qa, qd, ra, rd))
    outs = (fused_nn_idx if track_idx else fused_nn)(q, r, *pens)
    dists = tuple(torch.clamp(o, min=0.0) for o in outs[:4])
    if not track_idx:
        return dists
    n, m = q.shape[1], r.shape[1]
    idxs = tuple(
        torch.clamp(o.to(torch.int64), max=lim - 1)
        for o, lim in zip(outs[4:], (m, m, n, n))
    )
    return dists + idxs


class _FusedMaskedNN(torch.autograd.Function):
    """The reference's ``fused_masked_nn`` custom VJP: the tracking kernel
    forward, and the analytic gradient at the argmins backward."""

    @staticmethod
    def forward(ctx, q3, r3, qa, qd, ra, rd):
        outs = _fused_dispatch(q3, r3, qa, qd, ra, rd, track_idx=True)
        ctx.save_for_backward(q3, r3, *outs[4:])
        return outs[:4]

    @staticmethod
    def backward(ctx, g_qa, g_qd, g_ra, g_rd):
        q3, r3, iqa, iqd, ira, ird = ctx.saved_tensors
        n, m = q3.shape[1], r3.shape[1]

        def diffs(gv, src, dst, idx):
            return 2.0 * gv[..., None] * (src - _take_rows_at(dst, idx))

        dq_a = diffs(g_qa, q3, r3, iqa)
        dq_d = diffs(g_qd, q3, r3, iqd)
        dr_a = diffs(g_ra, r3, q3, ira)
        dr_d = diffs(g_rd, r3, q3, ird)
        # One scatter per destination: both sources, one segment table.
        ids_r = torch.cat([iqa, iqd], dim=1).to(torch.int32).contiguous()
        ids_q = torch.cat([ira, ird], dim=1).to(torch.int32).contiguous()
        dr_scatter = segment_rows_sum(torch.cat([dq_a, dq_d], dim=1), ids_r, m)
        dq_scatter = segment_rows_sum(torch.cat([dr_a, dr_d], dim=1), ids_q, n)
        dq = dq_a + dq_d - dq_scatter
        dr = dr_a + dr_d - dr_scatter
        return dq, dr, None, None, None, None


def fused_masked_nn(q3, r3, qa, qd, ra, rd):
    """Four masked NN sweeps over one pair of fp32 clouds.

    Args:
        q3 / r3: (B, N, 3) / (B, M, 3) clouds.
        qa / qd: (B, N) additive penalties (0 = live, ``_MASK_BIG`` =
            masked) on the queries WHEN THEY ACT AS REFERENCES (r -> q).
        ra / rd: (B, M) penalties on the references (q -> r).

    Returns:
        (dq_all, dq_dyn, dr_all, dr_dyn) squared NN distances. Rows whose
        own side is masked are garbage: exclude them in the reduction.
        Differentiable in q3 / r3 (analytic gradient at the argmin); the
        tracking kernel runs only when a gradient is needed, the min-only
        kernel otherwise (as the reference's primal does)."""
    if torch.is_grad_enabled() and (q3.requires_grad or r3.requires_grad):
        return _FusedMaskedNN.apply(q3, r3, qa, qd, ra, rd)
    return _fused_dispatch(q3, r3, qa, qd, ra, rd, track_idx=False)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-frame mean of (B, N) values over a (B, N) mask -> (B,)."""
    total = torch.where(mask, values, torch.zeros_like(values)).sum(dim=-1)
    return total / torch.clamp(mask.to(values.dtype).sum(dim=-1), min=1.0)


def fused_chamfer_terms(
    warped: torch.Tensor,
    pc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    dynamic0: torch.Tensor,
    dynamic1: torch.Tensor,
    max_dist: float = 2.0,
    dynamic_max_dist: float | None = None,
):
    """Per frame (B,): (truncated chamfer over all valid points, truncated
    chamfer over the SSL-dynamic subsets), both from ONE fused NN pass.
    ``dynamic_max_dist`` widens the dynamic term's truncation radius
    (default ``max_dist``). The truncation is ``torch.minimum``, whose
    gradient splits 0.5 / 0.5 at the cap, as ``jnp.minimum``'s does."""

    def to_pen(mask):
        return torch.where(mask, 0.0, _MASK_BIG).to(torch.float32)

    dq_all, dq_dyn, dr_all, dr_dyn = fused_masked_nn(
        warped[..., :3], pc1[..., :3], to_pen(valid0), to_pen(valid0 & dynamic0),
        to_pen(valid1), to_pen(valid1 & dynamic1),
    )
    dyn_dist = max_dist if dynamic_max_dist is None else dynamic_max_dist
    cap, dyn_cap = max_dist * max_dist, dyn_dist * dyn_dist
    chamfer = _masked_mean(capped(dq_all, cap), valid0) + _masked_mean(
        capped(dr_all, cap), valid1
    )
    dyn = _masked_mean(capped(dq_dyn, dyn_cap), valid0 & dynamic0) + _masked_mean(
        capped(dr_dyn, dyn_cap), valid1 & dynamic1
    )
    return chamfer, dyn
