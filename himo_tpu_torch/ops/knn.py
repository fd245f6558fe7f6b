"""Streaming k-nearest-neighbour distances (port of ``himo_tpu/ops/knn.py``).

:func:`knn_rows` is the kernel entry point (``csrc/knn.cu``, which replaces
the TPU kernel ``_knn_kernel``): per query, the k smallest DISTINCT squared
distances to a reference cloud, ascending, with 3.0e38 in the slots nothing
fills. Exact-equal distances collapse into one slot, as in the TPU kernel
(its k passes of min-then-mask-every-entry-<=-the-min); the reference's XLA
fallback (``lax.top_k``) would keep them. The plain version applies the TPU
kernel's rule to the ``|q|^2 + |r|^2 - 2 q.r`` matrix in fp32, so on the
CPU the port agrees with JAX's interpreted kernel.

:func:`knn_distance_sq` pads and masks as the reference does, and
:func:`knn_smoothed_chamfer` is the ``nsfp`` loss with ``knn_k > 0``. Clouds
are batched: (B, N, >=3).
"""

from __future__ import annotations

import torch

from himo_tpu_torch.kernels import _build
from himo_tpu_torch.ops.nn import (
    _PLAIN_CHUNK,
    SENTINEL,
    _check_kernel_args,
    _d2_plain,
    _frame_mean,
    _pad_coords,
    capped,
    nn_distance_sq,
)

_INF = 3.0e38  # the value of an empty slot
_REF_TILE = 1024  # the reference pads references to a multiple of this
MAX_K = 16  # the largest k the kernel is built for

# (q, r, out, B, N, M, k), then the stream.
_KNN = _build.Entry("knn", "himo_knn_f32", (_build.PTR,) * 3 + (_build.INT,) * 4)


def _knn_plain(q: torch.Tensor, r: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the k-NN kernel on (B, N, 3), (B, M, 3) -> (B, N, k):
    k passes of (row min, set every entry <= the min to 3.0e38) over the
    ``|q|^2 + |r|^2 - 2 q.r`` matrix, chunked over queries."""
    out = []
    for s in range(0, q.shape[1], _PLAIN_CHUNK):
        cur = _d2_plain(q[:, s : s + _PLAIN_CHUNK], r)
        cols = []
        for _ in range(k):
            low = cur.amin(dim=-1)
            cols.append(low)
            cur.masked_fill_(cur <= low[..., None], _INF)
        out.append(torch.stack(cols, dim=-1))
    return torch.cat(out, dim=1)


def knn_rows(q: torch.Tensor, r: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest distinct squared distances per query, ascending,
    (B, N, 3) x (B, M, 3) -> (B, N, k) fp32; 3.0e38 where fewer than k
    distinct distances exist.

    CPU tensors take the plain version. CUDA tensors launch ``knn.cu``'s
    ``himo_knn_f32`` (counted in ``knn_rows.launches``) or raise; the kernel
    is built for k in 1..16."""
    if q.is_cpu:
        return _knn_plain(q, r, k)
    _check_kernel_args(q, r)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel takes k in 1..{MAX_K}, got {k}")
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    out = torch.empty((b, n, k), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    _KNN.launch(q.get_device(), q.data_ptr(), r.data_ptr(), out.data_ptr(), b, n, m, k)
    knn_rows.launches += 1
    return out


knn_rows.launches = 0


def knn_distance_sq(
    query: torch.Tensor,
    ref: torch.Tensor,
    k: int,
    query_valid: torch.Tensor | None = None,
    ref_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, N, k) smallest distinct squared distances to the reference
    cloud, ascending. Invalid refs never win; invalid queries get 0. Not
    differentiable (the loss carries its gradient through the single NN).

    The reference pads references with ``SENTINEL`` rows to a multiple of
    1,024, and those rows are a candidate (one, after the collapse) at
    about 3e12; so is any masked reference, which sits at the same point.
    The port pads nothing but appends one ``SENTINEL`` row where the
    reference pads, so that a query with fewer than k distinct valid
    references reads what the reference reads."""
    q = _pad_coords(query, query_valid).detach()
    r = _pad_coords(ref, ref_valid).detach()
    if r.shape[1] % _REF_TILE:
        r = torch.cat([r, torch.full_like(r[:, :1], SENTINEL)], dim=1)
    d2 = torch.clamp(knn_rows(q, r, k), min=0.0)
    if query_valid is not None:
        d2 = torch.where(query_valid[..., None], d2, torch.zeros_like(d2))
    return d2


def knn_smoothed_chamfer(
    pc1: torch.Tensor,
    pc2: torch.Tensor,
    k: int = 4,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    max_dist: float = 2.0,
) -> torch.Tensor:
    """Truncated symmetric chamfer over the mean of the k nearest distinct
    distances, per frame (B,). The value is the k-mean; the gradient is the
    single nearest neighbour's (``dk - stop(d1) + d1``), as in the
    reference."""
    cap = max_dist * max_dist

    def one_side(a, b, va, vb):
        dk = capped(knn_distance_sq(a, b, k, va, vb), cap).mean(dim=-1)
        d1 = capped(nn_distance_sq(a, b, va, vb), cap)
        return _frame_mean(dk - d1.detach() + d1, va)

    return one_side(pc1, pc2, valid1, valid2) + one_side(pc2, pc1, valid2, valid1)
