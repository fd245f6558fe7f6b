"""Streaming nearest-neighbour search (port of ``himo_tpu/ops/nn.py``, forward only).

Padding contract, as in the reference: invalid rows are moved to
``SENTINEL`` (1e6 m away) before the search, so invalid references simply
lose every min race and need no mask inside the kernel; results for invalid
queries are masked afterwards (0 distance, index 0).

On the GPU the search runs in a hand-written CUDA kernel (``csrc/nn.cu``)
that computes ``sum((q - r)^2)`` directly in fp32 and walks references in
index order (lowest index wins ties). Its plain PyTorch versions sit beside
it and compute what the reference's CPU path computes,
``|q|^2 + |r|^2 - 2 q.r`` in fp32, so the CPU port agrees with JAX on the CPU;
the two forms differ by a few ulps of ``|q|^2 + |r|^2``. The wrappers
:func:`nn_min_rows` and :func:`nn_argmin_rows` take the plain versions only
for CPU tensors; a CUDA tensor launches the kernel or raises.

Clouds are batched: queries (B, N, >=3), references (B, M, >=3).
"""

from __future__ import annotations

import torch

from himo_tpu_torch.kernels import _build

SENTINEL = 1.0e6  # coordinates of padded rows; ~1e12 squared distance
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


_NN_SIGNATURES = {
    "himo_nn_min_f32": (
        _build.PTR, _build.PTR, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.PTR,
    ),
    "himo_nn_argmin_f32": (
        _build.PTR, _build.PTR, _build.PTR, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.PTR,
    ),
}


def _check_kernel_args(q: torch.Tensor, r: torch.Tensor) -> None:
    if q.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"nn kernels take fp32, got {q.dtype} / {r.dtype}")
    if q.dim() != 3 or r.dim() != 3 or q.shape[2] != 3 or r.shape[2] != 3:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(r.shape)}")
    if q.shape[0] != r.shape[0] or q.device != r.device:
        raise ValueError("queries and references differ in batch or device")
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("nn kernels need contiguous inputs")
    if q.requires_grad or r.requires_grad:
        raise RuntimeError("nn kernels have no backward yet")
    if r.shape[1] == 0:
        raise ValueError("nn kernels need at least one reference point")


def nn_min_rows(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-query min squared distance, (B, N, 3) x (B, M, 3) -> (B, N) fp32.

    CPU tensors take the plain version; CUDA tensors launch ``nn.cu``'s
    ``himo_nn_min_f32`` (counted in ``nn_min_rows.launches``) or raise."""
    if q.device.type == "cpu":
        return _nn_min_plain(q, r)
    _check_kernel_args(q, r)
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if n == 0:
        return d2
    lib = _build.load("nn", _NN_SIGNATURES)
    code = lib.himo_nn_min_f32(
        q.data_ptr(), r.data_ptr(), d2.data_ptr(), b, n, m,
        _build.stream_handle(q.device),
    )
    nn_min_rows.launches += 1
    _build.check(code, "nn_min kernel")
    return d2


nn_min_rows.launches = 0


def nn_argmin_rows(q: torch.Tensor, r: torch.Tensor):
    """Per-query (min squared distance, index of the nearest reference),
    (B, N, 3) x (B, M, 3) -> ((B, N) fp32, (B, N) int32); the lowest index
    wins ties.

    CPU tensors take the plain version; CUDA tensors launch ``nn.cu``'s
    ``himo_nn_argmin_f32`` (counted in ``nn_argmin_rows.launches``) or
    raise."""
    if q.device.type == "cpu":
        return _nn_argmin_plain(q, r)
    _check_kernel_args(q, r)
    b, n, m = q.shape[0], q.shape[1], r.shape[1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    if n == 0:
        return d2, idx
    lib = _build.load("nn", _NN_SIGNATURES)
    code = lib.himo_nn_argmin_f32(
        q.data_ptr(), r.data_ptr(), d2.data_ptr(), idx.data_ptr(), b, n, m,
        _build.stream_handle(q.device),
    )
    nn_argmin_rows.launches += 1
    _build.check(code, "nn_argmin kernel")
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


def nn_distance_sq(
    query: torch.Tensor,
    ref: torch.Tensor,
    query_valid: torch.Tensor | None = None,
    ref_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-query squared distance to the nearest reference point, (B, N)
    fp32; invalid refs never win, invalid queries return 0. Forward only."""
    q = _pad_coords(query, query_valid)
    r = _pad_coords(ref, ref_valid)
    d2 = torch.clamp(nn_min_rows(q, r), min=0.0)
    if query_valid is not None:
        d2 = torch.where(query_valid, d2, torch.zeros_like(d2))
    return d2
