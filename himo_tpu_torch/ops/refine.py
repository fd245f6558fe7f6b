"""Per-slot translation refinement: trimmed ICP + null test
(port of ``himo_tpu/ops/refine.py``, inference only).

Batched over frames: every per-point tensor is (B, K, ...) and every per-slot
tensor (B, S, ...). Each predicted-dynamic component seeds a translation
from its pooled mean flow; de-smeared trimmed NN-ICP passes against the
second sweep's dynamic neighbourhood refine it; a matched-residual score
accepts or rejects it; a null test snaps statics to exact zero. All ten
``nn_argmin`` passes (claim, 8 ICP, null) and the one ``nn_distance_sq``
pass (score) run batched over frames, one kernel launch each on the GPU.
Per-slot sums are one-hot matmuls in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from himo_tpu_torch.ops.components import slot_onehot
from himo_tpu_torch.ops.nn import nn_argmin, nn_distance_sq


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    num_query: int = 4096  # pc0 member-point subset
    num_ref: int = 8192  # pc1 dynamic-neighborhood subset
    taus: Tuple[float, ...] = (2.0, 1.2, 0.8, 0.5, 0.4, 0.35, 0.3, 0.3)
    accel_iters: Tuple[int, ...] = (3, 6)
    min_inliers: float = 6.0  # per-slot matched-pair mass to accept an update
    cap: float = 1.0  # residual cap (m) for the score/null means
    accept: float = 0.35  # max capped mean matched residual (m) to trust
    null_margin: float = 1.15  # snap to zero when m0 <= md*margin + null_abs
    null_abs: float = 0.03
    snap_delta: float = 0.04  # |delta| below the eval's dynamic threshold
    dilate_cells: int = 24  # pc1 neighborhood reach around dynamic pillars
    dilate_pool: int = 4  # coarse stride for the dilation window


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-frame take along axis 1: x (B, N, ...), idx (B, K) -> (B, K, ...)."""
    batch = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[batch, idx]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis as ``sqrt(sum(x*x))``."""
    return torch.sqrt((x * x).sum(dim=-1))


def select_topk(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices (B, k) int64 of up to ``k`` True entries of each row of
    ``mask`` (stable order) plus a validity mask (False rows are padding)."""
    key = torch.logical_not(mask).to(torch.uint8)
    order = torch.sort(key, dim=-1, stable=True).indices
    idx = order[:, :k]
    return idx, torch.gather(mask, 1, idx)


def dilated_dynamic_mask(
    dyn_logit: torch.Tensor,  # (B, H, W) per-pillar dynamic logits
    pillar_ids: torch.Tensor,  # (B, M) flat pillar index per pc1 point
    in_range: torch.Tensor,  # (B, M) bool
    reach_cells: int,
    pool: int = 4,
) -> torch.Tensor:
    """Per-pc1-point mask: within ``reach_cells`` pillars of dynamic
    evidence, dilated on a ``pool``-strided coarse grid."""
    b, h, w = dyn_logit.shape
    occ = (dyn_logit > 0.0).to(torch.float32)
    coarse = occ.reshape(b, h // pool, pool, w // pool, pool).amax(dim=(2, 4))
    r = max(1, reach_cells // pool)
    win = 2 * r + 1
    coarse = F.max_pool2d(coarse[:, None], (win, 1), stride=1, padding=(r, 0))
    coarse = F.max_pool2d(coarse, (1, win), stride=1, padding=(0, r))[:, 0]
    cw = w // pool
    pid = pillar_ids.to(torch.int64)
    y = torch.clamp(pid // w, 0, h - 1) // pool
    x = torch.clamp(pid % w, 0, w - 1) // pool
    hit = torch.gather(coarse.reshape(b, -1), 1, y * cw + x) > 0.0
    return hit & in_range


def _slot_mean(
    onehot: torch.Tensor,  # (B, K, S) f32 membership
    values: torch.Tensor,  # (B, K, C)
    weights: torch.Tensor,  # (B, K)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-slot mean via one matmul: ((B, S, C) means, (B, S) mass)."""
    aug = torch.cat([values * weights[..., None], weights[..., None]], dim=-1)
    sums = torch.bmm(onehot.transpose(1, 2), aug)
    mass = sums[..., -1]
    return sums[..., :-1] / torch.clamp(mass, min=1e-6)[..., None], mass


def refine_slot_translations(
    q: torch.Tensor,  # (B, K0, 3) selected pc0 member points
    qslot: torch.Tensor,  # (B, K0) slot in [0, S) (invalid rows: anything)
    qvalid: torch.Tensor,  # (B, K0) bool
    seed: torch.Tensor,  # (B, S, 3) per-slot seed translations
    seed_ok: torch.Tensor,  # (B, S) bool — slots with real pooled seeds
    r: torch.Tensor,  # (B, K1, 3) selected pc1 reference points
    rvalid: torch.Tensor,  # (B, K1) bool
    max_slots: int,
    cfg: RefineConfig = RefineConfig(),
    qdt: torch.Tensor | None = None,  # (B, K0) pc0 per-point sweep times (s)
    rdt: torch.Tensor | None = None,  # (B, K1) pc1 per-point sweep times (s)
    period: float = 0.1,  # sweep period (s)
):
    """Refine per-slot translations by de-smeared trimmed NN ICP.

    Returns ``(delta (B, S, 3), conf (B, S), snapped (B, S))``: ``conf``
    marks geometrically verified slots, ``snapped`` the confident slots the
    null test proved static (``delta`` is exactly zero there)."""
    onehot = slot_onehot(qslot, qvalid, max_slots)
    qf = q.to(torch.float32)
    delta = seed.to(torch.float32)
    if qdt is None:
        qdt = torch.zeros(qf.shape[:2], dtype=torch.float32, device=qf.device)
    if rdt is None:
        rdt = torch.zeros(r.shape[:2], dtype=torch.float32, device=qf.device)
    qdt = qdt.to(torch.float32)
    rdt = rdt.to(torch.float32)
    qslot_safe = torch.clamp(qslot.to(torch.int64), 0, max_slots - 1)
    rf = r.to(torch.float32)
    qvalid_f = qvalid.to(torch.float32)

    # Claim pass: each reference point inherits the slot of its nearest
    # SEEDED member, so it can be de-smeared with that slot's velocity.
    seed_shift = _take(delta, qslot_safe)
    d2r, nnq = nn_argmin(rf, qf + seed_shift, query_valid=rvalid, ref_valid=qvalid)
    rslot = torch.gather(qslot_safe, 1, nnq)
    claim_tau = 2.0 * cfg.taus[0]
    rclaimed = rvalid & (d2r < claim_tau * claim_tau)
    rslot = torch.where(rclaimed, rslot, torch.zeros_like(rslot))
    rdesmear_w = rclaimed.to(torch.float32)[..., None] * (rdt[..., None] / period)

    def _coords(delta):
        qs = qf + _take(delta, qslot_safe) * (1.0 - qdt[..., None] / period)
        rs = rf - _take(delta, rslot) * rdesmear_w
        return qs, rs

    def _pass(delta):
        qs, rs = _coords(delta)
        d2, nn = nn_argmin(qs, rs, query_valid=qvalid, ref_valid=rvalid)
        resid = _take(rs, nn) - qs
        ddt = torch.gather(rdt, 1, nn) - qdt
        same = (torch.gather(rslot, 1, nn) == qslot_safe) & torch.gather(
            rclaimed, 1, nn
        )
        return d2, resid, ddt, same

    prev_u = None
    for it, tau in enumerate(cfg.taus):
        d2, resid, ddt, same = _pass(delta)
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
        w0 = (qvalid & same).to(torch.float32)
        m_s, _ = _slot_mean(onehot, torch.clamp(dist, max=cfg.cap)[..., None], w0)
        tau_s = torch.clamp(3.0 * m_s[..., 0], tau, cfg.taus[0])
        w = w0 * (dist < torch.gather(tau_s, 1, qslot_safe)).to(torch.float32)
        w = w * (dist + 0.05)
        z = 1.0 + ddt / period
        aug = torch.cat(
            [resid * z[..., None], (z * z)[..., None], torch.ones_like(z)[..., None]],
            dim=-1,
        ) * w[..., None]
        sums = torch.bmm(onehot.transpose(1, 2), aug)  # (B, S, 5)
        e = sums[..., 0:3] / torch.clamp(sums[..., 3], min=1e-6)[..., None]
        _, n_pairs = _slot_mean(onehot, resid, w0)
        ok = (n_pairs >= cfg.min_inliers) & seed_ok
        u = torch.where(ok[..., None], e, torch.zeros_like(e))
        delta = delta + u
        if prev_u is not None and it in cfg.accel_iters:
            # Scalar per-slot Aitken step toward the geometric fixed point.
            dot = (u * prev_u).sum(dim=-1)
            nrm = (prev_u * prev_u).sum(dim=-1)
            alpha = torch.clamp(dot / torch.clamp(nrm, min=1e-8), 0.0, 0.9)
            boost = torch.clamp(u * (alpha / (1.0 - alpha))[..., None], -1.0, 1.0)
            delta = delta + boost
            u = u + boost
        prev_u = u

    # Score pass: capped mean matched residual over ALL member points.
    qs_f, rs_f = _coords(delta)
    d2_f = nn_distance_sq(qs_f, rs_f, query_valid=qvalid, ref_valid=rvalid)
    rcap = torch.clamp(torch.sqrt(torch.clamp(d2_f, min=0.0)), max=cfg.cap)
    md, mass_f = _slot_mean(onehot, rcap[..., None], qvalid_f)
    md = md[..., 0]
    # Null pass: the same score at delta = 0, plus the fixed-point veto.
    d2_0, resid0, ddt0, same0 = _pass(torch.zeros_like(delta))
    r0 = torch.clamp(torch.sqrt(torch.clamp(d2_0, min=0.0)), max=cfg.cap)
    m0, _ = _slot_mean(onehot, r0[..., None], qvalid_f)
    m0 = m0[..., 0]
    dist0 = torch.sqrt(torch.clamp(d2_0, min=0.0))
    w0n = (qvalid & same0).to(torch.float32) * (dist0 < cfg.taus[0]).to(
        torch.float32
    )
    z0 = 1.0 + ddt0 / period
    aug0 = torch.cat([resid0 * z0[..., None], (z0 * z0)[..., None]], dim=-1) * w0n[
        ..., None
    ]
    sums0 = torch.bmm(onehot.transpose(1, 2), aug0)
    e0 = sums0[..., 0:3] / torch.clamp(sums0[..., 3], min=1e-6)[..., None]
    null_fixed = _norm(e0) <= torch.clamp(0.5 * _norm(delta), min=cfg.snap_delta)

    conf = seed_ok & (mass_f >= cfg.min_inliers) & (md < cfg.accept)
    small = _norm(delta) < cfg.snap_delta
    null_wins = (m0 <= md * cfg.null_margin + cfg.null_abs) & null_fixed
    snapped = conf & (small | null_wins)
    delta = torch.where(snapped[..., None], torch.zeros_like(delta), delta)
    return delta, conf, snapped


def refine_flow(
    flow: torch.Tensor,  # (B, N, 3) network output (post gate composition)
    p0: torch.Tensor,  # (B, N, 3) sweep-0 points
    slot: torch.Tensor,  # (B, N) int component slot, -1 = none
    valid0: torch.Tensor,  # (B, N) bool
    weight0: torch.Tensor,  # (B, N) seed-pooling weight
    p1: torch.Tensor,  # (B, M, 3) sweep-1 points
    valid1: torch.Tensor,  # (B, M) bool
    dyn_logit: torch.Tensor,  # (B, H, W) per-pillar dynamic logits
    pillar_ids1: torch.Tensor,  # (B, M) flat pillar id per pc1 point
    in_range1: torch.Tensor,  # (B, M) bool
    max_slots: int,
    cfg: RefineConfig = RefineConfig(),
    dt0: torch.Tensor | None = None,  # (B, N) pc0 per-point sweep times (s)
    dt1: torch.Tensor | None = None,  # (B, M) pc1 per-point sweep times (s)
) -> torch.Tensor:
    """Replace member-point flow with the geometrically verified per-slot
    translation wherever refinement is confident; keep ``flow`` elsewhere."""
    member = (slot >= 0) & valid0
    idx0, qvalid = select_topk(member, cfg.num_query)
    q = _take(p0, idx0)
    qslot = torch.clamp(torch.gather(slot, 1, idx0), 0, max_slots - 1)
    qflow = _take(flow, idx0)
    qw = torch.gather(weight0, 1, idx0)
    qdt = None if dt0 is None else torch.gather(dt0, 1, idx0)

    onehot = slot_onehot(qslot, qvalid, max_slots)
    seed, seed_mass = _slot_mean(onehot, qflow.to(torch.float32), qw)
    seed_ok = seed_mass >= cfg.min_inliers

    ref_mask = dilated_dynamic_mask(
        dyn_logit, pillar_ids1, in_range1, cfg.dilate_cells, cfg.dilate_pool
    ) & valid1
    idx1, rvalid = select_topk(ref_mask, cfg.num_ref)
    r = _take(p1, idx1)
    rdt = None if dt1 is None else torch.gather(dt1, 1, idx1)

    delta, conf, _ = refine_slot_translations(
        q, qslot, qvalid, seed, seed_ok, r, rvalid, max_slots, cfg,
        qdt=qdt, rdt=rdt,
    )
    safe = torch.clamp(slot.to(torch.int64), 0, max_slots - 1)
    use = member & torch.gather(conf, 1, safe)
    per_pt = _take(delta, safe)
    return torch.where(use[..., None], per_pt, flow)
