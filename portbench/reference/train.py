"""Plain PyTorch reference of the SSL train step of the ``seflowpp`` net.

The forward of ``reference.seflowpp`` in its training form (soft gate, no
refine head), the seflowpp SSL loss with its chamfer terms on sampled rows
(truncated chamfers over all valid points and over the SSL-dynamic
subsets, static flow, cluster rigidity, translation prior, gate BCE) and
the dynamic image's class-balanced BCE, all averaged over the frames; then
the global-norm clip and Adam under the linear warm-up. The nearest
neighbours of the chamfer terms come from ``torch.cdist`` in blocks, with
the squared distance to the chosen neighbour worked out again; the
gradient flows through that distance. Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import seflowpp as net

MASK_BIG = 1.0e14  # additive penalty on masked rows


def _masked_mean(values, mask):
    total = torch.where(mask, values, torch.zeros_like(values)).sum(dim=-1)
    return total / torch.clamp(mask.to(values.dtype).sum(dim=-1), min=1.0)


def _nearest(q, r, pen_r):
    """Per query of (B, N, 3) the index of the nearest (B, M, 3) reference
    under the additive (B, M) penalties; the lowest index on ties."""
    b, m = q.shape[0], r.shape[1]
    block = max(1, net.NN_PAIRS // (b * m))
    idx = []
    for s in range(0, q.shape[1], block):
        d = torch.cdist(q[:, s:s + block], r, compute_mode="donot_use_mm_for_euclid_dist")
        idx.append((d * d + pen_r[:, None, :]).argmin(dim=-1))
    return torch.cat(idx, dim=1)


def _sq_to(q, r, idx):
    """Squared distance from each query to its chosen reference, in the
    search's fused form; differentiable in both clouds."""
    d = q - torch.gather(r, 1, idx[..., None].expand(-1, -1, 3))
    return (d[..., 2] * d[..., 2] + (d[..., 1] * d[..., 1] + d[..., 0] * d[..., 0]))


def chamfer_terms(warped, pc1, valid0, valid1, dynamic0, dynamic1, max_dist, dynamic_max_dist):
    """Per frame: the truncated chamfer over all valid points and over the
    SSL-dynamic subsets; masked rows lose every search by ``MASK_BIG``."""

    def pen(mask):
        return torch.where(mask, 0.0, MASK_BIG).to(torch.float32)

    q, r = warped[..., :3].float(), pc1[..., :3].float()
    out = []
    for pq, pr in ((pen(valid1), pen(valid0)), (pen(valid1 & dynamic1), pen(valid0 & dynamic0))):
        with torch.no_grad():
            iq, ir = _nearest(q, r, pq), _nearest(r, q, pr)
        dq = _sq_to(q, r, iq) + torch.gather(pq, 1, iq)
        dr = _sq_to(r, q, ir) + torch.gather(pr, 1, ir)
        out.append((torch.clamp(dq, min=0.0), torch.clamp(dr, min=0.0)))
    (dq_all, dr_all), (dq_dyn, dr_dyn) = out
    cap = max_dist * max_dist
    dyn_cap = (max_dist if dynamic_max_dist is None else dynamic_max_dist) ** 2

    def capped(d, c):
        return torch.minimum(d, torch.full_like(d, c))

    chamfer = _masked_mean(capped(dq_all, cap), valid0) + _masked_mean(capped(dr_all, cap), valid1)
    dyn = (_masked_mean(capped(dq_dyn, dyn_cap), valid0 & dynamic0)
           + _masked_mean(capped(dr_dyn, dyn_cap), valid1 & dynamic1))
    return chamfer, dyn


def cluster_rigidity(flow, cluster_ids, valid, num_clusters: int):
    """Within-cluster flow variance; ids at or past ``num_clusters`` add
    nothing to the sums and read the last cluster's mean without a
    gradient to it."""
    in_cluster = valid & (cluster_ids > 0)
    cid = torch.where(in_cluster, cluster_ids, torch.zeros_like(cluster_ids)).long()
    kept = in_cluster & (cid < num_clusters)
    slot = torch.where(kept, cid, torch.zeros_like(cid))
    b = flow.shape[0]
    counts = torch.zeros(b, num_clusters, device=flow.device).scatter_add(
        1, slot, kept.float())
    member = torch.where(kept[..., None], flow, torch.zeros_like(flow))
    sums = torch.zeros(b, num_clusters, 3, dtype=flow.dtype, device=flow.device).scatter_add(
        1, slot[..., None].expand(-1, -1, 3), member)
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    mean_at = torch.gather(means, 1, torch.clamp(cid, max=num_clusters - 1)[..., None]
                           .expand(-1, -1, 3))
    mean_at = torch.where((cid < num_clusters)[..., None], mean_at, mean_at.detach())
    dev = flow - mean_at
    return _masked_mean((dev * dev).sum(-1), in_cluster)


def dyn_image_loss(dyn_logit, pc0, valid0, obj_pos, cfg: net.NetConfig):
    """Class-balanced BCE of the dynamic image against the pillars that
    hold an object-positive point."""
    h, w = cfg.grid_shape
    pids, keep, _ = net.voxelize(pc0, valid0, cfg)
    with torch.no_grad():
        img = net.pillar_max(obj_pos.float()[..., None], pids, h * w)[..., 0]
    b = img.shape[0]
    y = (img > 0.5).reshape(b, -1)
    x = dyn_logit.reshape(b, -1)
    bce = F.softplus(-x) + torch.where(y, torch.zeros_like(x), x)
    return 0.5 * (_masked_mean(bce, y) + _masked_mean(bce, ~y))


def losses(model: net.SeFlowPP, batch: dict, train: dict, fp8_backbone: bool = False) -> dict:
    """Every loss term and the total, each the mean over the frames."""
    b = batch
    flow, gate_logit, dyn_logit = model(
        (b["pc0"], b["pc1"], b["pc_hist"]), (b["valid0"], b["valid1"], b["valid_hist"]),
        fp8_backbone=fp8_backbone, train=True)
    obj_pos = b["dynamic0"] | b["prior_valid0"]
    warped = b["pc0"][..., :3] + flow
    warped = torch.where(b["prior_valid0"][..., None], warped.detach(), warped)
    i0, i1 = b["loss_idx0"].long(), b["loss_idx1"].long()
    chamfer, dyn = chamfer_terms(
        torch.gather(warped, 1, i0[..., None].expand(-1, -1, 3)),
        torch.gather(b["pc1"][..., :3], 1, i1[..., None].expand(-1, -1, 3)),
        torch.gather(b["valid0"], 1, i0), torch.gather(b["valid1"], 1, i1),
        torch.gather(b["dynamic0"], 1, i0), torch.gather(b["dynamic1"], 1, i1),
        train["max_dist"], train["dynamic_max_dist"])
    valid0 = b["valid0"]
    dev = flow - b["prior0"]
    y = obj_pos.float()
    terms = {
        "chamfer_dis": chamfer,
        "static_flow_loss": _masked_mean((flow * flow).sum(-1), valid0 & ~obj_pos),
        "dynamic_chamfer_dis": dyn,
        "cluster_based_pc0pc1": cluster_rigidity(flow, b["cluster0"], valid0,
                                                 train["num_clusters"]),
        "prior_flow_loss": _masked_mean((dev * dev).sum(-1), b["prior_valid0"] & valid0),
        "gate_loss": _masked_mean(F.softplus(-gate_logit) + (1.0 - y) * gate_logit, valid0),
    }
    total = sum(terms.values())
    terms["total"] = total
    terms["dyn_img_loss"] = dyn_image_loss(dyn_logit, b["pc0"], valid0, b["dynamic0"] | b[
        "prior_valid0"], model.config)
    terms["total"] = terms["total"] + terms["dyn_img_loss"]
    return {k: v.mean() for k, v in terms.items()}


def learning_rate(train: dict, count: int) -> float:
    """The rate of update ``count`` (0 first): a linear warm-up from 0 over
    ``warmup_steps``, then ``lr`` (the window ends long before the first
    step down)."""
    warm = train["warmup_steps"]
    return train["lr"] * count / warm if count < warm else train["lr"]


class Step:
    """The reference's train step on its own copy of the weights."""

    def __init__(self, model: net.SeFlowPP, train: dict, fp8_backbone: bool = False):
        self.model, self.train, self.fp8 = model, train, fp8_backbone
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def __call__(self, batch: dict) -> dict:
        self.adam.zero_grad(set_to_none=True)
        terms = losses(self.model, batch, self.train, self.fp8)
        terms["total"].backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        clip = torch.tensor(self.train["grad_clip"], device=norm.device)
        for g in grads:
            g.copy_(torch.where(norm < clip, g, g / norm * clip))
        for group in self.adam.param_groups:
            group["lr"] = learning_rate(self.train, self.count)
        self.adam.step()
        self.count += 1
        return {k: v.detach() for k, v in terms.items()}
