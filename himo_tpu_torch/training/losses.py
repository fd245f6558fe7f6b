"""Self-supervised scene-flow losses, the seflowppLoss recipe (port of
``himo_tpu/training/losses.py``).

The JAX functions take one frame and are ``vmap``-ed over the batch; these
take batched (B, ...) inputs and return per-frame (B,) terms, so the
trainer's mean over frames of per-frame masked means is ``terms.mean(0)``.

The four seflowpp terms plus the himo_tpu extensions:

- ``chamfer_dis`` / ``dynamic_chamfer_dis``: truncated chamfer over all
  valid points and over the SSL-dynamic subsets, from one fused NN pass
  (``ops/nn.fused_chamfer_terms``);
- ``static_flow_loss``: residual flow on SSL-static points is driven to 0;
- ``cluster_based_pc0pc1``: within-cluster flow variance;
- ``prior_flow_loss``: deviation from the cluster translation prior;
- ``gate_loss``: BCE of the gate head against the object-positive mask;
- ``dyn_img_loss`` (:func:`dyn_image_loss`): class-balanced BCE of the
  instance head's per-pillar dynamic logits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from himo_tpu_torch.ops.nn import _masked_mean, fused_chamfer_terms, take_rows
from himo_tpu_torch.ops.voxelize import PillarConfig, scatter_max, voxelize_pillars


@dataclasses.dataclass(frozen=True)
class SSLLossWeights:
    """Same fields and defaults as the JAX ``SSLLossWeights``."""

    chamfer_dis: float = 1.0
    static_flow_loss: float = 1.0
    dynamic_chamfer_dis: float = 1.0
    cluster_based_pc0pc1: float = 1.0
    prior_flow_loss: float = 1.0
    gate_loss: float = 1.0
    dyn_img_loss: float = 1.0


def static_flow_loss(flow: torch.Tensor, static_mask: torch.Tensor) -> torch.Tensor:
    """Mean squared residual flow on SSL-static points -> (B,)."""
    return _masked_mean((flow * flow).sum(dim=-1), static_mask)


def cluster_rigidity_loss(
    flow: torch.Tensor,  # (B, N, 3)
    cluster_ids: torch.Tensor,  # (B, N) int, 0 = no cluster
    valid: torch.Tensor,
    num_clusters: int,
) -> torch.Tensor:
    """Within-cluster flow variance -> (B,). As in the reference, ids >=
    ``num_clusters`` add nothing to the cluster sums (``segment_sum`` drops
    them) and read the last cluster's mean (``means[cid]`` clamps), but send
    that mean no gradient (the clamped gather's transpose drops them)."""
    in_cluster = valid & (cluster_ids > 0)
    cid = torch.where(in_cluster, cluster_ids, torch.zeros_like(cluster_ids)).to(torch.int64)
    kept = in_cluster & (cid < num_clusters)
    slot = torch.where(kept, cid, torch.zeros_like(cid))
    b = flow.shape[0]
    counts = torch.zeros(b, num_clusters, dtype=torch.float32, device=flow.device)
    counts = counts.scatter_add(1, slot, kept.to(torch.float32))
    member = torch.where(kept[..., None], flow, torch.zeros_like(flow))
    sums = torch.zeros(b, num_clusters, 3, dtype=flow.dtype, device=flow.device)
    sums = sums.scatter_add(1, slot[..., None].expand(-1, -1, 3), member)
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    at = torch.clamp(cid, max=num_clusters - 1)[..., None].expand(-1, -1, 3)
    mean_at = torch.gather(means, 1, at)
    mean_at = torch.where((cid < num_clusters)[..., None], mean_at, mean_at.detach())
    dev = flow - mean_at
    return _masked_mean((dev * dev).sum(dim=-1), in_cluster)


def prior_flow_loss(
    flow: torch.Tensor, prior_flow: torch.Tensor, prior_valid: torch.Tensor
) -> torch.Tensor:
    """Mean squared deviation from the cluster translation prior -> (B,)."""
    dev = flow - prior_flow
    return _masked_mean((dev * dev).sum(dim=-1), prior_valid)


def gate_bce_loss(
    gate_logit: torch.Tensor, dynamic: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Per-point BCE between the gate logits and the SSL dynamic evidence,
    in the logit form ``softplus(-x) + (1 - y) x`` -> (B,)."""
    y = dynamic.to(torch.float32)
    bce = F.softplus(-gate_logit) + (1.0 - y) * gate_logit
    return _masked_mean(bce, valid)


def dyn_image_loss(
    dyn_logit: torch.Tensor,  # (B, H, W) instance-head dynamic logits
    pc0: torch.Tensor,  # (B, N, 3)
    valid0: torch.Tensor,
    obj_pos: torch.Tensor,  # (B, N) bool object-positive SSL evidence
    pillar: PillarConfig,
) -> torch.Tensor:
    """Class-balanced per-pillar BCE for the instance head's dynamic image
    -> (B,). A pillar is positive iff one of its points is object-positive
    (a per-pillar max, through the scatter-max kernel); the positive and
    negative means are balanced."""
    grid = voxelize_pillars(pc0, valid0, pillar)
    img = scatter_max(obj_pos.to(torch.float32)[..., None], grid)[..., 0]
    b = img.shape[0]
    y = (img > 0.5).reshape(b, -1)
    x = dyn_logit.reshape(b, -1)
    bce = F.softplus(-x) + torch.where(y, torch.zeros_like(x), x)
    return 0.5 * (_masked_mean(bce, y) + _masked_mean(bce, ~y))


def _assemble(weights: SSLLossWeights, terms: Dict[str, torch.Tensor]):
    total = sum(getattr(weights, k) * v for k, v in terms.items())
    return {"total": total, **terms}


def _terms(
    flow, chamfer, dyn_chamfer, valid0, dynamic0, cluster0, num_clusters,
    weights, prior0, prior_valid0, gate_logit0,
):
    # Object-positive evidence for the static and gate terms: the SSL
    # dynamic mask completed by the translation priors' coverage (see the
    # reference's seflowpp_loss).
    obj_pos = dynamic0
    if prior_valid0 is not None:
        obj_pos = obj_pos | prior_valid0
    terms = {
        "chamfer_dis": chamfer,
        "static_flow_loss": static_flow_loss(flow, valid0 & ~obj_pos),
        "dynamic_chamfer_dis": dyn_chamfer,
        "cluster_based_pc0pc1": cluster_rigidity_loss(
            flow, cluster0, valid0, num_clusters
        ),
    }
    if prior0 is not None:
        terms["prior_flow_loss"] = prior_flow_loss(flow, prior0, prior_valid0 & valid0)
    if gate_logit0 is not None:
        terms["gate_loss"] = gate_bce_loss(gate_logit0, obj_pos, valid0)
    return _assemble(weights, terms)


def _chamfer_input(pc0, flow, prior_valid0):
    """Warped pc0 for the chamfer terms. Prior-covered points keep their
    chamfer value but send it no gradient: there the prior term is the only
    flow gradient (the reference's 'strong labels beat weak ones')."""
    warped = pc0[..., :3] + flow
    if prior_valid0 is None:
        return warped
    return torch.where(prior_valid0[..., None], warped.detach(), warped)


def seflowpp_loss(
    flow: torch.Tensor,  # (B, N, 3) predicted residual flow for pc0
    pc0: torch.Tensor,  # (B, N, 3) ego-compensated sweep 0
    pc1: torch.Tensor,  # (B, M, 3)
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    dynamic0: torch.Tensor,
    dynamic1: torch.Tensor,
    cluster0: torch.Tensor,  # (B, N) int, 0 = background / none
    num_clusters: int = 64,
    weights: SSLLossWeights = SSLLossWeights(),
    max_dist: float = 2.0,
    dynamic_max_dist: float | None = None,
    prior0: torch.Tensor | None = None,
    prior_valid0: torch.Tensor | None = None,
    gate_logit0: torch.Tensor | None = None,
) -> Dict[str, torch.Tensor]:
    """All SSL terms and their weighted total, each (B,)."""
    chamfer, dyn = fused_chamfer_terms(
        _chamfer_input(pc0, flow, prior_valid0), pc1, valid0, valid1, dynamic0,
        dynamic1, max_dist=max_dist, dynamic_max_dist=dynamic_max_dist,
    )
    return _terms(flow, chamfer, dyn, valid0, dynamic0, cluster0, num_clusters,
                  weights, prior0, prior_valid0, gate_logit0)


def seflowpp_loss_sampled(
    flow: torch.Tensor,
    pc0: torch.Tensor,
    pc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    dynamic0: torch.Tensor,
    dynamic1: torch.Tensor,
    cluster0: torch.Tensor,
    loss_idx0: torch.Tensor,  # (B, K) int rows of pc0 for the chamfer terms
    loss_idx1: torch.Tensor,  # (B, K) int rows of pc1
    num_clusters: int = 64,
    weights: SSLLossWeights = SSLLossWeights(),
    max_dist: float = 2.0,
    dynamic_max_dist: float | None = None,
    prior0: torch.Tensor | None = None,
    prior_valid0: torch.Tensor | None = None,
    gate_logit0: torch.Tensor | None = None,
) -> Dict[str, torch.Tensor]:
    """:func:`seflowpp_loss` with the chamfer terms on K-point samples of
    both clouds; the elementwise and cluster terms stay over the full
    cloud. The sample of the warped cloud is :func:`take_rows`, whose
    backward is the scatter-add kernel."""
    warped = _chamfer_input(pc0, flow, prior_valid0)
    i0 = loss_idx0.to(torch.int64)
    i1 = loss_idx1.to(torch.int64)

    def at(x, i):
        return torch.gather(x, 1, i)

    chamfer, dyn = fused_chamfer_terms(
        take_rows(warped, loss_idx0),
        torch.gather(pc1[..., :3], 1, i1[..., None].expand(-1, -1, 3)),
        at(valid0, i0), at(valid1, i1), at(dynamic0, i0), at(dynamic1, i1),
        max_dist=max_dist, dynamic_max_dist=dynamic_max_dist,
    )
    return _terms(flow, chamfer, dyn, valid0, dynamic0, cluster0, num_clusters,
                  weights, prior0, prior_valid0, gate_logit0)
