"""Neural Scene Flow Prior: per-frame runtime optimisation (port of
``himo_tpu/models/nsfp.py``).

A coordinate MLP is optimised per frame pair with Adam against the
bidirectional truncated chamfer between the warped pc0 and pc1 (or, with
``knn_k > 0``, the k-NN smoothed chamfer). Each step runs two NN searches
through ``csrc/nn.cu``'s argmin kernel and one ``segment_rows_sum``, plus two
``csrc/knn.cu`` launches with ``knn_k > 0``. Inputs are one frame pair,
(N, >=3) clouds with validity masks; invalid points neither contribute loss
nor receive flow.

The reference's default ``cluster_prior=True`` seeds the optimisation with
host-side cluster translation priors (:func:`cluster_prior_flow`: HDBSCAN
of both sweeps' dynamic points and ``icp_flow``'s matcher, numpy and scipy
on the host); the MLP then learns the residual on top. ``cluster_prior=
False`` is the classic cold start.

Spans (``utils.profiling.span``): ``himo.estimate`` around an estimator's
call, ``himo.mlp`` around the MLP's forward, ``himo.chamfer`` around the
loss's chamfer; ``models.opt_loop.run_adam`` adds ``himo.backward`` and
``himo.adam`` for each step.

On a CUDA device the fixed-length loop of the single-NN chamfer replays
its step as a CUDA graph (``run_adam(cuda_graph=True)``): a step is ~170
small launches in ~5 device ms, which a host CPU shared with other work
cannot always enqueue in time. The k-NN chamfer's loop stays eager.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from himo_tpu_torch.models.coordinate_mlp import apply_mlp, init_mlp
from himo_tpu_torch.models.opt_loop import anneal_caps, run_adam
from himo_tpu_torch.models.registry import register_estimator
from himo_tpu_torch.ops.knn import knn_smoothed_chamfer
from himo_tpu_torch.ops.nn import truncated_chamfer
from himo_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class NSFPConfig:
    hidden: int = 128
    layers: int = 8
    iterations: int = 500
    lr: float = 8e-3
    max_dist: float = 2.0  # chamfer truncation radius (m)
    patience: int = 0  # > 0: early-stop after this many non-improving steps
    min_delta: float = 1e-4  # relative improvement that resets patience
    schedule: str = "constant"  # or 'cosine'
    # Coarse-to-fine truncation: the radius starts at ``coarse_init`` and
    # anneals geometrically to ``max_dist`` over the first ``anneal_frac``
    # of the iterations; 0 disables.
    coarse_init: float = 0.0
    anneal_frac: float = 0.5
    # k-NN smoothed chamfer (ops/knn.py); 0 = the single-NN chamfer.
    knn_k: int = 0
    # Cluster translation prior (see :func:`cluster_prior_flow`): the
    # optimisation starts from per-cluster deltas, so fast objects start
    # inside the truncation radius. False = the classic cold start.
    cluster_prior: bool = True
    prior_threshold: float = 0.18
    prior_eps: float = 1.0  # looser than the label clustering's 0.6
    prior_min_samples: int = 5
    prior_match_gate: float = 6.0
    prior_min_norm: float = 1.0  # seed only where the chamfer cannot reach


def opt_schedule(config):
    """``run_adam``'s keyword arguments for an NSFP or FastNSF config."""
    coarse = config.coarse_init > config.max_dist
    return dict(
        iterations=config.iterations,
        lr=config.lr,
        schedule=config.schedule,
        patience=config.patience,
        min_delta=config.min_delta,
        step_caps=anneal_caps(config.iterations, config.max_dist,
                              config.coarse_init, config.anneal_frac)
        if coarse else None,
        track_from=int(config.anneal_frac * config.iterations) if coarse else 0,
    )


def nsfp_loss_fn(pc0, pc1, valid0, valid1, config: NSFPConfig, prior_flow=None):
    """``(loss_fn, total_flow)`` for one frame pair: ``loss_fn(params,
    cap=config.max_dist)`` is the 0-dim chamfer of ``pc0 + total_flow(params)``
    against ``pc1``; ``total_flow(params) = prior_flow + mlp(pc0)``."""
    p0 = pc0[:, :3].to(torch.float32)
    p1 = pc1[None, :, :3].to(torch.float32)
    base = torch.zeros_like(p0) if prior_flow is None else prior_flow
    v0, v1 = valid0[None], valid1[None]

    def total_flow(params):
        with span("himo.mlp"):
            return base + apply_mlp(params, p0)

    def loss_fn(params, cap=config.max_dist):
        warped = (p0 + total_flow(params))[None]
        with span("himo.chamfer"):
            if config.knn_k > 0:
                return knn_smoothed_chamfer(warped, p1, k=config.knn_k, valid1=v0,
                                            valid2=v1, max_dist=cap)[0]
            return truncated_chamfer(warped, p1, valid1=v0, valid2=v1, max_dist=cap)[0]

    return loss_fn, total_flow


def nsfp_flow(
    pc0: torch.Tensor,
    pc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    generator: torch.Generator,
    config: NSFPConfig = NSFPConfig(),
    prior_flow: torch.Tensor | None = None,
    params=None,
):
    """Optimise the flow of one (ego-compensated) frame pair on ``pc0``'s
    device. Returns ``(flow (N0, 3), loss)``: the last step's loss, or the
    best with early stopping. The MLP starts from ``init_mlp(generator)``,
    or from ``params`` (``(W, b)`` pairs) when given."""
    if params is None:
        params = init_mlp(generator, config.hidden, config.layers, device=pc0.device)
    loss_fn, total_flow = nsfp_loss_fn(pc0, pc1, valid0, valid1, config, prior_flow)
    params, loss, _ = run_adam(loss_fn, params, cuda_graph=config.knn_k == 0,
                               **opt_schedule(config))
    with torch.no_grad():
        flow = total_flow(params)
        flow = torch.where(valid0[:, None], flow, torch.zeros_like(flow))
    return flow, loss


def cluster_prior_flow(
    pc0,
    pc1,
    valid0,
    valid1,
    config=None,
    threshold: float = 0.18,
    eps: float = 1.0,
    min_samples: int = 5,
    match_gate: float = 6.0,
    min_norm: float = 1.0,
    dt0=None,
    dt1=None,
    tracker=None,
    pose1=None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Host-side translation-prior field for seeding the optimisation:
    HDBSCAN clusters the dynamic points of both (ego-compensated) sweeps
    and matched cluster deltas spread over each pc0 cluster
    (``training/ssl_labels.translation_priors``). ``config`` (an NSFP or
    FastNSF config) overrides the keyword defaults. Per-point sweep times
    (``dt0``/``dt1``) enable the de-smeared matcher, and a per-scene
    ``models/icp_flow.ClusterTracker`` (+``pose1``) adds velocity
    continuity. Inputs are tensors or numpy arrays; returns the (N0, 3)
    float32 prior on ``device`` (default: ``pc0``'s device, or the CPU)."""
    from himo_tpu_torch.models.icp_flow import to_numpy
    from himo_tpu_torch.training.ssl_labels import (
        cluster_dynamic_points,
        dynamic_mask_from_nn,
        translation_priors,
    )

    if config is not None:
        threshold = config.prior_threshold
        eps = config.prior_eps
        min_samples = config.prior_min_samples
        match_gate = config.prior_match_gate
        min_norm = config.prior_min_norm
    if device is None:
        device = pc0.device if isinstance(pc0, torch.Tensor) else "cpu"

    p0 = to_numpy(pc0)[:, :3].astype(np.float32)
    p1 = to_numpy(pc1)[:, :3].astype(np.float32)
    v0 = to_numpy(valid0).astype(bool)
    v1 = to_numpy(valid1).astype(bool)
    if not v0.any() or not v1.any():
        return torch.zeros(p0.shape, dtype=torch.float32, device=device)
    dt0 = None if dt0 is None else to_numpy(dt0)
    dt1 = None if dt1 is None else to_numpy(dt1)
    pose1 = None if pose1 is None else to_numpy(pose1)
    dyn0 = np.zeros(len(p0), bool)
    dyn0[v0] = dynamic_mask_from_nn(p0[v0], p1[v1], threshold)
    labels0 = cluster_dynamic_points(p0, dyn0, eps=eps, min_samples=min_samples)
    dyn1 = np.zeros(len(p1), bool)
    dyn1[v1] = dynamic_mask_from_nn(p1[v1], p0[v0], threshold)
    prior, _ = translation_priors(
        p0, labels0, p1, dyn1, eps=eps, min_samples=min_samples,
        match_gate=match_gate, min_norm=min_norm,
        dt0=dt0, dt1=dt1, tracker=tracker, pose1=pose1,
        # The valid masks exclude ground: the completion eligibility that
        # complete_cluster_bodies needs.
        eligible0=v0, eligible1=v1,
    )
    return torch.from_numpy(prior).to(device)


def opt_estimator(flow_fn, config, device):
    """Registry adapter of an optimisation estimator: runs ``flow_fn`` with
    ``config`` on ``device`` (default: the GPU; raises without CUDA). With
    ``config.cluster_prior`` each frame pair is seeded by
    :func:`cluster_prior_flow`, with one ``ClusterTracker`` per scene in
    ``estimate.trackers`` when the caller passes ``scene_id`` and
    ``pose1`` (frames in order)."""
    from himo_tpu_torch.models.feedforward import resolve_device
    from himo_tpu_torch.models.icp_flow import ClusterTracker

    dev = resolve_device(device)
    trackers = {}

    def estimate(pc0, pc1, valid0, valid1, generator, prior_flow=None, dt0=None,
                 dt1=None, scene_id=None, pose1=None):
        """Flow for one frame pair (clouds (N, >=3), masks (N,)), moved to
        the estimator's device; ``generator`` draws the MLP's weights (the
        reference's ``key``). ``prior_flow``, when given, replaces the
        cluster prior. Returns ``(flow, loss)``. The call is the span
        ``himo.estimate``."""
        with span("himo.estimate"):
            pc0, pc1, valid0, valid1 = (t.to(dev) for t in (pc0, pc1, valid0, valid1))
            if prior_flow is None and config.cluster_prior:
                tracker = None
                if scene_id is not None and pose1 is not None:
                    tracker = trackers.setdefault(scene_id, ClusterTracker())
                prior_flow = cluster_prior_flow(
                    pc0, pc1, valid0, valid1, config, dt0=dt0, dt1=dt1,
                    tracker=tracker, pose1=pose1, device=dev,
                )
            if prior_flow is not None:
                prior_flow = prior_flow.to(dev)
            return flow_fn(pc0, pc1, valid0, valid1, generator, config, prior_flow)

    estimate.config = config
    estimate.trackers = trackers
    return estimate


@register_estimator("nsfp")
def make_nsfp(device: torch.device | str | None = None, **overrides):
    """The ``nsfp`` estimator; ``overrides`` feed :class:`NSFPConfig`."""
    return opt_estimator(nsfp_flow, NSFPConfig(**overrides), device)
