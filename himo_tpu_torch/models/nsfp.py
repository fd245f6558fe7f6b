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
host-side cluster translation priors (DBSCAN and ``icp_flow``'s matcher),
which the port does not have yet: the registry's factory refuses that
setting. :func:`nsfp_flow` itself takes an external ``prior_flow``, as the
reference's does.
"""

from __future__ import annotations

import dataclasses

import torch

from himo_tpu_torch.models.coordinate_mlp import apply_mlp, init_mlp
from himo_tpu_torch.models.opt_loop import anneal_caps, run_adam
from himo_tpu_torch.models.registry import register_estimator
from himo_tpu_torch.ops.knn import knn_smoothed_chamfer
from himo_tpu_torch.ops.nn import truncated_chamfer


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
    # The host cluster prior (not ported; see the module docstring).
    cluster_prior: bool = True


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
        return base + apply_mlp(params, p0)

    def loss_fn(params, cap=config.max_dist):
        warped = (p0 + total_flow(params))[None]
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
    params, loss, _ = run_adam(loss_fn, params, **opt_schedule(config))
    with torch.no_grad():
        flow = total_flow(params)
        flow = torch.where(valid0[:, None], flow, torch.zeros_like(flow))
    return flow, loss


def opt_estimator(name: str, flow_fn, config, device):
    """Registry adapter of an optimisation estimator: runs ``flow_fn`` with
    ``config`` on ``device`` (default: the GPU; raises without CUDA).
    Raises for ``cluster_prior=True``: nothing runs without the prior that
    was asked for."""
    from himo_tpu_torch.models.feedforward import resolve_device

    if config.cluster_prior:
        raise NotImplementedError(
            f"{name}: cluster_prior=True needs the host cluster prior (DBSCAN "
            "clustering and icp_flow's matcher and tracker), which the port does "
            "not have yet (ROADMAP.md, Next slices: the cluster prior); pass "
            "cluster_prior=False for the classic cold start"
        )
    dev = resolve_device(device)

    def estimate(pc0, pc1, valid0, valid1, generator, prior_flow=None):
        """Flow for one frame pair (clouds (N, >=3), masks (N,)), moved to
        the estimator's device; ``generator`` draws the MLP's weights.
        Returns ``(flow, loss)``."""
        pc0, pc1, valid0, valid1 = (t.to(dev) for t in (pc0, pc1, valid0, valid1))
        if prior_flow is not None:
            prior_flow = prior_flow.to(dev)
        return flow_fn(pc0, pc1, valid0, valid1, generator, config, prior_flow)

    estimate.config = config
    return estimate


@register_estimator("nsfp")
def make_nsfp(device: torch.device | str | None = None, **overrides):
    """The ``nsfp`` estimator; ``overrides`` feed :class:`NSFPConfig`, and
    ``cluster_prior=False`` is required for now."""
    return opt_estimator("nsfp", nsfp_flow, NSFPConfig(**overrides), device)
