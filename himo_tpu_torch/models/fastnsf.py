"""Fast Neural Scene Flow: NSFP with a distance-transform loss (port of
``himo_tpu/models/fastnsf.py``).

The per-step NN search is replaced by one precomputed squared-distance
field of pc1 (:mod:`himo_tpu_torch.ops.dt`), sampled trilinearly at the
warped points; each step is a gather plus the coordinate MLP, and launches
none of the port's CUDA kernels. As for ``nsfp``, the reference's default
``cluster_prior=True`` seeds the optimisation with the host cluster prior
(``models/nsfp.cluster_prior_flow``).
"""

from __future__ import annotations

import dataclasses

import torch

from himo_tpu_torch.models.coordinate_mlp import apply_mlp, init_mlp
from himo_tpu_torch.models.nsfp import opt_estimator, opt_schedule
from himo_tpu_torch.models.opt_loop import run_adam
from himo_tpu_torch.models.registry import register_estimator
from himo_tpu_torch.ops.dt import DTConfig, DTGrid, distance_transform, sample_dt
from himo_tpu_torch.ops.nn import capped


@dataclasses.dataclass(frozen=True)
class FastNSFConfig:
    hidden: int = 128
    layers: int = 8
    iterations: int = 500
    lr: float = 8e-3
    max_dist: float = 2.0  # truncation radius (m)
    dt: DTConfig = DTConfig()
    patience: int = 0  # > 0: early-stop window (fixed length otherwise)
    min_delta: float = 1e-4
    schedule: str = "constant"  # or 'cosine'
    coarse_init: float = 0.0  # coarse-to-fine truncation (see NSFPConfig)
    anneal_frac: float = 0.5
    # Cluster translation prior seeding (see NSFPConfig.cluster_prior).
    cluster_prior: bool = True
    prior_threshold: float = 0.18
    prior_eps: float = 1.0
    prior_min_samples: int = 5
    prior_match_gate: float = 6.0
    prior_min_norm: float = 1.0


def fastnsf_loss_fn(pc0, valid0, grid: DTGrid, config: FastNSFConfig, prior_flow=None):
    """``(loss_fn, total_flow)`` for one frame pair: ``loss_fn(params,
    cap=config.max_dist)`` is the mean over valid points of the capped field
    at ``pc0 + total_flow(params)``."""
    p0 = pc0[:, :3].to(torch.float32)
    base = torch.zeros_like(p0) if prior_flow is None else prior_flow
    denom = torch.clamp(valid0.to(torch.float32).sum(), min=1.0)

    def total_flow(params):
        return base + apply_mlp(params, p0)

    def loss_fn(params, cap=config.max_dist):
        d2 = capped(sample_dt(grid, p0 + total_flow(params)), cap * cap)
        return torch.where(valid0, d2, torch.zeros_like(d2)).sum() / denom

    return loss_fn, total_flow


def fastnsf_flow(
    pc0: torch.Tensor,
    pc1: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    generator: torch.Generator,
    config: FastNSFConfig = FastNSFConfig(),
    prior_flow: torch.Tensor | None = None,
    params=None,
):
    """Optimise the flow of one (ego-compensated) frame pair through
    distance-field lookups, on ``pc0``'s device. Returns ``(flow (N0, 3),
    loss)``; the MLP starts from ``init_mlp(generator)`` or ``params``."""
    grid = distance_transform(pc1[:, :3], valid1, config.dt)
    if params is None:
        params = init_mlp(generator, config.hidden, config.layers, device=pc0.device)
    loss_fn, total_flow = fastnsf_loss_fn(pc0, valid0, grid, config, prior_flow)
    params, loss, _ = run_adam(loss_fn, params, **opt_schedule(config))
    with torch.no_grad():
        flow = total_flow(params)
        flow = torch.where(valid0[:, None], flow, torch.zeros_like(flow))
    return flow, loss


@register_estimator("fastnsf")
def make_fastnsf(device: torch.device | str | None = None, **overrides):
    """The ``fastnsf`` estimator; ``overrides`` feed :class:`FastNSFConfig`."""
    return opt_estimator(fastnsf_flow, FastNSFConfig(**overrides), device)


@register_estimator("fastnsf10")
def make_fastnsf10(device: torch.device | str | None = None, **overrides):
    """The reference's stored variant key: 150 iterations."""
    overrides.setdefault("iterations", 150)
    return make_fastnsf(device=device, **overrides)
