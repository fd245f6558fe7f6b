"""Driver entry points of the port (counterpart of the root
``__graft_entry__.py``):

- :func:`entry` returns the flagship SeFlow++ forward plus the de-skew as a
  function of the parameters and one frame, with example arguments;
- :func:`dryrun_multichip` runs ONE sharded SSL train step in ``n`` ranks,
  the batch split over the data axis, the parameters replicated, the
  gradients all-reduced (NCCL on GPUs, gloo on the CPU).

    python -m himo_tpu_torch.entry       # on the GPU: both, over every GPU

The JAX dry run also steps through the TPU kernels' interpreted, VMEM-
banded variant; the port has no banding, so it runs one step.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

FLAGSHIP_POINTS = 32768
DRYRUN_POINTS = 1024
DRYRUN_TIMEOUT_S = 600.0


def _flagship(device, grid_extent: float = 51.2, voxel: float = 0.2):
    """SeFlow++-class model at the reference-parity grid (512x512 @ 0.2 m,
    assets/slurm/ssl-train-av2.sh:32), parameters from seed 0."""
    from himo_tpu_torch.models.feedforward import init_params, make_model

    model, config = make_model(
        "seflowpp", device=device,
        **{"pillar.x_range": (-grid_extent, grid_extent),
           "pillar.y_range": (-grid_extent, grid_extent),
           "pillar.voxel_size": (voxel, voxel)})
    params = init_params(model, torch.Generator().manual_seed(0))
    return model, config, params


def entry(device: torch.device | str | None = None):
    """``(fn, example_args)``: the flagship forward + de-skew of one frame
    of 32,768 points on ``device`` (default: the GPU; raises without CUDA).
    ``fn(params, pc0, pc1, pc_hist, valid0, valid1, valid_hist, dt0)``
    takes the network's state dict and (1, N, ...) tensors and returns
    ``(refined, flow)``."""
    model, _, params = _flagship(device)
    device = next(model.parameters()).device

    def forward(params, pc0, pc1, pc_hist, valid0, valid1, valid_hist, dt0):
        flow = torch.func.functional_call(
            model, params, ((pc0, pc1, pc_hist), (valid0, valid1, valid_hist)))
        # Fused de-skew: residual flow -> compensation displacement.
        comp_dis = flow * (dt0 / 0.1)[..., None]
        return pc0 + comp_dis, flow

    rng = np.random.default_rng(0)

    def pc():
        return torch.from_numpy(rng.uniform(-40, 40, size=(1, FLAGSHIP_POINTS, 3))
                                .astype(np.float32)).to(device)

    valid = torch.ones((1, FLAGSHIP_POINTS), dtype=torch.bool, device=device)
    dt0 = torch.from_numpy(rng.uniform(0, 0.1, size=(1, FLAGSHIP_POINTS))
                           .astype(np.float32)).to(device)
    return forward, (params, pc(), pc(), pc(), valid, valid, valid, dt0)


def _dryrun_batch(batch: int, num_points: int) -> dict:
    """The JAX dry run's batch: uniform clouds in +-10 m, every point
    valid, 20 % SSL-dynamic points, 16 clusters, priors on 10 %."""
    rng = np.random.default_rng(0)

    def cloud():
        return rng.uniform(-10.0, 10.0, size=(batch, num_points, 3)).astype(np.float32)

    return {
        "pc0": cloud(), "pc1": cloud(), "pc_hist": cloud(),
        "valid0": np.ones((batch, num_points), bool),
        "valid1": np.ones((batch, num_points), bool),
        "valid_hist": np.ones((batch, num_points), bool),
        "dynamic0": rng.random((batch, num_points)) < 0.2,
        "dynamic1": rng.random((batch, num_points)) < 0.2,
        "cluster0": rng.integers(0, 16, size=(batch, num_points), dtype=np.int32),
        "prior0": rng.normal(size=(batch, num_points, 3)).astype(np.float32),
        "prior_valid0": rng.random((batch, num_points)) < 0.1,
    }


def _dryrun_rank(rank: int, address: str, n_devices: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`: join, build the toy model from
    seed 0 (broadcast from rank 0), take this rank's frame and step."""
    import os

    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.parallel import multihost
    from himo_tpu_torch.parallel.mesh import replicated, shard_batch
    from himo_tpu_torch.training.trainer import TrainConfig, make_optimizer, make_train_step

    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    multihost.initialize(address, n_devices, rank, device=device)
    mesh = multihost.global_mesh(device=device)
    model, model_config = make_model(
        "seflowpp", device=mesh.device, depths=(16, 32), point_feat_dim=8, base_channels=8,
        **{"pillar.x_range": (-12.8, 12.8), "pillar.y_range": (-12.8, 12.8),
           "pillar.voxel_size": (0.8, 0.8)})
    config = TrainConfig(batch_size=n_devices, num_points=DRYRUN_POINTS, num_clusters=16)
    init_params(model, torch.Generator().manual_seed(0))
    replicated(mesh, model)
    optimizer, _ = make_optimizer(model.parameters(), config, steps_per_epoch=10)
    train_step = make_train_step(model, config, optimizer, mesh)
    metrics = train_step(shard_batch(mesh, _dryrun_batch(config.batch_size, config.num_points)))
    total = float(metrics["total"])
    if not np.isfinite(total):
        raise AssertionError(f"rank {rank}: non-finite loss {total}")
    return {"rank": rank, "total": total, "mesh": mesh.shape, "device": str(mesh.device),
            "backend": torch.distributed.get_backend(),
            "grid": model_config.pillar.grid_shape}


def dryrun_multichip(n_devices: int, device: torch.device | str | None = None) -> list:
    """One sharded SSL train step at toy shapes (1,024 points, 0.8 m cells
    over +-12.8 m, depths (16, 32), 8 point features, 8 base channels, one
    frame a rank) in ``n_devices`` spawned ranks: NCCL, one GPU a rank,
    unless ``device="cpu"`` (gloo). Raises when the GPUs are fewer than
    the ranks (NCCL takes one GPU a rank), when a rank fails, or when the
    ranks take longer than ``DRYRUN_TIMEOUT_S``. Prints one line a rank
    and returns what each rank reports (its loss is the global batch's).
    A script that calls this needs the ``if __name__ == "__main__":``
    guard: spawn imports the main module again."""
    from himo_tpu_torch.models.feedforward import resolve_device
    from himo_tpu_torch.parallel.multihost import run_ranks

    kind = resolve_device(device).type
    if kind == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} GPUs (NCCL takes one a rank); "
                         f"this host has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="himo_dryrun_") as tmp:
        address = (Path(tmp) / "rendezvous").as_uri()
        results = run_ranks(_dryrun_rank, n_devices, (address, n_devices, kind),
                            timeout=DRYRUN_TIMEOUT_S)
    for r in results:
        h, w = r["grid"]
        print(f"dryrun_multichip({n_devices}) rank {r['rank']} [{r['backend']}, "
              f"{r['device']}]: mesh={r['mesh']} grid={h}x{w} points={DRYRUN_POINTS} "
              f"loss={r['total']:.4f} OK")
    return results


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry OK:", [tuple(x.shape) for x in out])
    dryrun_multichip(min(8, torch.cuda.device_count()))
