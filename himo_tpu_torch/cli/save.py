"""Flow inference CLI — write method flow into the .h5 scenes (port of
``himo_tpu/cli/save.py``).

Drop-in surface for the reference's OpenSceneFlow ``save.py`` (README.md:46-53):

    # optimization-based (no checkpoint needed)
    python -m himo_tpu_torch.cli.save model=fastnsf dataset_path=/path/to/av2

    # feed-forward from a trained checkpoint (a trainer checkpoint
    # directory such as {run_dir}/ckpts, or a state-dict file)
    python -m himo_tpu_torch.cli.save checkpoint=runs/seflowpp/ckpts \\
        dataset_path=... model=seflowpp

    # batched fleet inference (feed-forward models, one GPU)
    python -m himo_tpu_torch.cli.save fleet=true checkpoint=... dataset_path=... \\
        model=seflowpp batch_per_device=8

    # the fleet over N GPUs, whole scenes to each rank (NCCL)
    python -m torch.distributed.run --nproc-per-node=N -m himo_tpu_torch.cli.save \\
        fleet=true checkpoint=... dataset_path=... model=seflowpp batch_per_device=8

Runs on the GPU; ``device=cpu`` runs on the CPU instead (without CUDA and
without ``device=cpu`` it raises). Hydra-style ``key=value`` overrides are
accepted; extra keys are forwarded to the estimator config (e.g.
``iterations=200``), or to the network with ``fleet=true`` (e.g.
``dtype=bfloat16``).
"""

from __future__ import annotations

import os

from himo_tpu_torch.models.runner import estimate_scene_flow
from himo_tpu_torch.parallel import multihost
from himo_tpu_torch.utils.cli import run_cli


def main(
    dataset_path: str = "",
    model: str = "fastnsf",
    checkpoint: str = "",
    output_key: str = "",
    seed: int = 0,
    fleet: bool = False,
    batch_per_device: int = 1,
    num_points: int = 65536,
    static_gate: float = 0.0,  # zero sub-threshold residual flow (m/frame)
    device=None,
    **overrides,
):
    if multihost.under_torchrun():
        if not fleet and int(os.environ["WORLD_SIZE"]) > 1:
            raise ValueError("several ranks split the fleet only (fleet=true); the "
                             "per-frame runner runs in one process")
        multihost.initialize(device=device)
    if fleet:
        # Batched inference (feed-forward models): frames stack into
        # batches on one GPU, flow lands back in the .h5 scenes.
        from himo_tpu_torch.parallel.fleet import FleetConfig, fleet_save

        return fleet_save(
            dataset_path,
            model=model,
            checkpoint=checkpoint or None,
            output_key=output_key or None,
            config=FleetConfig(
                num_points=num_points,
                batch_per_device=batch_per_device,
                static_gate=static_gate,
            ),
            model_overrides=overrides or None,
            device=device,
        )
    return estimate_scene_flow(
        dataset_path,
        model=model,
        output_key=output_key or None,
        checkpoint=checkpoint or None,
        seed=seed,
        device=device,
        **overrides,
    )


if __name__ == "__main__":
    run_cli(main)
