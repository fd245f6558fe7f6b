"""SSL training CLI (port of ``himo_tpu/cli/train.py``).

    python -m himo_tpu_torch.cli.train dataset_path=/path/to/av2 model=seflowpp \\
        batch_size=8 epochs=12 lr=6e-5 wandb_mode=disabled

Runs on the GPU; ``device=cpu`` runs on the CPU instead (without CUDA and
without ``device=cpu`` it raises). Other ``TrainConfig`` fields
(``val_every=1``, ``loss_points=0``, ``weights.chamfer_dis=2``) and model
overrides (``pooling=mean_sorted``, ``pillar.voxel_size=(0.4,0.4)``) pass
as further ``key=value`` pairs. The ``ssl_*`` pseudo-labels are read when
the scene files hold them (``python -m himo_tpu_torch.cli.ssl_label``
writes them).
"""

from __future__ import annotations

from himo_tpu_torch.training.trainer import TrainConfig, train
from himo_tpu_torch.utils.cli import run_cli
from himo_tpu_torch.utils.config import apply_overrides, split_known_overrides


def main(
    dataset_path: str = "",
    model: str = "seflowpp",
    batch_size: int = 8,
    epochs: int = 12,
    lr: float = 6e-5,
    num_points: int = 65536,
    run_dir: str = "runs/seflowpp",
    wandb_mode: str = "disabled",
    seed: int = 0,
    dtype: str = "bfloat16",  # backbone dtype; flow head & losses stay fp32
    device=None,
    **overrides,
):
    config = TrainConfig(
        model=model,
        batch_size=batch_size,
        epochs=epochs,
        lr=lr,
        num_points=num_points,
        seed=seed,
    )
    known, model_overrides = split_known_overrides(TrainConfig, overrides)
    config = apply_overrides(config, known)
    model_overrides.setdefault("dtype", dtype)
    result = train(
        dataset_path,
        config,
        run_dir=run_dir,
        wandb_mode=wandb_mode,
        model_overrides=model_overrides or None,
        device=device,
    )
    print(f"Trained {result['steps']} steps in {result['seconds']:.1f}s")
    return result


if __name__ == "__main__":
    run_cli(main)
