"""Segmentation inference over .h5 scenes, the WaffleIron ``eval_h5``
surface (port of ``himo_tpu/cli/seg_h5.py``).

    python -m himo_tpu_torch.cli.seg_h5 path_dataset=... ckpt=... flow_mode=raw
    python -m himo_tpu_torch.cli.seg_h5 path_dataset=... train=True ckpt=...  # fit a ckpt first

Writes ``seg_{flow_mode}`` and ``seg_valid`` into each frame group; score
with ``python -m himo_tpu_torch.cli.eval_seg``. Checkpoints are the port's
torch format (``training/checkpoints.py``: ``{"params": state_dict}``).
Runs on the GPU; ``device=cpu`` runs on the CPU instead.
"""

from __future__ import annotations

from himo_tpu_torch.utils.cli import run_cli


def main(
    path_dataset: str = "",
    ckpt: str = "",
    flow_mode: str = "raw",
    train: bool = False,
    deskew_gt: bool = True,  # train on GT-undistorted clouds (WaffleIron role)
    num_points: int = 32768,
    epochs: int = 5,
    device=None,
    **model_overrides,
):
    import torch

    from himo_tpu_torch.downstream.segmentation import (
        init_seg_params,
        make_seg_model,
        segment_dataset,
        train_segmentation,
    )
    from himo_tpu_torch.training.checkpoints import load_checkpoint, save_checkpoint

    model, _ = make_seg_model(device=device, **model_overrides)
    if train:
        params = train_segmentation(
            path_dataset,
            model=model,
            num_points=num_points,
            epochs=epochs,
            deskew_gt=deskew_gt,
        )
        if ckpt:
            save_checkpoint(ckpt, {"params": params})
            print(f"Saved segmentation checkpoint to {ckpt}")
    elif ckpt:
        params = load_checkpoint(ckpt)["params"]
    else:
        print("No ckpt given: using randomly initialized weights (smoke mode).")
        params = init_seg_params(model, torch.Generator().manual_seed(0))

    n = segment_dataset(
        path_dataset, model, params, flow_mode=flow_mode, num_points=num_points
    )
    print(f"Wrote seg_{flow_mode} for {n} frames.")
    return n


if __name__ == "__main__":
    run_cli(main)
