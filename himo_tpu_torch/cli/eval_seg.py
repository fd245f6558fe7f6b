"""Downstream segmentation-result evaluation CLI (port of
``himo_tpu/cli/eval_seg.py``).

Scores the ``seg_*`` keys in the .h5 scenes against the GT categories on
the 3-class {ignore, car, other_vehicle} remap; host only (numpy):

    python -m himo_tpu_torch.cli.eval_seg data_dir=... res_names='["seg_raw","seg_flow"]'
"""

from __future__ import annotations

from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.seg import evaluate_segmentation
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    res_names=("seg_raw", "seg_flow"),
    mask_only: bool = False,
):
    if isinstance(res_names, str):
        res_names = [res_names]
    dataset = SceneFlowDataset(
        data_dir, eval=True, extra_keys=list(res_names) + ["seg_valid"]
    )
    return evaluate_segmentation(dataset, list(res_names), mask_only=mask_only)


if __name__ == "__main__":
    run_cli(main)
