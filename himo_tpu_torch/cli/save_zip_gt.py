"""Export the GROUND-TRUTH compensation archive used to validate the scorer
(port of ``himo_tpu/cli/save_zip_gt.py``).

Drop-in surface for the reference's ``tools/test/save_zip_gt.py::main``
(:129-180): writes GT comp_dis plus eval_mask, labels, gt_flow_norm and pc0
columns so the standalone scorer can bucket and Chamfer without the .h5 data.
Scoring this archive against itself must give ~0 (SURVEY.md §4).

    python -m himo_tpu_torch.cli.save_zip_gt data_dir=/path/to/av2 output_dir=/tmp/gt_av2
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from himo_tpu_torch.core.dataset_id import check_valid
from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.io.submission import write_comp_dis_feather, zip_results
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    output_dir: str = "",
    res_name: str = "flow",
    sensor_dt: float = 0.1,
) -> str:
    data_dir = Path(data_dir)
    output_dir = Path(output_dir) if output_dir else data_dir / "results"
    output_dir.mkdir(exist_ok=True, parents=True)
    data_name, _ = check_valid(str(data_dir), res_name, None)

    dataset = SceneFlowDataset(data_dir, vis_name=res_name, eval=True)
    for i in range(len(dataset)):
        data = dataset[i]
        frame = prepare_frame(data, data_name, res_name=None)
        gt_comp_dis = frame["gt_flow"] / sensor_dt * frame["dt0"][:, None]
        gt_flow_norm = np.linalg.norm(frame["gt_flow"], axis=1).astype(np.float32)
        write_comp_dis_feather(
            gt_comp_dis,
            (data["scene_id"], str(data["timestamp"])),
            output_dir,
            eval_mask=frame["mask_eval"],
            flow_category_indices=data.get("flow_category_indices"),
            flow_instance_id=data.get("flow_instance_id"),
            gt_flow_norm=gt_flow_norm,
            pc0=frame["xyz"],
        )

    return zip_results(
        str(output_dir), output_file=str(output_dir / f"{res_name}-submit.zip")
    )


if __name__ == "__main__":
    run_cli(main)
