"""Export estimated compensation distances as a leaderboard submission zip
(port of ``himo_tpu/cli/save_zip.py``).

Drop-in surface for the reference's ``save_zip.py::main`` (save_zip.py:102-125):

    python -m himo_tpu_torch.cli.save_zip data_dir=/path/to/av2 res_name=seflowpp_best

Writes ``{data_dir}/results/{res_name}-submit.zip`` with per-frame feather
files at ``{scene_id}/{timestamp}.feather``.
"""

from __future__ import annotations

from pathlib import Path

from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.io.submission import write_comp_dis_feather, zip_results
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    res_name: str = "seflowpp_best",
    sensor_dt: float = 0.1,
) -> str:
    data_dir = Path(data_dir)
    output_dir = data_dir / "results"
    output_dir.mkdir(exist_ok=True, parents=True)

    dataset = SceneFlowDataset(data_dir, vis_name=res_name, eval=True)
    for i in range(len(dataset)):
        data = dataset[i]
        # Dataset name only matters for the eval mask, which submissions omit;
        # the pose-flow / dt0 math is dataset-independent (save_zip.py:113-121).
        frame = prepare_frame(data, data_name="av2", res_name=res_name)
        comp_dis = frame["est_flow"] / sensor_dt * frame["dt0"][:, None]
        write_comp_dis_feather(
            comp_dis, (data["scene_id"], str(data["timestamp"])), output_dir
        )

    return zip_results(output_dir, output_file=str(output_dir / f"{res_name}-submit.zip"))


if __name__ == "__main__":
    run_cli(main)
