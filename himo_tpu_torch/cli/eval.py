"""Flow-mode compensation evaluation CLI (port of ``himo_tpu/cli/eval.py``).

Drop-in surface for the reference's ``eval.py::main`` (eval.py:270-312), in
flow mode:

    python -m himo_tpu_torch.cli.eval data_dir=/path/to/av2 res_name=seflowpp_best

Prints the fancy_grid metric table and appends ``res-{data_name}.json`` in
the working directory. Zip mode (``comp_dis_zip=``, a feather-in-zip
submission) is not ported: it raises ``NotImplementedError``.
"""

from __future__ import annotations

from himo_tpu_torch.core.dataset_id import check_valid
from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.instance_metrics import InstanceMetrics
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    res_name: str = "",
    comp_dis_zip: str = "",
    strict_parity: bool = False,  # reference 4-column distance-bucket norm
    scene_filter: str = "",  # scene-id substring, e.g. "scene_adv"
) -> InstanceMetrics:
    if comp_dis_zip:
        raise NotImplementedError(
            "comp_dis_zip: zip-mode evaluation needs the submission reader "
            "(io/submission.py, an Arrow IPC reader without pandas), which is "
            "not ported yet (ROADMAP Queue 1 item 7); evaluate a flow stored in "
            "the scenes with res_name= instead"
        )
    data_name, _ = check_valid(data_dir, res_name)
    metrics = InstanceMetrics(data_name=data_name, strict_parity=strict_parity)
    dataset = SceneFlowDataset(data_dir, vis_name=res_name, eval=True)

    for i in range(len(dataset)):
        data = dataset[i]
        if scene_filter and scene_filter not in str(data["scene_id"]):
            continue
        frame = prepare_frame(data, data_name, res_name=res_name)
        m = frame["mask_eval"]
        metrics.step(
            pc=frame["pc_full"][m] if strict_parity else frame["xyz"][m],
            gt_flow=frame["gt_flow"][m],
            dt0=frame["dt0"][m],
            category_indices=data["flow_category_indices"][m],
            instance_ids=data["flow_instance_id"][m],
            est_flow=frame["est_flow"][m],
        )

    suffix = f"-{scene_filter.strip('_')}" if scene_filter else ""
    metrics.print(res_name=res_name, file_name=f"res-{data_name}{suffix}.json")
    return metrics


if __name__ == "__main__":
    run_cli(main)
