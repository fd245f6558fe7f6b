"""Flow-mode / zip-mode compensation evaluation CLI (port of
``himo_tpu/cli/eval.py``).

Drop-in surface for the reference's ``eval.py::main`` (eval.py:270-312):

    python -m himo_tpu_torch.cli.eval data_dir=/path/to/av2 res_name=seflowpp_best
    python -m himo_tpu_torch.cli.eval data_dir=... comp_dis_zip=pred-submit.zip

Prints the fancy_grid metric table and appends ``res-{data_name}.json`` in
the working directory. A ``comp_dis_zip`` that does not exist evaluates
the flow ``res_name`` names instead, as the reference's ``check_valid``
does.
"""

from __future__ import annotations

from himo_tpu_torch.core.dataset_id import EvalSource, check_valid
from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.instance_metrics import InstanceMetrics
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.io.submission import read_comp_dis_zip
from himo_tpu_torch.utils.cli import run_cli


def main(
    data_dir: str = "",
    res_name: str = "",
    comp_dis_zip: str = "",
    strict_parity: bool = False,  # reference 4-column distance-bucket norm
    scene_filter: str = "",  # scene-id substring, e.g. "scene_adv"
) -> InstanceMetrics:
    data_name, source = check_valid(data_dir, res_name, comp_dis_zip)
    metrics = InstanceMetrics(data_name=data_name, strict_parity=strict_parity)
    flow = source == EvalSource.FLOW
    dataset = SceneFlowDataset(data_dir, vis_name=res_name if flow else "", eval=True)

    for i in range(len(dataset)):
        data = dataset[i]
        if scene_filter and scene_filter not in str(data["scene_id"]):
            continue
        frame = prepare_frame(data, data_name, res_name=res_name if flow else None)
        m = frame["mask_eval"]
        common = dict(
            pc=frame["pc_full"][m] if strict_parity else frame["xyz"][m],
            gt_flow=frame["gt_flow"][m],
            dt0=frame["dt0"][m],
            category_indices=data["flow_category_indices"][m],
            instance_ids=data["flow_instance_id"][m],
        )
        if flow:
            metrics.step(est_flow=frame["est_flow"][m], **common)
        else:
            comp_dis = read_comp_dis_zip(
                comp_dis_zip, (data["scene_id"], str(data["timestamp"]))
            )
            metrics.step(est_dis=comp_dis[m], **common)

    suffix = f"-{scene_filter.strip('_')}" if scene_filter else ""
    metrics.print(res_name=res_name, file_name=f"res-{data_name}{suffix}.json")
    return metrics


if __name__ == "__main__":
    run_cli(main)
