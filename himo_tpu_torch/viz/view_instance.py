"""Instance-level qualitative inspection of de-skew results (port of
``himo_tpu/viz/view_instance.py``, the same numpy).

Capability parity with the reference's ``tools/view_instance.py``:
- ``print_refine_ins`` — per-instance CDE/MPE printout using the same
  brute-force chamfer variant (view_instance.py:28-41);
- ``vis_refine_ins`` — renders the de-skewed instance colored per LiDAR id
  (view_instance.py:136-143). Headless environments get PNG panels (raw vs
  refined BEV); with open3d installed an interactive window opens instead.

``instance_score`` stays the brute-force float64 difference form on the
host: the port's NN kernels use ``|q|^2 + |r|^2 - 2 q.r`` in float32, whose
cancellation at 30 m coordinates would print a chamfer of about 0.01 m for
a perfect flow where this prints 0.0000.

    python -m himo_tpu_torch.viz.view_instance data_dir=... flow_mode=raw ins_id='[1,2]'
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.utils.cli import run_cli
from himo_tpu_torch.viz.render import render_instance_panel, save_image


def instance_score(
    pc: np.ndarray,
    gt_flow: np.ndarray,
    est_flow: np.ndarray,
    dt0: np.ndarray,
    sensor_dt: float = 0.1,
):
    """Brute-force chamfer + MPE on one instance (small N only)."""
    est_pc = pc + (est_flow / sensor_dt) * dt0[:, None]
    gt_pc = pc + (gt_flow / sensor_dt) * dt0[:, None]
    d12 = np.linalg.norm(est_pc[:, None] - gt_pc, axis=2)
    cham = (np.nanmean(d12.min(axis=1)) + np.nanmean(d12.min(axis=0))) / 2
    mpe = np.linalg.norm(est_flow - gt_flow, axis=1).mean()
    return float(cham), float(mpe)


def _frame_instance(data, frame, ins_id: int):
    mask = np.asarray(data["flow_instance_id"]) == ins_id
    return {
        "pc": frame["xyz"][mask],
        "gt_flow": frame["gt_flow"][mask],
        "est_flow": frame["est_flow"][mask],
        "dt0": frame["dt0"][mask],
        "lidar_id": np.asarray(data.get("lidar_id", np.zeros(len(mask))))[mask],
    }


def print_refine_ins(
    data_dir: str = "",
    flow_mode: str = "flow",
    start_id: int = 0,
    ins_id: Sequence[int] = (1,),
):
    """Print weighted per-instance CDE/MPE for one frame."""
    if isinstance(ins_id, int):
        ins_id = [ins_id]
    dataset = SceneFlowDataset(data_dir, vis_name=flow_mode if flow_mode != "raw" else "")
    data = dataset[start_id]
    frame = prepare_frame(data, _dataset_name(data_dir), res_name=flow_mode)
    chams, mpes, counts = [], [], []
    for i in ins_id:
        inst = _frame_instance(data, frame, i)
        if len(inst["pc"]) == 0:
            print(f"ins_id {i}: no points")
            continue
        cham, mpe = instance_score(
            inst["pc"], inst["gt_flow"], inst["est_flow"], inst["dt0"]
        )
        speed = np.linalg.norm(inst["gt_flow"], axis=1).mean() / 0.1
        print(
            f"ins_id {i}: chamfer {cham:.4f}, mpe {mpe:.4f}, "
            f"{len(inst['pc'])} pts, speed {speed:.2f} m/s"
        )
        chams.append(cham)
        mpes.append(mpe)
        counts.append(len(inst["pc"]))
    if counts:
        print(f"\n {flow_mode} flow:")
        print(f"chamfer distance: {np.average(chams, weights=counts):.4f}")
        print(f"mean point error: {np.average(mpes, weights=counts):.4f}")
    return chams, mpes


def vis_refine_ins(
    data_dir: str = "",
    flow_mode: str = "raw",
    start_id: int = 0,
    ins_id: Sequence[int] = (1,),
    out_dir: str = "logs/instances",
    num_frames: int = 1,
    extent: float = 6.0,
    interactive: bool = False,
    view_file: str = "",
):
    """Render raw-vs-refined instance panels (PNG), or with
    ``interactive=True`` open the MyVisualizer window (viz/o3d_view.py;
    needs open3d and a display): SPACE play/pause, saved-viewpoint JSON —
    the reference tools/view_instance.py surface.
    """
    if isinstance(ins_id, int):
        ins_id = [ins_id]
    if interactive:
        from himo_tpu_torch.viz.o3d_view import view_dataset

        return view_dataset(
            data_dir,
            flow_mode=flow_mode,
            start_id=start_id,
            view_file=view_file or None,
            instance_ids=list(ins_id) if ins_id else None,
        )
    dataset = SceneFlowDataset(data_dir, vis_name=flow_mode if flow_mode != "raw" else "")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    saved: List[str] = []
    for data_id in range(start_id, min(start_id + num_frames, len(dataset))):
        data = dataset[data_id]
        frame = prepare_frame(data, _dataset_name(data_dir), res_name=flow_mode)
        for i in ins_id:
            inst = _frame_instance(data, frame, i)
            if len(inst["pc"]) < 3:
                continue
            refined = inst["pc"] + (inst["est_flow"] / 0.1) * inst["dt0"][:, None]
            gt_refined = inst["pc"] + (inst["gt_flow"] / 0.1) * inst["dt0"][:, None]
            panel = render_instance_panel(
                {"raw": inst["pc"], f"{flow_mode} refined": refined, "gt refined": gt_refined},
                extent=extent,
            )
            path = out / f"frame{data_id}_ins{i}_{flow_mode}.png"
            saved.append(save_image(path, panel))
    print(f"Saved {len(saved)} instance panels to {out}")
    return saved


def _dataset_name(data_dir: str) -> str:
    from himo_tpu_torch.core.dataset_id import infer_dataset_name

    try:
        return infer_dataset_name(data_dir)
    except ValueError:
        return "av2"


if __name__ == "__main__":
    run_cli(vis_refine_ins)
