"""Generic dataset viewer: render frames with flow/de-skew coloring (port of
``himo_tpu/viz/visualize.py``, the same numpy).

Walk a scene directory and render each frame's cloud (raw or de-skewed by
a stored flow field) to PNGs, colored by LiDAR id, height, or motion-flow
magnitude; files are ``{scene_id}_{timestamp}_{flow_mode}.png``.

    python -m himo_tpu_torch.viz.visualize data_dir=... flow_mode=seflowpp color=flow
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.utils.cli import run_cli
from himo_tpu_torch.viz.render import render_bev, save_image
from himo_tpu_torch.viz.view_instance import _dataset_name


def main(
    data_dir: str = "",
    flow_mode: str = "raw",
    color: str = "lidar",  # 'lidar' | 'height' | 'flow'
    out_dir: str = "logs/frames",
    start_id: int = 0,
    num_frames: int = 5,
    extent: float = 50.0,
    resolution: int = 960,
    refine: bool = True,
):
    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else ""
    )
    data_name = _dataset_name(data_dir)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    saved = []
    for i in range(start_id, min(start_id + num_frames, len(dataset))):
        data = dataset[i]
        frame = prepare_frame(data, data_name, res_name=flow_mode)
        pts = frame["xyz"]
        if refine:
            pts = pts + (frame["est_flow"] / 0.1) * frame["dt0"][:, None]
        keep = ~np.asarray(data["gm0"], bool)
        if color == "lidar":
            color_by = np.asarray(data.get("lidar_id", np.zeros(len(pts))))[keep]
        elif color == "flow":
            mag = np.linalg.norm(frame["est_flow"], axis=1)
            color_by = np.minimum(mag[keep] * 2, 9).astype(int)
        else:
            color_by = None
        img = render_bev(
            pts[keep],
            color_by=color_by,
            extent=extent,
            resolution=resolution,
        )
        path = out / f"{data['scene_id']}_{data['timestamp']}_{flow_mode}.png"
        saved.append(save_image(path, img))
    print(f"Rendered {len(saved)} frames to {out}")
    return saved


if __name__ == "__main__":
    run_cli(main)
