"""Scene fly-throughs: spline camera trajectories -> animated PNG (port of
``himo_tpu/viz/animation.py``).

``interpolate_trajectory`` smooths keyframed camera poses with clamped cubic
splines (the reference's tools/animation_video.py:32-69 keys
front/lookat/up/zoom); ``save_animation`` renders each dataset frame from
the moving camera, the same frames in the same order as the JAX package,
and writes them as an APNG through :mod:`.png` where the JAX package
encodes an mp4 with cv2 (the port has no video encoder).

Headless rendering maps the camera to a BEV view: ``lookat`` xy -> view
center, ``zoom`` -> extent.

    python -m himo_tpu_torch.viz.animation data_dir=... flow_mode=flow output=out.png
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.interpolate import CubicSpline

from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.eval.pipeline import prepare_frame
from himo_tpu_torch.utils.cli import run_cli
from himo_tpu_torch.viz import png
from himo_tpu_torch.viz.render import render_bev
from himo_tpu_torch.viz.view_instance import _dataset_name

APNG_SUFFIXES = (".png", ".apng")


def interpolate_trajectory(traj: List[Dict], sample_step: int = 10) -> List[Dict]:
    """Expand keyframes (front/lookat/up/zoom dicts) with clamped splines."""
    keys = ("front", "lookat", "up", "zoom")
    stacked = {k: np.array([np.atleast_1d(f[k]) for f in traj]) for k in keys}
    t = np.arange(len(traj))
    splines = {k: CubicSpline(t, v, bc_type="clamped") for k, v in stacked.items()}
    t_new = np.linspace(0, t[-1], num=len(traj) * sample_step - (sample_step - 1))
    out = []
    for ti in t_new:
        frame = {k: splines[k](ti).tolist() for k in keys}
        frame["zoom"] = float(np.atleast_1d(frame["zoom"])[0])
        out.append(frame)
    return out


def default_trajectory(num_key: int = 4) -> List[Dict]:
    """A gentle orbit if no saved viewpoint JSON is provided."""
    return [
        {
            "front": [np.cos(a), np.sin(a), 0.6],
            "lookat": [0.0, 0.0, 0.0],
            "up": [0.0, 0.0, 1.0],
            "zoom": 0.5 + 0.1 * np.sin(a),
        }
        for a in np.linspace(0, np.pi / 2, num_key)
    ]


def save_animation(
    data_dir: str = "",
    flow_mode: str = "raw",
    output: str = "logs/animation.png",
    view_file: str = "",
    fps: int = 10,
    resolution: int = 960,
    max_frames: Optional[int] = None,
    sample_step: int = 1,
    refine: bool = True,
):
    """Render the de-skewed dataset as an APNG fly-through at ``output``
    (``.png`` or ``.apng``; a video name such as ``.mp4`` raises)."""
    if Path(output).suffix.lower() not in APNG_SUFFIXES:
        raise ValueError(f"output {output!r}: the port writes the fly-through as an animated "
                         f"PNG (APNG), so name it with one of {APNG_SUFFIXES}")
    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else ""
    )
    n = len(dataset) if max_frames is None else min(max_frames, len(dataset))

    if view_file and Path(view_file).exists():
        keyframes = json.loads(Path(view_file).read_text())
        if isinstance(keyframes, dict):
            keyframes = keyframes.get("trajectory", [keyframes])
    else:
        keyframes = default_trajectory()
    traj = interpolate_trajectory(keyframes, sample_step=max(n // len(keyframes), 2))

    Path(output).parent.mkdir(parents=True, exist_ok=True)
    data_name = _dataset_name(data_dir)
    with png.APNGWriter(output, fps, resolution, resolution) as writer:
        for i in range(0, n, sample_step):
            data = dataset[i]
            cam = traj[min(i * len(traj) // max(n, 1), len(traj) - 1)]
            frame = prepare_frame(data, data_name, res_name=flow_mode)
            pts = frame["xyz"]
            if refine:
                comp = (frame["est_flow"] / 0.1) * frame["dt0"][:, None]
                pts = pts + comp
            keep = ~np.asarray(data["gm0"], bool)
            extent = max(10.0, 60.0 * (1.0 - 0.8 * cam["zoom"]))
            img = render_bev(
                pts[keep],
                color_by=np.asarray(data.get("lidar_id", np.zeros(len(pts))))[keep],
                extent=extent,
                center=tuple(np.atleast_1d(cam["lookat"])[:2]),
                resolution=resolution,
            )
            writer.write(img)
    print(f"Wrote animation to {output}")
    return output


if __name__ == "__main__":
    run_cli(save_animation)
