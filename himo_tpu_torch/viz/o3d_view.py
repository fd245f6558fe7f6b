"""Interactive open3d viewer with saved viewpoints and SPACE play/pause (port
of ``himo_tpu/viz/o3d_view.py``).

The reference's ``src.utils.o3d_view.MyVisualizer`` surface (used at
tools/view_instance.py:21,93-96): a windowed point-cloud stepper where

- SPACE toggles play/pause (paused = ``update`` blocks until the next
  SPACE or N keypress, matching the "`SPACE` start/stop" window titles);
- N / RIGHT advances one frame while paused;
- V saves the current camera to the viewpoint JSON; ESC/Q closes;
- a ``view_file`` JSON restores the camera each frame — either an open3d
  ``PinholeCameraParameters`` dump (has an ``intrinsic`` key) or the simple
  ``{front, lookat, up, zoom}`` form used by :mod:`himo_tpu_torch.viz.animation`.

open3d is optional and needs a display: it is imported only when a window
opens (``o3d`` may be injected instead). Each frame's geometry is computed
by :func:`frame_geometry`, plain numpy that needs no open3d.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from himo_tpu_torch.viz.render import COLOR_MAP

_KEY_SPACE = 32
_KEY_N = ord("N")
_KEY_RIGHT = 262
_KEY_V = ord("V")
_KEY_ESC = 256
_KEY_Q = ord("Q")


def hex_to_rgb(value: str):
    """'#rrggbb' -> float [0, 1] triple (the reference helper's contract)."""
    value = value.lstrip("#")
    return [int(value[i : i + 2], 16) / 255.0 for i in (0, 2, 4)]


class MyVisualizer:
    """Stepper window: call :meth:`update` once per frame."""

    def __init__(
        self,
        view_file: Optional[str] = None,
        window_title: str = "himo_tpu view, `SPACE` start/stop",
        o3d=None,
    ):
        if o3d is None:
            import open3d as o3d  # optional dependency
        self.o3d = o3d
        self.view_file = view_file
        self.playing = False
        self._advance = False
        self._closed = False
        self.vis = o3d.visualization.VisualizerWithKeyCallback()
        self.vis.create_window(window_name=window_title)
        self.vis.register_key_callback(_KEY_SPACE, self._on_space)
        for key in (_KEY_N, _KEY_RIGHT):
            self.vis.register_key_callback(key, self._on_next)
        self.vis.register_key_callback(_KEY_V, self._on_save_view)
        for key in (_KEY_ESC, _KEY_Q):
            self.vis.register_key_callback(key, self._on_close)

    # ------------------------------------------------------------- callbacks

    def _on_space(self, _vis):
        self.playing = not self.playing
        return False

    def _on_next(self, _vis):
        self._advance = True
        return False

    def _on_save_view(self, _vis):
        if self.view_file:
            self.save_viewpoint(self.view_file)
        return False

    def _on_close(self, _vis):
        self._closed = True
        return False

    # ------------------------------------------------------------ viewpoint

    def save_viewpoint(self, path) -> None:
        params = self.vis.get_view_control().convert_to_pinhole_camera_parameters()
        self.o3d.io.write_pinhole_camera_parameters(str(path), params)

    def apply_viewpoint(self, path) -> None:
        path = Path(path)
        if not path.exists():
            return
        spec = json.loads(path.read_text())
        ctl = self.vis.get_view_control()
        if "intrinsic" in spec or "extrinsic" in spec:
            params = self.o3d.io.read_pinhole_camera_parameters(str(path))
            ctl.convert_from_pinhole_camera_parameters(params, allow_arbitrary=True)
        else:  # simple front/lookat/up/zoom form (viz.animation keyframes)
            if "front" in spec:
                ctl.set_front(spec["front"])
            if "lookat" in spec:
                ctl.set_lookat(spec["lookat"])
            if "up" in spec:
                ctl.set_up(spec["up"])
            if "zoom" in spec:
                ctl.set_zoom(spec["zoom"])

    # ---------------------------------------------------------------- frames

    def update(self, geometries: Sequence, wait: bool = True) -> bool:
        """Show one frame; block while paused. Returns False once closed."""
        if self._closed:
            return False
        self.vis.clear_geometries()
        for i, geo in enumerate(geometries):
            self.vis.add_geometry(geo, reset_bounding_box=i == 0 and not self.view_file)
        if self.view_file:
            self.apply_viewpoint(self.view_file)
        self.vis.poll_events()
        self.vis.update_renderer()
        while wait and not self.playing and not self._advance and not self._closed:
            if not self.vis.poll_events():
                self._closed = True
                break
            self.vis.update_renderer()
            time.sleep(0.01)
        self._advance = False
        return not self._closed

    def destroy(self) -> None:
        self.vis.destroy_window()


def frame_geometry(
    data, frame, instance_ids: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """One frame's de-skewed non-ground points, float64 (N, 3), and their
    per-lidar colours in [0, 1] (an empty array when no point is left), optionally
    only the points of ``instance_ids``."""
    pts = frame["xyz"] + (frame["est_flow"] / 0.1) * frame["dt0"][:, None]
    keep = ~np.asarray(data["gm0"], bool)
    if instance_ids is not None:
        inst = np.asarray(data["flow_instance_id"])
        keep &= np.isin(inst, list(instance_ids))
    lidar_id = np.asarray(data.get("lidar_id", np.zeros(len(pts))))[keep]
    pts = pts[keep]
    colors = np.asarray(
        [hex_to_rgb(COLOR_MAP[int(l) % len(COLOR_MAP)]) for l in lidar_id]
    )
    return pts[:, :3].astype(np.float64), colors


def view_dataset(
    data_dir: str,
    flow_mode: str = "raw",
    start_id: int = 0,
    point_size: float = 4.0,
    view_file: Optional[str] = None,
    instance_ids: Optional[Sequence[int]] = None,
):
    """Interactive per-frame viewer (reference tools/view_instance.py role):
    de-skewed clouds colored per lidar, SPACE to play/pause."""
    import open3d as o3d

    from himo_tpu_torch.core.dataset_id import infer_dataset_name
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.eval.pipeline import prepare_frame

    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else "", eval=True
    )
    name = infer_dataset_name(str(data_dir))
    title = f"view {flow_mode} flow, `SPACE` start/stop"
    viewer = MyVisualizer(view_file=view_file, window_title=title)
    viewer.vis.get_render_option().point_size = point_size

    for i in range(start_id, len(dataset)):
        data = dataset[i]
        frame = prepare_frame(data, name, res_name=flow_mode)
        pts, colors = frame_geometry(data, frame, instance_ids)
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(pts)
        if len(colors):
            pcd.colors = o3d.utility.Vector3dVector(colors)
        axes = o3d.geometry.TriangleMesh.create_coordinate_frame(size=2)
        if not viewer.update([pcd, axes]):
            break
    viewer.destroy()
