"""Headless point-cloud rendering on the host (port of
``himo_tpu/viz/render.py``, the same numpy).

A numpy bird's-eye-view rasterizer, written to PNG by :mod:`.png` in
place of cv2. ``render_bev`` keeps the JAX package's arithmetic, quirks
included, so that its images are bitwise equal: a centre given as Python
floats is float64 while a cloud's mean is float32, ``astype(int)``
truncates toward zero (points just left of or above the edge land on pixel
0), and later ``(dx, dy)`` passes overwrite earlier ones. The instance
panels' labels are drawn with :mod:`.font`'s bitmap glyphs where the JAX
package uses ``cv2.putText`` (Hershey simplex, scale 0.8, thickness 2):
their pixels differ inside the label's box only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from himo_tpu_torch.viz import font, png

# The reference colors points per LiDAR id (view_instance.py:138-143); a
# qualitative palette keyed by small ints, hex like the o3d_view color_map.
COLOR_MAP = [
    "#1f77b4",
    "#ff7f0e",
    "#2ca02c",
    "#d62728",
    "#9467bd",
    "#8c564b",
    "#e377c2",
    "#7f7f7f",
    "#bcbd22",
    "#17becf",
]
LABEL_ORG = (12, 28)  # the label's baseline, left end (x, y), in each panel
LABEL_SCALE = 2  # 8x8 glyphs drawn at 16x16
LABEL_COLOR = (255, 255, 255)


def hex_to_rgb(code: str) -> Tuple[int, int, int]:
    code = code.lstrip("#")
    return tuple(int(code[i : i + 2], 16) for i in (0, 2, 4))


def _colors_for(points: np.ndarray, color_by: Optional[np.ndarray]) -> np.ndarray:
    if color_by is None:
        # Height-based coloring.
        z = points[:, 2]
        t = np.clip((z - z.min()) / max(float(np.ptp(z)), 1e-6), 0, 1)
        rgb = np.stack([t * 255, 80 + t * 100, 255 - t * 255], axis=1)
        return rgb.astype(np.uint8)
    ids = np.asarray(color_by).astype(int) % len(COLOR_MAP)
    palette = np.array([hex_to_rgb(c) for c in COLOR_MAP], dtype=np.uint8)
    return palette[ids]


def render_bev(
    points: np.ndarray,
    color_by: Optional[np.ndarray] = None,
    extent: float = 50.0,
    center: Tuple[float, float] = (0.0, 0.0),
    resolution: int = 960,
    point_px: int = 1,
    background: int = 16,
) -> np.ndarray:
    """Rasterize a cloud top-down into an RGB uint8 image (H, W, 3)."""
    img = np.full((resolution, resolution, 3), background, dtype=np.uint8)
    xy = points[:, :2] - np.asarray(center)
    scale = resolution / (2 * extent)
    px = ((xy[:, 0] + extent) * scale).astype(int)
    py = ((extent - xy[:, 1]) * scale).astype(int)
    ok = (px >= 0) & (px < resolution) & (py >= 0) & (py < resolution)
    colors = _colors_for(points, color_by)[ok]
    px, py = px[ok], py[ok]
    for dx in range(point_px):
        for dy in range(point_px):
            xs = np.clip(px + dx, 0, resolution - 1)
            ys = np.clip(py + dy, 0, resolution - 1)
            img[ys, xs] = colors
    return img


def render_instance_panel(
    clouds: Dict[str, np.ndarray],
    extent: float = 6.0,
    resolution: int = 480,
) -> np.ndarray:
    """Side-by-side BEV panels of named clouds (e.g. raw vs refined), each
    labelled with its name."""
    panels = []
    for name, pc in clouds.items():
        center = tuple(pc[:, :2].mean(axis=0))
        panel = render_bev(pc, extent=extent, center=center, resolution=resolution, point_px=2)
        font.draw_text(panel, name, LABEL_ORG, LABEL_COLOR, scale=LABEL_SCALE)
        panels.append(panel)
    return np.concatenate(panels, axis=1)


def save_image(path, image: np.ndarray) -> str:
    """Write an RGB image as a PNG (the file holds RGB, as cv2's does)."""
    return png.write(path, image)
