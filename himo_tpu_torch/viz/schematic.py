"""Presentation figures: rolling-shutter distortion explained (port of
``himo_tpu/viz/schematic.py``).

Media-only role parity with the reference's ``tools/manim_himo`` scenes:
(a) a spinning LiDAR sampling a moving object at different intra-sweep
times, (b) the resulting smear, and (c) the HiMo compensation collapsing
it. ``sweep_arrays`` computes each panel's data exactly as the JAX
package's ``sweep_figure`` hands it to matplotlib; ``render_figure`` draws
the two panels with numpy, :mod:`.font` and matplotlib's ``plasma`` table
(:mod:`.plasma`), so the port needs no matplotlib. The layout is the
port's own; the data are the JAX package's.

    python -m himo_tpu_torch.viz.schematic out_dir=assets/figures
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from himo_tpu_torch.utils.cli import run_cli
from himo_tpu_torch.viz import font, png
from himo_tpu_torch.viz.plasma import PLASMA

XLIM, YLIM = (6, 17), (-2.5, 2.5)
SUPTITLE = "Rolling-shutter smear of a fast object and its HiMo compensation"
CBAR_LABEL = "intra-sweep capture time (s)"
# The raster: pixels per metre, the panels' top-left corners, the figure.
PX_PER_M = 56
PANEL_TOP, PANEL_LEFTS = 88, (40, 744)
FIG_SHAPE = (500, 1400)
POINT_RADIUS_PX = 4
DASH_PX = (8, 5)  # on, off along the truth outline
TRUTH_GRAY = 102  # matplotlib's black at alpha 0.6 over white
CBAR_BOX = (400, 16, 600)  # top row, height, width
CBAR_TICKS = (0.0, 0.05, 0.1)


def _box_outline(center, size, n=40):
    l, w = size
    t = np.linspace(0, 1, n)
    edges = []
    corners = np.array(
        [[-l / 2, -w / 2], [l / 2, -w / 2], [l / 2, w / 2], [-l / 2, w / 2]]
    )
    for i in range(4):
        a, b = corners[i], corners[(i + 1) % 4]
        edges.append(a[None] + (b - a)[None] * t[:, None])
    return np.concatenate(edges) + center


def sweep_arrays(speed: float, compensated: bool, sweep_dt: float = 0.1) -> dict:
    """One panel's data: the object's sampled ``outline``, each sample's
    capture time ``dts`` (a ``default_rng(0)`` permutation: capture order
    isn't spatial order), the ``points`` as the sweep saw them (skewed) or
    compensated, the ``truth`` outline at the sweep's end, and the title."""
    pts = _box_outline((10.0, 0.0), (4.5, 2.0), n=30)
    dts = np.linspace(0, sweep_dt, len(pts))
    rng = np.random.default_rng(0)
    dts = rng.permutation(dts)
    skewed = pts + np.stack([speed * dts, np.zeros_like(dts)], axis=1)
    if compensated:
        dt0 = dts.max() - dts
        skewed = skewed + np.stack([speed * dt0, np.zeros_like(dt0)], axis=1)
    truth = _box_outline((10.0 + speed * dts.max(), 0.0), (4.5, 2.0), n=30)
    title = "compensated (HiMo)" if compensated else f"raw sweep, {speed:.0f} m/s"
    return {"outline": pts, "dts": dts, "points": skewed, "truth": truth, "title": title}


def sweep_figure(ax, speed: float, compensated: bool, sweep_dt: float = 0.1):
    """One panel on a matplotlib ``Axes`` (or anything with its methods),
    the JAX package's calls with the same arrays; the port itself draws
    with :func:`render_figure`."""
    d = sweep_arrays(speed, compensated, sweep_dt)
    sc = ax.scatter(d["points"][:, 0], d["points"][:, 1], c=d["dts"], cmap="plasma", s=14)
    ax.plot(d["truth"][:, 0], d["truth"][:, 1], "k--", lw=0.8, alpha=0.6)
    ax.set_aspect("equal")
    ax.set_xlim(*XLIM)
    ax.set_ylim(*YLIM)
    ax.set_title(d["title"], fontsize=10)
    return sc


def plasma_rgb(t: np.ndarray) -> np.ndarray:
    """uint8 RGB of values in [0, 1] through the 256-entry table, indexed
    as matplotlib's ``Colormap`` does (``int(t * 256)``, 1.0 to the last)."""
    lut = (np.asarray(PLASMA) * 255).astype(np.uint8)
    return lut[np.clip((np.asarray(t) * len(lut)).astype(int), 0, len(lut) - 1)]


def _to_px(xy: np.ndarray, left: int) -> np.ndarray:
    """Panel data coordinates -> (column, row) pixels of the figure."""
    col = left + (xy[:, 0] - XLIM[0]) * PX_PER_M
    row = PANEL_TOP + (YLIM[1] - xy[:, 1]) * PX_PER_M
    return np.stack([col, row], axis=1)


def _panel_box(left: int):
    """(top, left, bottom, right) of a panel's plot area, exclusive."""
    return (PANEL_TOP, left, PANEL_TOP + round((YLIM[1] - YLIM[0]) * PX_PER_M),
            left + round((XLIM[1] - XLIM[0]) * PX_PER_M))


def _paint(img, cols, rows, colors, box):
    """Set pixels (cols, rows) to ``colors`` within ``box``, in order."""
    top, left, bottom, right = box
    ok = (rows >= top) & (rows < bottom) & (cols >= left) & (cols < right)
    img[rows[ok], cols[ok]] = colors[ok]


def _dashed(img, path_px: np.ndarray, box) -> None:
    """A 2-px dashed polyline through ``path_px`` (column, row) pixels."""
    seg = np.diff(path_px, axis=0)
    lengths = np.hypot(seg[:, 0], seg[:, 1])
    starts = np.concatenate([[0.0], np.cumsum(lengths)[:-1]])
    samples = []
    for p, d, n, s0 in zip(path_px[:-1], seg, lengths, starts):
        t = np.arange(0.0, max(n, 1e-9), 0.5)
        arc = s0 + t
        on = arc % sum(DASH_PX) < DASH_PX[0]
        samples.append(p + d * (t / max(n, 1e-9))[:, None][on])
    xy = np.rint(np.concatenate(samples)).astype(int)
    gray = np.full((len(xy), 3), TRUTH_GRAY, np.uint8)
    for dc, dr in ((0, 0), (1, 0), (0, 1), (1, 1)):
        _paint(img, xy[:, 0] + dc, xy[:, 1] + dr, gray, box)


def _centered(img, text: str, center_x: int, baseline: int, scale: int = 2) -> None:
    width = len(text) * font.GLYPH * scale
    font.draw_text(img, text, (center_x - width // 2, baseline), (0, 0, 0), scale=scale)


def render_figure(speed: float = 20.0) -> np.ndarray:
    """The two panels (raw sweep, compensated) with their titles, the
    suptitle and a capture-time colour bar, as an (H, W, 3) uint8 image."""
    img = np.full((*FIG_SHAPE, 3), 255, np.uint8)
    _centered(img, SUPTITLE, FIG_SHAPE[1] // 2, 30)
    yy, xx = np.mgrid[-POINT_RADIUS_PX:POINT_RADIUS_PX + 1, -POINT_RADIUS_PX:POINT_RADIUS_PX + 1]
    disc = np.stack([xx, yy], -1)[xx ** 2 + yy ** 2 <= POINT_RADIUS_PX ** 2]  # (K, 2)
    for left, compensated in zip(PANEL_LEFTS, (False, True)):
        d = sweep_arrays(speed, compensated)
        box = _panel_box(left)
        top, _, bottom, right = box
        img[top - 1, left - 1:right + 1] = img[bottom, left - 1:right + 1] = 0
        img[top - 1:bottom + 1, left - 1] = img[top - 1:bottom + 1, right] = 0
        _centered(img, d["title"], (left + right) // 2, top - 14)
        _dashed(img, _to_px(d["truth"], left), box)
        centres = np.rint(_to_px(d["points"], left)).astype(int)  # (P, 2)
        span = d["dts"].max() - d["dts"].min()  # matplotlib's autoscaled norm
        colors = plasma_rgb((d["dts"] - d["dts"].min()) / span)
        px = (centres[:, None, :] + disc[None]).reshape(-1, 2)
        _paint(img, px[:, 0], px[:, 1], colors.repeat(len(disc), axis=0), box)
    dts = sweep_arrays(speed, False)["dts"]
    top, height, width = CBAR_BOX
    left = (FIG_SHAPE[1] - width) // 2
    img[top:top + height, left:left + width] = plasma_rgb(np.linspace(0, 1, width))[None]
    lo, hi = float(dts.min()), float(dts.max())
    for tick in CBAR_TICKS:
        x = left + round((tick - lo) / (hi - lo) * (width - 1))
        img[top + height:top + height + 6, x] = 0
        _centered(img, f"{tick:.2f}", x, top + height + 24)
    _centered(img, CBAR_LABEL, FIG_SHAPE[1] // 2, top + height + 56)
    return img


def main(out_dir: str = "assets/figures", speed: float = 20.0):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = png.write(out / "rolling_shutter.png", render_figure(speed))
    print(f"Wrote {path}")
    return path


if __name__ == "__main__":
    run_cli(main)
