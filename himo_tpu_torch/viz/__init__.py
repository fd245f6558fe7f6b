"""Headless visualization on the host (port of ``himo_tpu/viz``): BEV
frames, instance panels, fly-throughs and the schematic, written as PNG and
APNG with numpy and zlib (:mod:`.png`), no cv2, matplotlib or open3d."""

from himo_tpu_torch.viz.render import render_bev, COLOR_MAP, hex_to_rgb  # noqa: F401
