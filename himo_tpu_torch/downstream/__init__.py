"""Downstream segmentation and detection on (compensated) point clouds
(port of :mod:`himo_tpu.downstream`)."""
