"""Tensor ops and their hand-written CUDA kernels (port of :mod:`himo_tpu.ops`)."""

from himo_tpu_torch.ops.nn import nn_distance_sq, chamfer_distance, truncated_chamfer  # noqa: F401
from himo_tpu_torch.ops.voxelize import voxelize_pillars, PillarGrid  # noqa: F401
from himo_tpu_torch.ops.points_in_boxes import points_in_boxes  # noqa: F401
