"""Compensation math and the de-skew pipeline (port of :mod:`himo_tpu.core`)."""

from himo_tpu_torch.core.compensation import (  # noqa: F401
    flow_to_comp_dis,
    refine_points,
    ego_points_mask,
    pose_flow,
    dt0_from_lidar_dt,
    evaluation_mask,
    SCANIA_EGO_BOX,
    AV2_EGO_BOX,
    CLOSE_DISTANCE_THRESHOLD,
)
from himo_tpu_torch.core.dataset_id import infer_dataset_name, EvalSource  # noqa: F401
