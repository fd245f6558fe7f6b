"""Host-side evaluation: the HiMo instance metrics and the scene-flow metrics
(port of :mod:`himo_tpu.eval`'s flow-mode parts)."""

from himo_tpu_torch.eval.instance_metrics import InstanceMetrics  # noqa: F401
from himo_tpu_torch.eval.chamfer import chamfer_distance_host  # noqa: F401
