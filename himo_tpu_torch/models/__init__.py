"""Scene-flow networks and the estimator registry (port of :mod:`himo_tpu.models`)."""

from himo_tpu_torch.models.registry import (  # noqa: F401
    get_estimator,
    register_estimator,
    available_estimators,
)
