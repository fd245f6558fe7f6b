"""Scene-flow networks and the estimator registry (port of :mod:`himo_tpu.models`)."""
