"""Synthetic inputs (port of the parts of :mod:`himo_tpu.data` the slice needs)."""
