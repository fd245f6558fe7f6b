"""Tensor ops and their hand-written CUDA kernels (port of :mod:`himo_tpu.ops`)."""
