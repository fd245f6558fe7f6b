"""Batched fleet inference on one GPU (port of :mod:`himo_tpu.parallel`'s fleet)."""
