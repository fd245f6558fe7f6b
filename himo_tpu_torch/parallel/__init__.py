"""Data parallelism over ``torch.distributed`` (``mesh``, ``multihost``) and batched fleet inference (port of :mod:`himo_tpu.parallel`)."""
