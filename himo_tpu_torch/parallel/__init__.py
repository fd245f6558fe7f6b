"""Data parallelism over ``torch.distributed`` (``mesh``, ``multihost``) and batched fleet inference (port of :mod:`himo_tpu.parallel`)."""

from himo_tpu_torch.parallel.mesh import make_mesh, data_sharding, replicated  # noqa: F401
