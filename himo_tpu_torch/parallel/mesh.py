"""The device mesh over ``torch.distributed`` (port of
``himo_tpu/parallel/mesh.py``).

The reference's only multi-device axis is 4-GPU DDP training
(assets/slurm/ssl-train-av2.sh:3). The JAX package names two mesh axes, and
so does the port:

- ``data``: the batch axis of training and of the fleet; each rank takes
  its rows of every batch, and the train step all-reduces the gradients
  (:mod:`himo_tpu_torch.training.trainer`), where XLA inserts a psum;
- ``model``: reserved for spatially sharding the pillar pseudo-image; it
  carries nothing (size 1 until needed): ranks along it hold the same rows
  and compute the same values.

One process is one rank and holds one device. Without an initialized
process group the mesh is 1 x 1 on the given device (JAX's trivial mesh
on one chip); with one, it spans every rank of the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def process_count() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device) -> torch.device:
    """``torch.device(device)``, a CUDA device with its index made explicit
    (the current device when it has none)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) mesh: its ``rank``, the two axis
    sizes, its ``device`` and the process ``group`` (None: one process).
    The grid is row-major, as JAX's ``reshape(n // model, model)``: rank
    ``r`` sits at data index ``r // model``."""

    rank: int
    data: int
    model: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def shape(self) -> dict:
        """``{"data": n, "model": m}``, as JAX's ``mesh.shape``."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(data, model) mesh over the first ``n_devices`` devices.

    ``devices`` lists the mesh's devices in rank order, one a rank (default:
    every rank on the GPU, each on its current CUDA device; raises without
    CUDA, so CPU ranks pass ``devices=["cpu"] * n``). Each rank holds one
    device of the mesh, so the devices left after ``n_devices`` must number
    the process group's ranks (1 without a group)."""
    from himo_tpu_torch.models.feedforward import resolve_device

    world = process_count()
    devices = list(devices) if devices is not None else [resolve_device(None)] * world
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} ranks (one device a rank); the process "
            f"group has {world}"
        )
    rank = process_index()
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return Mesh(rank=rank, data=n // model_parallel, model=model_parallel,
                device=rank_device(devices[rank]), group=group)


def batch_rows(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a batch of ``global_batch`` along the data axis;
    raises when they do not divide evenly."""
    if global_batch % mesh.data:
        raise ValueError(
            f"global_batch={global_batch} not divisible by the data axis "
            f"({mesh.data}); pad or resize the batch"
        )
    per_rank = global_batch // mesh.data
    start = mesh.data_index * per_rank
    return slice(start, start + per_rank)


def data_sharding(mesh: Mesh, ndim: int = 1):
    """JAX's ``NamedSharding(mesh, P("data", None, ...))`` for an array of
    ``ndim`` dimensions. In the port no array spans ranks: the sharding is a
    function that takes this rank's rows (:func:`batch_rows`) of an array's
    leading dimension, as a tensor on the rank's device."""

    def shard(x):
        if np.ndim(x) != ndim:
            raise ValueError(f"data_sharding for {ndim} dimensions got {np.ndim(x)}")
        rows = batch_rows(mesh, len(x))
        x = torch.from_numpy(np.ascontiguousarray(x[rows])) if isinstance(x, np.ndarray) \
            else x[rows]
        return x.to(mesh.device)

    return shard


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """JAX's replicated sharding of the parameters: broadcast ``module``'s
    parameters and buffers from rank 0 (in place), so that every rank
    starts equal. Returns ``module``."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every array of a dict (or list) of batched
    arrays, on the rank's device; raises when the rows do not divide
    evenly over the data axis."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return data_sharding(mesh, np.ndim(tree))(tree)


def data_mean_(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` replaced in place by its mean over the data axis: one
    all-reduce sum over the group, divided by its size (ranks along the
    model axis hold equal values). Unchanged without a group."""
    if mesh.group is not None:
        dist.all_reduce(tensor, group=mesh.group)
        tensor.div_(mesh.size)
    return tensor


def data_sum_(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` replaced in place by its sum over the data axis."""
    if mesh.group is not None:
        dist.all_reduce(tensor, group=mesh.group)
        if mesh.model > 1:
            tensor.div_(mesh.model)
    return tensor


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh meets here (nothing without a group)."""
    if mesh.group is not None:
        # NCCL's barrier is an all-reduce on a device: name the rank's.
        ids = [torch.cuda.current_device()] if dist.get_backend(mesh.group) == "nccl" else None
        dist.barrier(group=mesh.group, device_ids=ids)
