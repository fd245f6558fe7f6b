"""Several processes, one device each (port of
``himo_tpu/parallel/multihost.py``, over ``torch.distributed``).

One process needs nothing from here: ``make_mesh()`` is then 1 x 1. Under
``torchrun`` (``python -m torch.distributed.run --nproc-per-node=N ...``),
or with an explicit address:

    from himo_tpu_torch.parallel import multihost
    multihost.initialize()               # init_process_group under the hood
    mesh = multihost.global_mesh()       # (data, model) over every rank

Data loading stays per process: each rank loads its rows of the batch
(:func:`host_local_batch_slice`), and the train step all-reduces the
gradients (:func:`himo_tpu_torch.training.trainer.make_train_step`).

:func:`run_ranks` starts ranks as spawned processes, each under a time
limit, and returns what each returned: ``entry.dryrun_multichip`` and
``chip_smoke.py`` start their ranks with it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from himo_tpu_torch.parallel.mesh import make_mesh, process_count, process_index

# The rendezvous' and every collective's time limit: a rank that is lost
# fails the others within it instead of hanging them.
TIMEOUT_S = 300.0
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def under_torchrun() -> bool:
    """Whether ``torchrun``'s environment (rank, world size, address) is
    set."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: torch.device | str | None = None,
    timeout: float = TIMEOUT_S,
) -> None:
    """Join the default process group; nothing when one exists already.

    - ``coordinator_address`` ``host:port`` (``tcp://``), or any
      ``init_method`` URL (``file:///path``), with ``num_processes`` and
      ``process_id``; without it, ``torchrun``'s environment (``env://``);
      with neither and ``num_processes`` in (None, 1), one process, and
      this prints so (JAX's single-process mode); otherwise it raises, as
      does any failure to join.
    - ``device``: the ranks' device type, the GPU unless ``"cpu"`` is
      passed (without CUDA the GPU raises). ``backend``: ``nccl`` on the
      GPU and ``gloo`` on the CPU unless given; ``gloo`` on the GPU only
      when asked for (its CUDA collectives go through the host). Nothing
      switches backend or device on its own.
    - On the GPU with NCCL, the rank's CUDA device becomes its local rank
      (``LOCAL_RANK``, else its process id) before anything is built:
      the kernels launch on the current device. With ``gloo`` the caller
      chooses the current device.
    - ``timeout`` (seconds) bounds the rendezvous and every collective.
    """
    if dist.is_initialized():
        return
    from himo_tpu_torch.models.feedforward import resolve_device

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks; CPU ranks take gloo")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif under_torchrun():
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        for name, given, env in (("num_processes", num_processes, world),
                                 ("process_id", process_id, rank)):
            if given is not None and int(given) != env:
                raise ValueError(f"{name}={given} but torchrun's environment says {env}")
    elif num_processes in (None, 1):
        print("[multihost] single-process mode (no coordinator address and no torchrun "
              "environment)")
        return
    else:
        raise ValueError(
            f"num_processes={num_processes} needs a coordinator_address or torchrun's "
            "environment"
        )
    if device.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def global_mesh(model_parallel: int = 1, device: torch.device | str | None = None):
    """Mesh over every rank of the job, each on ``device`` (the GPU unless
    ``"cpu"`` is passed)."""
    from himo_tpu_torch.models.feedforward import resolve_device

    return make_mesh(devices=[resolve_device(device)] * process_count(),
                     model_parallel=model_parallel)


def host_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process should load.

    Raises when the batch doesn't divide evenly — silently dropping the
    remainder frames would skew training without any visible signal."""
    count = process_count()
    if global_batch % count:
        raise ValueError(
            f"global_batch={global_batch} not divisible by "
            f"process_count={count}; pad or resize the batch"
        )
    per_process = global_batch // count
    start = process_index() * per_process
    return slice(start, start + per_process)


def make_global_batch(mesh, host_arrays):
    """This rank's rows (a dict of arrays, ``host_local_batch_slice``'s)
    as tensors on the rank's device. No tensor spans ranks in the port: the
    global batch is the rows of every rank together. Raises unless every
    array has the same leading dimension."""
    sizes = {np.shape(v)[0] if np.ndim(v) else None for v in host_arrays.values()}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"local arrays need one leading (batch) dimension, got {sizes}")
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(mesh.device) for k, v in host_arrays.items()}


def _rank_main(fn, rank: int, args, results) -> None:
    """A spawned rank: ``fn(rank, *args)``; its value or its traceback goes
    to ``results``, and the process group (if ``fn`` made one) is torn
    down."""
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              timeout: float = TIMEOUT_S) -> List:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes and
    return their values in rank order. ``fn`` and ``args`` are pickled
    (``fn`` by import path; a script that calls this needs the
    ``if __name__ == "__main__":`` guard, since spawn imports the main
    module again). Raises when a rank raises, exits without a value, or
    the ranks are not done within ``timeout`` seconds; every rank still
    running then is killed."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, tuple(args), results),
                         name=f"rank{r}") for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    values = {}
    try:
        while len(values) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(values))} "
                                   f"not done within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # A rank that exited 0 has put its value (it is in flight).
                for r, p in enumerate(procs):
                    if r not in values and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} exited with code {p.exitcode} and "
                                           "no result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            values[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [values[r] for r in range(world_size)]
