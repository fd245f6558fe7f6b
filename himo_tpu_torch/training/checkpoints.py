"""Checkpoints in torch format (port of ``himo_tpu/training/checkpoints.py``,
which writes orbax checkpoints).

A checkpoint is a tree of dicts, lists, tensors and Python scalars; the
trainer's is ``{"params": model.state_dict(), "opt_state":
ClippedAdam.state_dict(), "step": int}``. On disk, a checkpoint is a
directory holding ``checkpoint.pt`` (``torch.save`` of the tree, every
tensor on the CPU) and, when the save carried metrics, ``metrics.json``. A
manager keeps one such directory per step number under its own directory
(``{run_dir}/ckpts/{step}/``), as orbax's manager does.

Saves run asynchronously: :meth:`CheckpointManager.save` copies the tree to
the host before it returns (the optimizer updates parameters and moments in
place, so a background write of the live tensors would mix two steps), then
writes it on a background thread. At most one save is in flight; the next
save, :meth:`~CheckpointManager.restore_latest` and
:meth:`~CheckpointManager.close` wait for it, and re-raise its error.

Under a process group only rank 0 writes: a manager on another rank saves
nothing (its :meth:`~CheckpointManager.save` returns at once) and reads
what rank 0 wrote; the trainer's barriers order the two.
"""

from __future__ import annotations

import concurrent.futures
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from himo_tpu_torch.parallel.mesh import process_index

CHECKPOINT_FILE = "checkpoint.pt"
METRICS_FILE = "metrics.json"


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to the CPU (detached),
    so later in-place updates of the live tensors do not reach it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _write(directory: Path, tree: Dict[str, Any], metrics: Optional[dict]) -> None:
    """Write a checkpoint directory whole: into a scratch name first, so a
    crash mid-write never leaves a directory that looks complete."""
    partial = directory.with_name(directory.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    partial.mkdir(parents=True)
    torch.save(tree, partial / CHECKPOINT_FILE)
    if metrics is not None:
        (partial / METRICS_FILE).write_text(
            json.dumps({k: float(v) for k, v in metrics.items()})
        )
    shutil.rmtree(directory, ignore_errors=True)
    partial.rename(directory)


def save_checkpoint(path, tree: Dict[str, Any]) -> str:
    """Write ``tree`` as the checkpoint directory ``path`` (synchronously)."""
    path = Path(path).absolute()
    _write(path, to_host(tree), None)
    return str(path)


def _steps(directory: Path) -> List[int]:
    if not directory.is_dir():
        return []
    return sorted(
        int(p.name) for p in directory.iterdir()
        if p.is_dir() and p.name.isdigit() and (p / CHECKPOINT_FILE).is_file()
    )


def load_checkpoint(path, map_location: str = "cpu") -> Dict[str, Any]:
    """Restore a checkpoint.

    Accepts either a checkpoint directory or a manager's directory
    (numbered step subdirectories, as training writes them), which resolves
    to its latest step, so CLIs can point at ``{run_dir}/ckpts``."""
    path = Path(path).absolute()
    if not (path / CHECKPOINT_FILE).is_file():
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = path / str(steps[-1])
    return torch.load(path / CHECKPOINT_FILE, map_location=map_location, weights_only=True)


class CheckpointManager:
    """Top-k checkpoint retention, mirroring the reference training setup
    (``save_top_model=3``, assets/slurm/ssl-train-av2.sh:32).

    Without ``best_metric`` the newest ``keep`` steps are kept. With it,
    retention is by that (lower-is-better) metric from the ``metrics``
    dict passed to :meth:`save`: the kept checkpoints are the ``keep`` best
    validation ones (ties to the newer step), not merely the latest; a
    checkpoint saved without metrics ranks below every scored one."""

    def __init__(
        self,
        directory,
        keep: int = 3,
        best_metric: Optional[str] = None,
        async_save: bool = True,
    ):
        self.directory = Path(directory).absolute()
        self.writer = process_index() == 0
        if self.writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.best_metric = best_metric
        self.async_save = async_save
        self._executor = (concurrent.futures.ThreadPoolExecutor(1)
                          if async_save and self.writer else None)
        self._pending: Optional[concurrent.futures.Future] = None

    def all_steps(self) -> List[int]:
        """Steps of the complete checkpoints on disk, ascending."""
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Block until the in-flight save (if any) is durable; re-raise its
        error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def save(self, step: int, tree: Dict[str, Any], metrics: Optional[dict] = None):
        """Persist a checkpoint; with ``async_save`` the write runs in the
        background and training continues once the tree is on the host.
        The previous in-flight write is drained first, so at most one save
        is outstanding. Sync mode blocks until durable.

        Returns ``{"drain_s", "dispatch_s"}``: the time spent draining the
        PREVIOUS in-flight save and the time this save call held the caller
        (the copy to the host included). ``drain_s > 0`` at save N+1 shows
        that save N was still writing while the steps between ran. On a
        rank other than 0 nothing is saved and both are 0."""
        if not self.writer:
            return {"drain_s": 0.0, "dispatch_s": 0.0}
        t0 = time.perf_counter()
        self.wait_until_finished()
        t1 = time.perf_counter()
        host = to_host(tree)
        metrics = None if metrics is None else dict(metrics)
        if self._executor is not None:
            self._pending = self._executor.submit(self._save, int(step), host, metrics)
        else:
            self._save(int(step), host, metrics)
        return {"drain_s": t1 - t0, "dispatch_s": time.perf_counter() - t1}

    def _save(self, step: int, tree: Dict[str, Any], metrics: Optional[dict]) -> None:
        _write(self.directory / str(step), tree, metrics)
        for old in self._to_prune():
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def _metric(self, step: int) -> float:
        path = self.directory / str(step) / METRICS_FILE
        if not path.is_file():
            return float("inf")
        return float(json.loads(path.read_text()).get(self.best_metric, float("inf")))

    def _to_prune(self) -> List[int]:
        steps = self.all_steps()
        if self.best_metric is None:
            kept = steps[-self.keep :] if self.keep > 0 else []
        else:
            ranked = sorted(steps, key=lambda s: (self._metric(s), -s))
            kept = ranked[: self.keep]
        return [s for s in steps if s not in kept]

    def restore_latest(self, map_location: str = "cpu") -> Tuple[Optional[int], Optional[dict]]:
        """``(step, tree)`` of the newest checkpoint, or ``(None, None)``."""
        self.wait_until_finished()
        step = self.latest_step()
        if step is None:
            return None, None
        return step, load_checkpoint(self.directory / str(step), map_location)

    def close(self) -> None:
        """Blocks until every pending async save is durable, then closes."""
        try:
            self.wait_until_finished()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
