#!/usr/bin/env python3
"""Convert a JAX training run's orbax checkpoint into the port's format.

    python scripts/orbax_to_torch.py JAX_CKPTS PORT_CKPTS [model=seflowpp] [key=value ...]

``JAX_CKPTS`` is a checkpoint written by ``himo_tpu.training.train`` (a
manager directory such as ``{run_dir}/ckpts`` or ``{run_dir}/ckpts_latest``,
whose latest step is taken, or one step's directory). ``PORT_CKPTS`` gets
``{step}/checkpoint.pt`` in the layout of
``himo_tpu_torch.training.checkpoints``, so that it can serve as a port
run's ``{run_dir}/ckpts_latest``, from which ``himo_tpu_torch``'s
``train(resume=True)`` continues. Further ``key=value`` pairs are the model
overrides the JAX run was built with (``depths=(16,32)``,
``pillar.voxel_size=(0.8,0.8)``).

The tree becomes ``{"params", "opt_state", "step"}``:

- ``params``: the flax parameters through ``utils.convert.flax_to_torch``;
- ``opt_state``: optax's ``ScaleByAdamState`` (``mu``, ``nu``, ``count``)
  becomes ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` (mapped
  through ``flax_to_torch`` like the parameters) and ``step``, and the
  schedule's ``count`` becomes ``ClippedAdam.count``.

This script runs where the JAX package runs: it imports ``himo_tpu``, jax
and orbax, which the port never does.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree if tree is None or isinstance(tree, (int, float)) else np.asarray(tree)


def _find(tree, want_keys):
    """Every dict in ``tree`` whose keys are exactly ``want_keys``, in order."""
    found = []
    if isinstance(tree, dict):
        if set(tree) == set(want_keys):
            found.append(tree)
        else:
            for v in tree.values():
                found += _find(v, want_keys)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found += _find(v, want_keys)
    return found


def convert_tree(jax_tree: dict, model: str = "seflowpp", **model_overrides) -> dict:
    """An orbax-restored JAX training tree (no target) -> the port's tree."""
    from himo_tpu_torch.models.feedforward import make_model
    from himo_tpu_torch.training.trainer import TrainConfig, make_optimizer
    from himo_tpu_torch.utils.convert import flax_to_torch

    tree = _numpy_tree(jax_tree)
    net, cfg = make_model(model, device="cpu", **model_overrides)
    net.load_state_dict(flax_to_torch(tree["params"], cfg))
    adam = _find(tree["opt_state"], ("count", "mu", "nu"))
    schedule = _find(tree["opt_state"], ("count",))
    if len(adam) != 1:
        raise ValueError(f"expected one ScaleByAdamState in opt_state, found {len(adam)}")
    adam = adam[0]
    count = int(adam["count"])
    exp_avg = flax_to_torch(adam["mu"], cfg)
    exp_avg_sq = flax_to_torch(adam["nu"], cfg)
    optimizer, _ = make_optimizer(net.parameters(), TrainConfig(), 1)
    names = {id(p): name for name, p in net.named_parameters()}
    for p in optimizer.params:
        name = names[id(p)]
        optimizer.adam.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].clone(),
            "exp_avg_sq": exp_avg_sq[name].clone(),
        }
    optimizer.count = int(schedule[0]["count"]) if schedule else count
    return {"params": net.state_dict(), "opt_state": optimizer.state_dict(),
            "step": int(tree["step"])}


def convert_checkpoint(src, dst, model: str = "seflowpp", **model_overrides) -> int:
    """Convert the orbax checkpoint ``src`` into ``dst/{step}``; returns the step."""
    from himo_tpu.training.checkpoints import load_checkpoint as load_orbax

    from himo_tpu_torch.training.checkpoints import CheckpointManager

    tree = convert_tree(load_orbax(src), model, **model_overrides)
    manager = CheckpointManager(dst, keep=1, async_save=False)
    manager.save(tree["step"], tree)
    manager.close()
    return tree["step"]


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from himo_tpu_torch.utils.cli import parse_overrides

    overrides = parse_overrides(argv[2:])
    step = convert_checkpoint(argv[0], argv[1], **overrides)
    print(f"converted step {step}: {argv[0]} -> {Path(argv[1]) / str(step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
