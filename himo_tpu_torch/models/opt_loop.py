"""The Adam loop shared by the runtime-optimisation estimators ``nsfp`` and
``fastnsf`` (port of ``himo_tpu/models/opt_loop.py``).

Modes, as in the reference:

- fixed length (``patience=0``): ``iterations`` steps; returns the last
  parameters and the loss of the last step (taken at its pre-update
  parameters). No host synchronisation inside the loop.
- early stopping (``patience > 0``): the loss of each step is taken at the
  pre-update parameters; ``improved = (step >= track_from) and loss <
  best * (1 - min_delta)`` (in fp32, as the reference compares); the best
  parameters are kept; the loop stops after ``patience`` steps without
  improvement, and the parameters of the last update are evaluated once
  after it. The reference runs this as a ``lax.while_loop`` on the device;
  here it is a Python loop that reads each loss on the host, one
  synchronisation per step.

Optimizer: ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root), which computes optax's ``adam``; ``schedule="cosine"`` sets
the learning rate of the update at count ``c`` to optax's
``cosine_decay_schedule(lr, iterations)(c)``, read before the update, so
the first update has the full rate. ``step_caps`` feeds ``loss_fn`` a
per-step scalar (an annealed truncation radius).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def anneal_caps(
    iterations: int,
    final_dist: float,
    init_dist: float,
    anneal_frac: float = 0.5,
) -> torch.Tensor:
    """Geometric truncation-radius schedule, (iterations,) fp32 on the CPU:
    ``init_dist`` -> ``final_dist`` over the first ``anneal_frac`` of the
    iterations, then constant."""
    n_anneal = max(int(anneal_frac * iterations), 1)
    t = torch.clamp(torch.arange(iterations, dtype=torch.float32) / n_anneal, max=1.0)
    return torch.tensor(init_dist, dtype=torch.float32) * (final_dist / init_dist) ** t


def cosine_lr(lr: float, iterations: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, iterations)`` at ``count``."""
    count = min(count, iterations)
    return lr * 0.5 * (1.0 + math.cos(math.pi * count / iterations))


def run_adam(
    loss_fn: Callable,
    params: Sequence[Sequence[torch.Tensor]],
    *,
    iterations: int,
    lr: float,
    schedule: str = "constant",
    patience: int = 0,
    min_delta: float = 1e-4,
    step_caps: torch.Tensor | None = None,
    track_from: int = 0,
):
    """Minimise ``loss_fn`` over ``params`` (a list of tuples of tensors,
    e.g. the coordinate MLP's ``(W, b)`` pairs; copied, not changed).
    Returns ``(params, loss, steps)``: a list of tuples of tensors without
    grad, the 0-dim loss tensor, and the number of steps taken.

    ``loss_fn(p)`` is called, or ``loss_fn(p, cap_t)`` with ``cap_t`` a
    Python float when ``step_caps`` is given."""
    shape = [len(group) for group in params]
    flat = [t.detach().clone().requires_grad_(True) for group in params for t in group]

    def structured(tensors):
        out, i = [], 0
        for size in shape:
            out.append(tuple(tensors[i : i + size]))
            i += size
        return out

    p = structured(flat)
    caps = None if step_caps is None else [float(c) for c in step_caps]

    def call(t: int):
        return loss_fn(p) if caps is None else loss_fn(p, caps[t])

    opt = torch.optim.Adam(flat, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def loss_and_grad(t: int) -> torch.Tensor:
        """The loss at the current parameters and its gradient, with the
        learning rate of the update at count ``t`` set."""
        if schedule == "cosine":
            for group in opt.param_groups:
                group["lr"] = cosine_lr(lr, iterations, t)
        opt.zero_grad(set_to_none=True)
        loss = call(t)
        loss.backward()
        return loss.detach()

    def snapshot():
        return [t.detach().clone() for t in flat]

    if not patience:
        loss = None
        for t in range(iterations):
            loss = loss_and_grad(t)
            opt.step()
        return structured(snapshot()), loss, iterations

    best_p, best_l = snapshot(), torch.tensor(float("inf"))
    best_value, factor = np.float32(np.inf), np.float32(1.0 - min_delta)
    since, it = 0, 0
    while it < iterations and since < patience:
        loss = loss_and_grad(it)
        value = np.float32(loss.item())
        improved = it >= track_from and value < best_value * factor
        if improved:
            best_p, best_l, best_value = snapshot(), loss, value
        since = 0 if (improved or it < track_from) else since + 1
        opt.step()
        it += 1
    with torch.no_grad():
        final = call(min(it, iterations - 1))
    if final.item() < best_value:
        best_p, best_l = snapshot(), final
    return structured(best_p), best_l, it
