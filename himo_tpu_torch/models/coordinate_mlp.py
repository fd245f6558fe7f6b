"""Coordinate MLP of the runtime-optimisation estimators (port of
``himo_tpu/models/coordinate_mlp.py``).

A small ReLU MLP maps a 3-D point to its 3-D flow; its weights are the
per-frame optimisation variables (one fresh initialisation per frame pair).
Parameters are a list of ``(W (in, out), b (out,))`` pairs, the reference's
layout, so JAX parameters carry over as they are
(``utils.convert.mlp_from_jax``). The layer products are ``torch.addmm`` in
fp32 (the package turns TF32 off), as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def init_mlp(
    generator: torch.Generator,
    hidden: int = 128,
    layers: int = 8,
    in_dim: int = 3,
    out_dim: int = 3,
    device: torch.device | str | None = None,
) -> Params:
    """Glorot-normal weights (std ``sqrt(2 / (fan_in + fan_out))``) drawn
    from ``generator`` on its own device, then moved to ``device``; zero
    biases. in -> hidden x layers -> out."""
    dims = [in_dim] + [hidden] * layers + [out_dim]
    device = generator.device if device is None else torch.device(device)
    params: Params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator, device=generator.device)
        w = (w * math.sqrt(2.0 / (fan_in + fan_out))).to(device)
        params.append((w, torch.zeros(fan_out, device=device)))
    return params


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass on (N, in) points -> (N, out)."""
    h = x
    for w, b in params[:-1]:
        h = torch.relu(torch.addmm(b, h, w))
    w, b = params[-1]
    return torch.addmm(b, h, w)
