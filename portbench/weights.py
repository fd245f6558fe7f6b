"""Seeded weights, made on the device in one draw and handed to both the
program and the reference."""

from __future__ import annotations

import math
import time

import torch

BIAS_STD = 0.02


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 % 2**63)


def make(shapes: dict, seed: int, device: torch.device) -> dict:
    """float32 tensors for every ``name -> shape``: weights normal with
    variance 1 / fan-in, biases normal with std ``BIAS_STD``, group norms'
    scales 1 and shifts 0; one normal draw on ``device`` for all of them."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, device), device=device)
    out = {}
    for name, chunk in zip(names, torch.split(flat, sizes)):
        shape = shapes[name]
        if ".norm" in name:
            out[name] = torch.ones(shape, device=device) if name.endswith("weight") else \
                torch.zeros(shape, device=device)
        elif len(shape) == 1:
            out[name] = chunk.reshape(shape) * BIAS_STD
        else:
            out[name] = chunk.reshape(shape) / math.sqrt(math.prod(shape[1:]))
    return out


def make_calibrated(net_config, seed: int, device: torch.device, batch: dict, valid_key: str,
                    targets: dict):
    """``(weights, seconds)``: :func:`make`'s weights for the network of
    ``net_config``, with the dynamic image's and the gate's output biases
    shifted so that, on ``batch`` (host tensors ``pc0``, ``pc1``,
    ``pc_hist`` and the mask ``valid_key``), the plain reference opens them
    on the configuration's shares (``reference.seflowpp.calibrate``);
    random weights otherwise shut them on all or none. ``seconds`` is the
    time of the reference's pass, which set-up does not count."""
    from reference import seflowpp as ref

    weights = make(ref.param_shapes(net_config), seed, device)
    t0 = time.perf_counter()
    model = ref.SeFlowPP(net_config).to(device)
    model.load_state_dict(weights)
    d = {k: batch[k].to(device) for k in ("pc0", "pc1", "pc_hist", valid_key)}
    shift = ref.calibrate(model, d["pc0"], d["pc1"], d["pc_hist"], d[valid_key], **targets)
    del model, d
    weights["unet.head.bias"][net_config.base_channels * 2] -= shift["dyn"]
    weights["decoder.out.bias"][3] -= shift["gate"]
    return weights, time.perf_counter() - t0
