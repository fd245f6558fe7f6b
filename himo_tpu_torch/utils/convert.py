"""JAX/flax parameters -> the port's PyTorch parameters.

:func:`mlp_from_jax` takes the coordinate MLP's ``[(W (in, out), b), ...]``
as they are: the port keeps the reference's layout.

For :func:`flax_to_torch`, the JAX parameters arrive as a nested dict of numpy arrays (what
``jax.tree_util.tree_map(np.asarray, params)`` gives), with or without the
top-level ``"params"`` key. The mapping:

- Dense kernels (in, out) are transposed to ``weight`` (out, in);
- Conv kernels go from HWIO to OIHW;
- GroupNorm ``scale`` / ``bias`` map to ``weight`` / ``bias`` directly;
- ``GRUCell``: ``weight_ih = cat(ir, iz, in).T``, ``weight_hh =
  cat(hr, hz, hn).T``, ``bias_ih = cat(b_ir, b_iz, b_in)`` and
  ``bias_hh = cat(0, 0, b_hn)`` (flax's ``hr`` and ``hz`` carry no bias).

Module names: ``PointFeatureNet_0`` -> ``pfn`` (its first Dense takes 7
inputs, or 10 with ``prior_feat``: the kernel's shape carries either);
``UNet_0/ConvBlock_k`` ->
``unet.down.k`` for the encoder levels and ``unet.up.(k - L)`` after them
(L = ``len(config.depths)``), ``UNet_0/Conv_0`` -> ``unet.head``;
``DeFlowGRUDecoder_0`` Dense_0..3 -> ``decoder.pillar_in``, ``point_in``,
``hidden``, ``out``; ``LinearDecoder_0`` Dense_0..2 -> ``decoder.dense0``,
``dense1``, ``out``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _gru(out: dict, prefix: str, p: dict) -> None:
    k = {g: np.asarray(p[g]["kernel"]) for g in ("ir", "iz", "in", "hr", "hz", "hn")}
    out[f"{prefix}.weight_ih"] = _t(np.concatenate([k["ir"], k["iz"], k["in"]], 1).T)
    out[f"{prefix}.weight_hh"] = _t(np.concatenate([k["hr"], k["hz"], k["hn"]], 1).T)
    out[f"{prefix}.bias_ih"] = _t(
        np.concatenate([p["ir"]["bias"], p["iz"]["bias"], p["in"]["bias"]])
    )
    zeros = np.zeros_like(np.asarray(p["hn"]["bias"]))
    out[f"{prefix}.bias_hh"] = _t(np.concatenate([zeros, zeros, p["hn"]["bias"]]))


def mlp_from_jax(params) -> list:
    """The coordinate MLP's JAX parameters, a list of ``(W (in, out), b)``
    arrays, -> the port's list of fp32 ``(W, b)`` CPU tensors."""
    return [(_t(w), _t(b)) for w, b in params]


def _unexpected(where: str, keys) -> None:
    if keys:
        raise KeyError(f"unexpected flax parameters under {where}: {sorted(keys)}")


def flax_to_torch(params: dict, config) -> dict:
    """Map a flax ``SceneFlowNet`` parameter tree (numpy leaves) to the
    port's state dict for the same ``FlowNetConfig``."""
    tree = params.get("params", params)
    out: dict = {}
    levels = len(config.depths)

    pfn = tree["PointFeatureNet_0"]
    _dense(out, "pfn.dense0", pfn["Dense_0"])
    _dense(out, "pfn.dense1", pfn["Dense_1"])
    _unexpected("PointFeatureNet_0", set(pfn) - {"Dense_0", "Dense_1"})

    unet = tree["UNet_0"]
    for name, block in unet.items():
        if name == "Conv_0":
            _conv(out, "unet.head", block)
            continue
        if not name.startswith("ConvBlock_"):
            _unexpected("UNet_0", [name])
        k = int(name.split("_")[1])
        prefix = f"unet.down.{k}" if k < levels else f"unet.up.{k - levels}"
        _conv(out, f"{prefix}.conv0", block["Conv_0"])
        _conv(out, f"{prefix}.conv1", block["Conv_1"])
        _norm(out, f"{prefix}.norm0", block["GroupNorm_0"])
        _norm(out, f"{prefix}.norm1", block["GroupNorm_1"])

    if "DeFlowGRUDecoder_0" in tree:
        dec = tree["DeFlowGRUDecoder_0"]
        names = ("pillar_in", "point_in", "hidden", "out")
        for i, name in enumerate(names):
            _dense(out, f"decoder.{name}", dec[f"Dense_{i}"])
        _gru(out, "decoder.gru", dec["GRUCell_0"])
        _unexpected(
            "DeFlowGRUDecoder_0",
            set(dec) - {f"Dense_{i}" for i in range(4)} - {"GRUCell_0"},
        )
    else:
        dec = tree["LinearDecoder_0"]
        for i, name in enumerate(("dense0", "dense1", "out")):
            _dense(out, f"decoder.{name}", dec[f"Dense_{i}"])
    _unexpected(
        "the top level",
        set(tree) - {"PointFeatureNet_0", "UNet_0", "DeFlowGRUDecoder_0",
                     "LinearDecoder_0"},
    )
    return out
