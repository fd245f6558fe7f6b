"""The yardstick of the ``pair`` cells: the operations of one optimised
frame pair of ``nsfp``, counted from its configuration and sizes alone.

Per Adam step, over all ``points`` rows of pc0 (the searches and the
products run on every row; masks act on the results):
- the MLP's products in fp32: the forward's ``x @ W`` of each layer, the
  backward's weight gradient of each layer and its input gradient of every
  layer but the first (the points need none), 2 operations a
  multiply-add;
- the chamfer's two exhaustive nearest-neighbour searches, ``points`` x
  ``points`` pairs each at ``work.NN_OPS_PER_PAIR``.
After the last step one more forward gives the flow. Elementwise work
(ReLU, the chamfer's means, Adam, the K3 sum) is not counted.
"""

from __future__ import annotations

import work


def mlp_macs(hidden: int, layers: int) -> tuple:
    """(multiply-adds of one point's forward, of its backward)."""
    dims = [3] + [hidden] * layers + [3]
    shapes = list(zip(dims[:-1], dims[1:]))
    forward = sum(i * o for i, o in shapes)
    return forward, forward + sum(i * o for i, o in shapes[1:])


def nsfp_pair_flops(model: dict, points: int) -> dict:
    """Operations of one ``nsfp`` pair of ``points`` points a cloud, for
    ``work.item_least_seconds``: ``fp32`` (the MLP) and ``nn``."""
    forward, backward = mlp_macs(model["hidden"], model["layers"])
    steps = model["iterations"]
    fp32 = 2 * points * (steps * (forward + backward) + forward)
    nn = steps * 2 * work.NN_OPS_PER_PAIR * points * points
    return {"bf16": 0, "fp32": fp32, "nn": nn}
