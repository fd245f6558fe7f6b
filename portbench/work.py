"""The yardstick: operations and bytes of the benchmark's work, counted from
configurations and shapes alone, so a different implementation behind the
same call is held to the same count.

- :func:`seflowpp_infer_flops` / :func:`seflowpp_train_flops`: the matrix
  products and convolutions of one item by precision, and the
  nearest-neighbour operations, for ``mfu``.
  Elementwise work (norms, activations, the correlation volume, Adam) is
  not counted: ``mfu`` is a share of the matrix peak.
- :data:`OP_RULES`: for each kernel wrapper of ``himo_tpu_torch.ops``, the
  least bytes and operations of one call, from its arguments, for
  ``port_kernel_roofline_pct``. Outputs are written once; a reduce reads
  its live values and all its ids once; a gather reads its ids (and order)
  and the distinct rows they reach; a nearest-neighbour pass costs 10 fp32
  operations a (query, reference) pair, the fused chamfer 16.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
NN_OPS_PER_PAIR = 10  # 3 subtracts, 3 multiplies, 2 adds, a compare and a select
FUSED_OPS_PER_PAIR = 16  # one distance, four masked mins


def least_seconds(bf16_flops: float = 0.0, fp32_flops: float = 0.0, nbytes: float = 0.0):
    """The least time the card takes for this work: each product at its
    precision's peak, the bytes at the memory rate, whichever bounds."""
    compute = bf16_flops / PEAKS["bf16_flops"] + fp32_flops / PEAKS["fp32_flops"]
    return max(compute, nbytes / PEAKS["hbm_bytes_per_s"])


# ------------------------------------------------------------ seflowpp


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def _unet_convs(model: dict, h: int, w: int):
    """(c_in, c_out, k, h_out, w_out) of every convolution of the UNet."""
    pfn, depths = model["point_feat_dim"], model["depths"]
    r0, r1 = model.get("corr_radii", [4, 3])
    fine, coarse = (2 * r0 + 1) ** 2, (2 * r1 + 1) ** 2
    last = len(depths) - 1
    extra = {0: fine + coarse} if last == 0 else {0: fine, last: coarse}
    convs, ch_in, skip_ch, size = [], model["num_frames"] * pfn, [], (h, w)
    for li, ch in enumerate(depths):
        size = (_same_out(size[0], 2), _same_out(size[1], 2))
        convs += [(ch_in, ch, 3, *size), (ch, ch, 3, *size)]
        ch_in = ch + extra.get(li, 0)
        skip_ch.append((ch_in, size))
    for i, (ch, (sc, s)) in enumerate(zip(reversed(depths), reversed(skip_ch))):
        c = ch_in if i == 0 else ch_in + sc
        convs += [(c, ch, 3, *s), (ch, ch, 3, *s)]
        ch_in = ch
    convs.append((ch_in, model["base_channels"] * 2 + 1, 3, h, w))  # the head, after
    return convs  # the last upsample, with the dynamic logit's channel


def seflowpp_infer_flops(model: dict, batch: int, points: int) -> dict:
    """Operations of one ``frame`` call of the ``seflowpp`` preset on
    ``batch`` frames of ``points`` points a sweep: ``bf16`` (PFN, UNet,
    GRU decoder), ``fp32`` (the decoder's output layer, slot pooling, the
    refine head's slot sums) and ``nn`` (the refine head's 11 searches)."""
    h = round((model["pillar"]["y_range"][1] - model["pillar"]["y_range"][0])
              / model["pillar"]["voxel_size"][1])
    w = round((model["pillar"]["x_range"][1] - model["pillar"]["x_range"][0])
              / model["pillar"]["voxel_size"][0])
    b, n, pfn = batch, points, model["point_feat_dim"]
    hidden = model["base_channels"] * 2
    slots = model["instance_slots"]
    k0, k1 = model["refine"]["num_query"], model["refine"]["num_ref"]
    iters = len(model["refine"].get("taus", [0] * 8))
    bf16 = model["num_frames"] * 2 * b * n * (7 * pfn + pfn * pfn)
    bf16 += sum(2 * b * ci * co * k * k * ho * wo for ci, co, k, ho, wo in _unet_convs(model, h, w))
    gru = hidden * hidden + pfn * hidden + hidden * 3 * hidden
    gru += model["gru_iters"] * hidden * 3 * hidden + hidden * hidden
    bf16 += 2 * b * n * gru
    fp32 = 2 * b * n * hidden * 4  # the output layer (flow, gate)
    fp32 += 2 * b * n * slots * (4 + 3 + 1)  # pool_by_slot's three products
    fp32 += 2 * b * slots * k0 * (4 + iters * (2 + 5 + 4) + 2 + 2 + 4)
    nn = NN_OPS_PER_PAIR * b * k0 * k1 * (iters + 3)
    return {"bf16": bf16, "fp32": fp32, "nn": nn}


def seflowpp_train_flops(model: dict, batch: int, points: int, loss_points: int) -> dict:
    """Operations of one SSL train step: the forward without the refine
    head, its backward (each product's weight gradient, and its input
    gradient where the input has one: not the PFN's first layer's, not
    the one-hot factors of the slot pooling) and the fused chamfer
    search (16 operations a pair) of ``loss_points`` samples."""
    b, n = batch, points
    fwd = seflowpp_infer_flops(model, b, n)
    first_layer = model["num_frames"] * 2 * b * n * 7 * model["point_feat_dim"]
    out_layer = 2 * b * n * model["base_channels"] * 2 * 4
    pool = 2 * b * n * model["instance_slots"]  # one (B, N, S) x (B, S, 1) product
    return {"bf16": 3 * fwd["bf16"] - first_layer, "fp32": 3 * out_layer + (8 + 7) * pool,
            "nn": FUSED_OPS_PER_PAIR * b * loss_points * loss_points}


def item_least_seconds(flops: dict) -> float:
    """The least time of an item's counted operations (``nn`` at the fp32 rate)."""
    return least_seconds(flops["bf16"], flops["fp32"] + flops["nn"])


# ------------------------------------------------------------ kernel calls


def _reduce(b, n, c, rows, live):
    return {"bytes": 4 * (live * c + b * n + b * rows * c), "ops": 0}


def _gather(b, n, c, reached, extra_ids=0):
    return {"bytes": 4 * ((1 + extra_ids) * b * n + b * n * c + reached * c), "ops": 0}


def _nn(b, n, m, per_pair=NN_OPS_PER_PAIR):
    return {"bytes": 4 * (b * n * 3 + b * m * 3 + 2 * b * n), "ops": per_pair * b * n * m}


# name -> work(call) of one call of ``himo_tpu_torch.ops``' kernel wrapper of
# that name. ``call`` holds ``shapes`` (each argument's shape, None for a
# non-tensor), ``ints`` (its int arguments) and the counts taken from its id
# tensors after the trace: ``live`` (ids in [0, rows)) and ``reached``
# (distinct such ids over the frames).
OP_RULES = {
    "scatter_max_rows": lambda c: _reduce(*c["shapes"][1], c["ints"][0], c["live"]),
    "scatter_max_resident_rows": lambda c: _reduce(*c["shapes"][1], c["ints"][0], c["live"]),
    "sorted_scatter_max_rows": lambda c: _reduce(*c["shapes"][1], c["ints"][0], c["live"]),
    "scatter_sum_rows": lambda c: _reduce(*c["shapes"][1], c["ints"][0], c["live"]),
    "sorted_scatter_sum_rows": lambda c: _reduce(*c["shapes"][1], c["ints"][0], c["live"]),
    "sorted_segment_sum": lambda c: _reduce(*c["shapes"][1], c["ints"][0], c["live"]),
    "segment_rows_sum": lambda c: _reduce(*c["shapes"][0], c["ints"][0], c["live"]),
    "gather_rows": lambda c: _gather(*c["shapes"][1], c["shapes"][0][2], c["reached"]),
    "sorted_gather_rows": lambda c: _gather(*c["shapes"][1], c["shapes"][0][2], c["reached"], 1),
    "sorted_segment_gather": lambda c: _gather(*c["shapes"][1], c["shapes"][0][2], c["reached"]),
    "nn_argmin_rows": lambda c: _nn(c["shapes"][0][0], c["shapes"][0][1], c["shapes"][1][1]),
    "nn_min_rows": lambda c: _nn(c["shapes"][0][0], c["shapes"][0][1], c["shapes"][1][1]),
    "knn_rows": lambda c: _nn(c["shapes"][0][0], c["shapes"][0][1], c["shapes"][1][1]),
    "fused_nn": lambda c: _nn(c["shapes"][0][0], c["shapes"][0][1], c["shapes"][1][1],
                              FUSED_OPS_PER_PAIR),
    "fused_nn_idx": lambda c: _nn(c["shapes"][0][0], c["shapes"][0][1], c["shapes"][1][1],
                                  FUSED_OPS_PER_PAIR),
}

# name -> (index of the argument holding the ids, index of the int giving
# the row count, or None where the ids index an image argument's rows).
ID_ARGS = {
    "scatter_max_rows": (0, 0), "scatter_max_resident_rows": (0, 0),
    "sorted_scatter_max_rows": (0, 0), "scatter_sum_rows": (0, 0),
    "sorted_scatter_sum_rows": (0, 0), "sorted_segment_sum": (0, 0),
    "segment_rows_sum": (1, 0), "gather_rows": (1, None), "sorted_gather_rows": (1, None),
    "sorted_segment_gather": (1, None),
}


def call_least_seconds(name: str, call: dict) -> float:
    work = OP_RULES[name](call)
    return least_seconds(fp32_flops=work["ops"], nbytes=work["bytes"])
