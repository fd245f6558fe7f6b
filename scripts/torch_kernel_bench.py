"""Forward + backward kernel pairs of the PyTorch port, timed on one GPU
(the two sections of ``scripts/kernel_bench.py`` that ``chip_smoke.py``
and ``scripts/torch_nn_ab.py`` do not time as pairs):

    python3 scripts/torch_kernel_bench.py [--only scatter|onehot] [--rounds 3]

- **scatter**: the pillar max-pool at the 512² training shape, B8 x 65,536
  points x 33 channels -> 512² at 0.2 m (uniform clouds in +-50 m, 92 %
  valid): K1 max (``scatter_max_rows``) forward and, through autograd, K5
  (``sorted_gather_rows``, the max's backward take) as one timed pair;
  the library pair is ``scatter_reduce_`` amax and its autograd backward.
- **onehot**: ``pooling="mean_sorted"``'s pair on LiDAR-like clouds
  sorted by pillar: K10 (``sorted_segment_sum``, bf16 rounding on) forward
  at C = 33 (32 features and the count) and, through autograd, K11
  (``sorted_segment_gather``) backward; the library pair is ``index_add``
  (unrounded) and its autograd backward, ``index_select``.

Each pair runs with the kernels and with their plain PyTorch versions
(``chip_smoke.plain_kernels``); outputs and gradients must be bitwise
equal, or the script fails, but for K10's output: its fp32 sums run in
another order than the plain version's, so it is held as ``chip_smoke.py``
holds K10, within 1e-5 of each row's sum of |x| (plus 1e-6), and bitwise
from one launch to the next. Times: CUDA events over back-to-back pairs
(``ms``, the host's pace where it is the slower) and the traced device
time (``device_ms``), each the median of ``--rounds`` rounds taken in
turns (kernel, plain, library). Prints a line per pair and one JSON
object; raises without CUDA. The NN section of the JAX script (the min
pass against min + argmin at B8 16k x 16k) is covered by K6 and K7 in
``scripts/torch_nn_ab.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B = 8
N = 65536
C = 33
SECTIONS = ("scatter", "onehot")


def _scatter_inputs(device):
    import torch

    from himo_tpu_torch.ops.voxelize import PillarConfig, voxelize_pillars

    rng = np.random.default_rng(0)
    pc = torch.from_numpy(rng.uniform(-50, 50, (B, N, 3)).astype(np.float32)).to(device)
    valid = torch.from_numpy(rng.uniform(size=(B, N)) < 0.92).to(device)
    feats = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(device)
    grid = voxelize_pillars(pc, valid, PillarConfig(voxel_size=(0.2, 0.2)))
    h, w = grid.grid_shape
    g = torch.from_numpy(rng.normal(size=(B, h, w, C)).astype(np.float32)).to(device)
    return grid, feats, g


def _scatter_pairs(device):
    """(kernel pair, library pair, launches wanted): each pair returns
    (forward output, gradient of the features)."""
    import torch

    from himo_tpu_torch.ops.voxelize import scatter_max

    grid, feats, g = _scatter_inputs(device)
    h, w = grid.grid_shape
    rows = h * w

    def pair():
        f = feats.detach().requires_grad_(True)
        out = scatter_max(f, grid)
        (grad,) = torch.autograd.grad(out, f, g)
        return out.detach(), grad

    idx = grid.pillar_ids.long()[..., None].expand(-1, -1, C)

    def library():
        f = feats.detach().requires_grad_(True)
        out = torch.zeros(B, rows + 1, C, device=device).scatter_reduce(
            1, idx, f, "amax", include_self=False)
        img = out[:, :rows].reshape(B, h, w, C)
        (grad,) = torch.autograd.grad(img, f, g)
        return img.detach(), grad

    return pair, library, {"scatter_max_rows": 1, "sorted_gather_rows": 1}, None


def _onehot_pairs(device):
    import torch

    from himo_tpu_torch.data.synthetic import lidar_like_cloud
    from himo_tpu_torch.ops.mxu_scatter import scatter_sum_sorted
    from himo_tpu_torch.ops.voxelize import PillarConfig, _stable_sort, voxelize_pillars

    rng = np.random.default_rng(1)
    pc = torch.from_numpy(lidar_like_cloud(np.random.default_rng(0), B, N)).to(device)
    valid = torch.from_numpy(rng.uniform(size=(B, N)) < 0.92).to(device)
    grid = voxelize_pillars(pc, valid, PillarConfig(voxel_size=(0.2, 0.2)))
    h, w = grid.grid_shape
    rows = h * w
    spids, order = _stable_sort(grid.pillar_ids)
    feats = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(device)
    feats = torch.gather(feats, 1, order.long()[..., None].expand(-1, -1, C)).contiguous()
    g = torch.from_numpy(rng.normal(size=(B, rows, C)).astype(np.float32)).to(device)

    def pair():
        f = feats.detach().requires_grad_(True)
        out = scatter_sum_sorted(spids, f, num_rows=rows, mxu_bf16=True)
        (grad,) = torch.autograd.grad(out, f, g)
        return out.detach(), grad

    base = (torch.arange(B, device=device)[:, None] * (rows + 1))
    flat = (spids.long().clamp(max=rows) + base).reshape(-1)

    def library():
        f = feats.detach().requires_grad_(True)
        out = torch.zeros(B * (rows + 1), C, device=device).index_add(
            0, flat, f.reshape(-1, C)).reshape(B, rows + 1, C)[:, :rows]
        (grad,) = torch.autograd.grad(out, f, g)
        return out.detach(), grad

    from himo_tpu_torch.ops.mxu_scatter import _sorted_segment_sum_plain

    mag = _sorted_segment_sum_plain(spids, feats.abs(), rows, True)
    return pair, library, {"sorted_segment_sum": 1, "sorted_segment_gather": 1}, mag


def run_section(name: str, device, rounds: int) -> dict:
    import torch

    import chip_smoke as cs

    pair, library, wanted, sum_mag = {"scatter": _scatter_pairs,
                                      "onehot": _onehot_pairs}[name](device)
    cs.reset_counts()
    out_k, grad_k = pair()
    torch.cuda.synchronize()
    launches = {k: v for k, v in cs.read_counts().items() if v}
    if launches != wanted:
        raise AssertionError(f"{name}: one pair launched {launches}, wanted {wanted}")
    with cs.plain_kernels():
        out_p, grad_p = pair()
    held = "outputs and gradients bitwise equal to the plain versions'"
    if sum_mag is not None:
        err = cs.check_sum(f"{name} output", out_k, out_p, sum_mag)
        again, _ = pair()
        if not torch.equal(out_k.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{name}: the output differs from launch to launch")
        differ = int((out_k != out_p).sum())
        held = (f"output within 1e-5 sum|x| of the plain version's (max {err:.3g}, "
                f"{differ} of {out_k.numel()} values not bitwise equal) and bitwise from "
                f"launch to launch, gradients bitwise equal")
    for side in ("output", "gradient")[sum_mag is not None:]:
        got, want = (out_k, out_p) if side == "output" else (grad_k, grad_p)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: the kernels' {side} differs from the plain "
                                 f"versions' at {bad} of {got.numel()} values")
    times = {kind: {side: [] for side in ("kernel", "plain", "library")}
             for kind in ("ms", "device_ms")}
    for _ in range(rounds):
        for side, fn in (("kernel", pair), ("plain", pair), ("library", library)):
            with cs.plain_kernels() if side == "plain" else contextlib.nullcontext():
                times["ms"][side].append(cs.cuda_ms(fn, iters=10))
                times["device_ms"][side].append(cs.device_ms(fn, iters=10))
    med = {kind: {side: statistics.median(v) for side, v in sides.items()}
           for kind, sides in times.items()}
    lib_out, _ = library()
    lib_err = float((lib_out - out_k).abs().max())
    result = dict(section=name, shape=f"B{B} x {N:,} x {C} -> 512^2", launches=launches,
                  held=held, library_max_abs_err=lib_err, rounds=rounds, **med)
    cs.log(f"[kernel_bench] {name}: launches a pair {launches}; {held}; ms (events) kernel "
           f"{med['ms']['kernel']:.4f} / plain {med['ms']['plain']:.4f} / library "
           f"{med['ms']['library']:.4f}; device ms kernel {med['device_ms']['kernel']:.4f} / "
           f"plain {med['device_ms']['plain']:.4f} / library "
           f"{med['device_ms']['library']:.4f} (median of {rounds}); library forward "
           f"max |diff| {lib_err:.3g}")
    return result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=SECTIONS, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script times the GPU kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, smi = cs.phase_device()
    cs.phase_build()
    results = [run_section(name, device, args.rounds)
               for name in ([args.only] if args.only else SECTIONS)]
    cs.log("[kernel_bench] the NN section (min pass vs min + argmin, B8 16k x 16k) is "
           "K6 and K7 in scripts/torch_nn_ab.py and chip_smoke.py")
    print(json.dumps({"card": smi, "pairs": results}))
    return results


if __name__ == "__main__":
    main()
