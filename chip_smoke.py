#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Two main paths, at full width with random weights from seeded generators:

- ``seflowpp`` inference + de-skew (what ``bench.py`` times for the JAX
  package): the network in bf16 on the 512x512 grid at 0.2 m, 8 frames x
  65,536 points x 3 sweeps, then ``comp_dis = flow * dt0 / 0.1`` and
  ``refined = pc0 + comp_dis``;
- the ``seflowpp`` SSL train step (what ``scripts/chip_train_ab.py`` times
  for the JAX package): ``TrainConfig()`` (8 frames x 65,536 points, 16,384
  chamfer points, Adam with warmup and clip), bf16, on that script's batch;
  four optimizer steps, then one validation step.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every ``himo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes, timed with CUDA events beside the plain version and, where
   one PyTorch call computes the same function, beside that call;
4. slice: the full inference forward through the kernels (launch counts
   checked: 3 scatter_max_rows, 10 nn_argmin_rows, 1 nn_min_rows), checked
   against the same forward with the plain versions on the card, and timed;
5. train: four steps through the kernels (launches checked per step:
   4 scatter_max_rows, 1 scatter_sum_rows, 1 fused_nn_idx, 3 segment_rows_sum);
   before each, the same loss terms and gradients with the plain versions
   on the card, held against the step's (loss terms within 1e-4 relative,
   gradient norm within 1e-3, cosine >= 0.999; enforced at step 1, logged
   after); step 1 (lr 0) leaves the parameters unchanged and steps 2-4
   change them; one validation step (4 scatter_max_rows, 1 fused_nn); every
   metric finite; step times and peak memory;
6. profile: after each of the two paths, three more calls of it under
   ``torch.profiler``: device busy share, launches per call, the kernels
   with the most device time and each of the port's kernels' device time
   per launch.

Each path runs with every launch count set to 0 just before it and read
just after. The second-to-last line is a JSON object with one entry per
kernel entry point (``launches`` summed over the three path runs); the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 8
NUM_POINTS = 65536
VALID_FRACTION = 0.92
SCATTER_CHANNELS = 32
GATHER_CHANNELS = 65  # 64 UNet feature channels + the slot channel
NN_SHAPES = ((4096, 8192), (8192, 4096))  # ICP/null/score passes, claim pass
SEGMENT_SHAPES = ((16384, 65536), (32768, 16384))  # take_rows bwd, fused bwd
FUSED_POINTS = 16384  # TrainConfig().loss_points
SLICE_TOL_M = 1e-3  # refined points, kernels vs plain versions
SLICE_MIN_AGREE = 0.99
TRAIN_STEPS = 4
STEPS_PER_EPOCH = 10
TERM_RTOL = 1e-4  # step-1 loss terms, kernels vs plain versions
NORM_RTOL = 1e-3  # step-1 gradient global norm
MIN_COSINE = 0.999  # step-1 gradients
PROFILE_CALLS = 3  # traced calls of each main path
PROFILE_TOP = 12  # kernels listed by device time
# Roofline of one H100 SXM (NVIDIA's data sheet; at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per (query, reference) pair: the squared distance is
# 3 subtracts, 3 multiplies and 2 adds; each masked min adds the penalty and
# compares (2 per min): 8 + 2 = 10 for one min, 8 + 4 * 2 = 16 for the four
# fused mins.
NN_OPS_PER_PAIR = 10
FUSED_OPS_PER_PAIR = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _wrappers():
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    return {
        (pvox, "scatter_max_rows"): pvox._scatter_max_rows_plain,
        (pvox, "scatter_sum_rows"): pvox._scatter_sum_rows_plain,
        (pnn, "nn_argmin_rows"): pnn._nn_argmin_plain,
        (pnn, "nn_min_rows"): pnn._nn_min_plain,
        (pnn, "segment_rows_sum"): pnn._segment_rows_sum_plain,
        (pnn, "fused_nn"): lambda *a: pnn._fused_nn_plain(*a)[:4],
        (pnn, "fused_nn_idx"): pnn._fused_nn_plain,
    }


def reset_counts() -> None:
    for mod, name in _wrappers():
        getattr(mod, name).launches = 0


def read_counts() -> dict:
    return {name: getattr(mod, name).launches for mod, name in _wrappers()}


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain PyTorch version (the
    reference run on the card); restored on exit."""
    table = _wrappers()
    saved = {key: getattr(*key) for key in table}
    for (mod, name), plain in table.items():
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the GPU port")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return torch.device("cuda", 0), smi


def phase_build():
    from himo_tpu_torch.kernels import _build

    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    log(f"build {', '.join(names)}: {time.perf_counter() - start:.2f} s in parallel")
    for name, path in paths.items():
        log(f"  {name} -> {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


def _clouds(device):
    import torch

    from himo_tpu_torch.data.synthetic import lidar_like_cloud

    rng = np.random.default_rng(0)
    pc0, pc1, pch = (
        torch.from_numpy(lidar_like_cloud(rng, BATCH, NUM_POINTS)).to(device)
        for _ in range(3)
    )
    n_valid = int(NUM_POINTS * VALID_FRACTION)
    valid = (torch.arange(NUM_POINTS, device=device) < n_valid)[None].repeat(BATCH, 1)
    dt0 = torch.from_numpy(
        rng.uniform(0, 0.1, size=(BATCH, NUM_POINTS)).astype(np.float32)
    ).to(device)
    return pc0, pc1, pch, valid, dt0, n_valid


def _flat_rows(pids, rows):
    """(B, N) row ids -> (B * N,) int64 rows of a (B * rows + 1, C) table,
    ids >= rows at the last (discarded) row: the library calls' index."""
    import torch

    b = pids.shape[0]
    base = torch.arange(b, device=pids.device, dtype=torch.int64)[:, None] * rows
    p = pids.to(torch.int64)
    return torch.where(p < rows, base + p, torch.full_like(p, b * rows)).reshape(-1)


def phase_scatter(device, clouds):
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    pc0, _, _, valid, _, _ = clouds
    cfg = pvox.PillarConfig()
    grid = pvox.voxelize_pillars(pc0, valid, cfg)
    rows = cfg.num_pillars
    trash = float((grid.pillar_ids >= rows).float().mean())
    gen = torch.Generator(device=device).manual_seed(1)
    feats = torch.relu(torch.randn(
        BATCH, NUM_POINTS, SCATTER_CHANNELS, device=device, generator=gen
    ))
    pids = grid.pillar_ids.contiguous()
    got = pvox.scatter_max_rows(pids, feats, rows)
    want = pvox._scatter_max_rows_plain(pids, feats, rows)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"scatter_max kernel differs from plain in {bad} values")
    ms = cuda_ms(lambda: pvox.scatter_max_rows(pids, feats, rows))
    plain_ms = cuda_ms(lambda: pvox._scatter_max_rows_plain(pids, feats, rows))
    flat = _flat_rows(pids, rows)[:, None].expand(-1, SCATTER_CHANNELS)
    src = feats.reshape(-1, SCATTER_CHANNELS)
    # The same work as the wrapper: a new table, unreached rows 0.
    library_ms = cuda_ms(lambda: torch.zeros(
        BATCH * rows + 1, SCATTER_CHANNELS, device=device
    ).scatter_reduce_(0, flat, src, "amax", include_self=False))
    log(f"scatter_max B={BATCH} N={NUM_POINTS} C={SCATTER_CHANNELS} rows={rows} "
        f"trash={trash:.3f}: bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"scatter_reduce_ amax {library_ms:.4f} ms")
    n = BATCH * NUM_POINTS
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                **bound(n * 4 + n * SCATTER_CHANNELS * 4 + BATCH * rows * SCATTER_CHANNELS * 4,
                        n * SCATTER_CHANNELS))


def _check_sum(name, got, want, mag):
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 1e-5 * mag + 1e-6).all()):
        raise AssertionError(f"{name}: |kernel - plain| above 1e-5*sum|x|+1e-6 "
                             f"(max {float(err.max())})")
    return float(err.max())


def phase_scatter_sum(device, clouds):
    """K1 sum: the 512x512 gather_pillars backward, (B, N, 65) fp32 into
    (B, 512^2, 65), at the pillar ids of the main path's cloud."""
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    pc0, _, _, valid, _, _ = clouds
    cfg = pvox.PillarConfig()
    grid = pvox.voxelize_pillars(pc0, valid, cfg)
    rows, c = cfg.num_pillars, GATHER_CHANNELS
    pids = grid.pillar_ids.contiguous()
    gen = torch.Generator(device=device).manual_seed(2)
    vals = torch.randn(BATCH, NUM_POINTS, c, device=device, generator=gen)
    vals = torch.where(torch.rand(vals.shape, device=device, generator=gen) < 0.5,
                       vals, torch.zeros_like(vals))  # ReLU'd cotangents
    got = pvox.scatter_sum_rows(pids, vals, rows)
    want = pvox._scatter_sum_rows_plain(pids, vals, rows)
    mag = pvox._scatter_sum_rows_plain(pids, vals.abs(), rows)
    err = _check_sum("scatter_sum_rows", got, want, mag)
    del got, want, mag
    ms = cuda_ms(lambda: pvox.scatter_sum_rows(pids, vals, rows))
    plain_ms = cuda_ms(lambda: pvox._scatter_sum_rows_plain(pids, vals, rows))
    flat = _flat_rows(pids, rows)
    src = vals.reshape(-1, c)
    # The same work as the wrapper: a new zeroed table, then the sum.
    library_ms = cuda_ms(
        lambda: torch.zeros(BATCH * rows + 1, c, device=device).index_add_(0, flat, src))
    log(f"scatter_sum_rows B={BATCH} N={NUM_POINTS} C={c} rows={rows}: within "
        f"1e-5*sum|x|+1e-6 (max abs err {err:.3e}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms")
    n = BATCH * NUM_POINTS
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(n * 4 + n * c * 4 + BATCH * rows * c * 4, n * c))


def phase_segment_sum(device):
    """K3 sum at both train-step shapes: take_rows' backward (16,384 rows
    of 3 into 65,536) and the fused NN backward (32,768 into 16,384)."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    out = {}
    for n, rows in SEGMENT_SHAPES:
        gen = torch.Generator(device=device).manual_seed(n + rows)
        ids = torch.randint(0, rows, (BATCH, n), device=device, generator=gen,
                            dtype=torch.int32)
        ids[:, :64] = 5  # duplicates onto one row
        vals = torch.randn(BATCH, n, 3, device=device, generator=gen)
        got = pnn.segment_rows_sum(vals, ids, rows)
        want = pnn._segment_rows_sum_plain(vals, ids, rows)
        mag = pnn._segment_rows_sum_plain(vals.abs(), ids, rows)
        err = _check_sum(f"segment_rows_sum {n}->{rows}", got, want, mag)
        ms = cuda_ms(lambda: pnn.segment_rows_sum(vals, ids, rows), iters=50)
        plain_ms = cuda_ms(lambda: pnn._segment_rows_sum_plain(vals, ids, rows), iters=50)
        flat = _flat_rows(ids, rows)
        src = vals.reshape(-1, 3)
        library_ms = cuda_ms(lambda: torch.zeros(  # a new zeroed table, as the wrapper
            BATCH * rows + 1, 3, device=device).index_add_(0, flat, src), iters=50)
        log(f"segment_rows_sum B={BATCH} {n}x3 -> {rows}: within 1e-5*sum|x|+1e-6 "
            f"(max abs err {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_add_ {library_ms:.4f} ms")
        pts = BATCH * n
        out[(n, rows)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms,
                              **bound(pts * 4 + pts * 12 + BATCH * rows * 12, pts * 3))
    return out


def _nn_inputs(device, n, m, seed):
    import torch

    from himo_tpu_torch.ops import nn as pnn

    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(BATCH, n, 3, device=device, generator=gen) * 80.0 - 40.0
    r = torch.rand(BATCH, m, 3, device=device, generator=gen) * 80.0 - 40.0
    r[:, m // 2 : m // 2 + 64] = r[:, :64]  # exact duplicate refs
    q[:, :32] = r[:, :32]  # queries on duplicated refs: lowest index must win
    qv = torch.rand(BATCH, n, device=device, generator=gen) > 0.1
    rv = torch.rand(BATCH, m, device=device, generator=gen) > 0.1
    qv[:, :32] = True
    rv[:, :64] = True
    rv[:, m // 2 : m // 2 + 64] = True
    return pnn._pad_coords(q, qv), pnn._pad_coords(r, rv), qv


def phase_nn(device):
    import torch

    from himo_tpu_torch.ops import nn as pnn

    out = {}
    for n, m in NN_SHAPES:
        q, r, qv = _nn_inputs(device, n, m, seed=n + m)
        d, idx = pnn.nn_argmin_rows(q, r)
        dmin = pnn.nn_min_rows(q, r)
        pd, pidx = pnn._nn_argmin_plain(q, r)
        pmin = pnn._nn_min_plain(q, r)
        torch.cuda.synchronize()
        qn = (q * q).sum(-1)
        rn = (r * r).sum(-1)
        tol = 1e-5 * (qn + torch.gather(rn, 1, idx.long())) + 1e-6
        err = (d - pd).abs()
        if not bool((err <= tol)[qv].all()):
            raise AssertionError(f"nn_argmin d2 off tolerance at {n}x{m}: {float(err[qv].max())}")
        err_min = (dmin - pmin).abs()
        if not bool((err_min <= tol)[qv].all()):
            raise AssertionError(f"nn_min d2 off tolerance at {n}x{m}")
        chosen = torch.gather(r, 1, idx.long()[..., None].expand(-1, -1, 3))
        direct = ((q - chosen) ** 2).sum(-1)
        if not bool(((direct - pd).abs() <= tol)[qv].all()):
            raise AssertionError(f"nn_argmin index not at the min at {n}x{m}")
        ties = idx[:, :32].cpu().numpy()
        if not (ties == np.arange(32)).all():
            raise AssertionError("exact-duplicate ties did not resolve to the lowest index")
        flips = int((idx != pidx)[qv].sum())
        ms_arg = cuda_ms(lambda: pnn.nn_argmin_rows(q, r))
        plain_arg = cuda_ms(lambda: pnn._nn_argmin_plain(q, r), iters=5)
        ms_min = cuda_ms(lambda: pnn.nn_min_rows(q, r))
        plain_min = cuda_ms(lambda: pnn._nn_min_plain(q, r), iters=5)
        log(f"nn B={BATCH} {n}x{m}: d2 within tolerance, ties lowest-index, "
            f"{flips} argmin index differences at near-ties; "
            f"argmin kernel {ms_arg:.4f} ms plain {plain_arg:.4f} ms; "
            f"min kernel {ms_min:.4f} ms plain {plain_min:.4f} ms")
        pairs = BATCH * n * m
        io = BATCH * (n + m) * 12
        out[(n, m)] = dict(
            argmin=dict(max_abs_err=float(err[qv].max()), ms=ms_arg, plain_ms=plain_arg,
                        library_ms=None,
                        **bound(io + BATCH * n * 8, pairs * NN_OPS_PER_PAIR)),
            min=dict(max_abs_err=float(err_min[qv].max()), ms=ms_min, plain_ms=plain_min,
                     library_ms=None, **bound(io + BATCH * n * 4, pairs * NN_OPS_PER_PAIR)),
        )
    return out


def _train_batch(device, config, with_gt: bool = False):
    import torch

    from himo_tpu_torch.data.synthetic import train_batch

    arrays = train_batch(np.random.default_rng(0), config.batch_size,
                         config.num_points, config.loss_points, with_gt=with_gt)
    return {key: torch.from_numpy(v).to(device) for key, v in arrays.items()}


def phase_fused(device):
    """K8 at the train step's shape: the chamfer samples of the batch
    (16,384 per side and frame), its validity and dynamic masks as
    penalties, plus exact duplicates for the tie rule."""
    import torch

    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.training.trainer import TrainConfig

    batch = _train_batch(device, TrainConfig())
    i0 = batch["loss_idx0"].long()
    i1 = batch["loss_idx1"].long()
    q = torch.gather(batch["pc0"], 1, i0[..., None].expand(-1, -1, 3)).contiguous()
    r = torch.gather(batch["pc1"], 1, i1[..., None].expand(-1, -1, 3)).contiguous()
    d0 = torch.gather(batch["dynamic0"], 1, i0)
    d1 = torch.gather(batch["dynamic1"], 1, i1)
    n = m = FUSED_POINTS
    r[:, m // 2 : m // 2 + 64] = r[:, :64]
    q[:, :32] = r[:, :32]
    d1[:, :64] = d1[:, m // 2 : m // 2 + 64] = True

    def pen(mask):
        return torch.where(mask, 0.0, pnn._MASK_BIG).to(torch.float32).contiguous()

    ones_q = torch.ones_like(d0)
    ones_r = torch.ones_like(d1)
    args = (q, r, pen(ones_q), pen(d0), pen(ones_r), pen(d1))
    outs = pnn.fused_nn_idx(*args)
    mins = pnn.fused_nn(*args)
    plain = pnn._fused_nn_plain(*args)
    torch.cuda.synchronize()
    sides = ((q, r, args[4]), (q, r, args[5]), (r, q, args[2]), (r, q, args[3]))
    errs, min_errs, flips = [], [], 0
    for k, (src, dst, p) in enumerate(sides):
        idx = outs[4 + k].long()
        at = torch.gather(dst, 1, idx[..., None].expand(-1, -1, 3))
        tol = 1e-5 * ((src * src).sum(-1) + (at * at).sum(-1)) + 1e-6
        err = (outs[k] - plain[k]).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"fused_nn_idx output {k} off tolerance ({float(err.max())})")
        min_err = (mins[k] - plain[k]).abs()
        if not bool((min_err <= tol).all()):
            raise AssertionError(f"fused_nn output {k} off tolerance ({float(min_err.max())})")
        min_errs.append(float(min_err.max()))
        direct = ((src - at) ** 2).sum(-1) + torch.gather(p, 1, idx)
        if not bool(((direct - plain[k]).abs() <= tol).all()):
            raise AssertionError(f"fused_nn_idx output {k}: index not at the min")
        errs.append(float(err.max()))
        flips += int((outs[4 + k] != plain[4 + k]).sum())
    # Queries 0..31 sit on references: the winner is the first live
    # reference at exactly that point (the samples repeat points too).
    same = (r[:, :, None, :] == q[:, None, :32, :]).all(-1)  # (B, M, 32)
    for k in (0, 1):
        live = (args[4 + k] == 0)[..., None] & same
        first = torch.argmax(live.to(torch.int8), dim=1)
        if not torch.equal(outs[4 + k][:, :32].long(), first):
            raise AssertionError("fused_nn_idx: exact duplicates not resolved to the lowest index")
    ms_idx = cuda_ms(lambda: pnn.fused_nn_idx(*args), iters=10)
    ms_min = cuda_ms(lambda: pnn.fused_nn(*args), iters=10)
    plain_ms = cuda_ms(lambda: pnn._fused_nn_plain(*args), iters=3, warmup=1)
    log(f"fused_nn B={BATCH} {n}x{m}: four mins within 1e-5*(|q|^2+|r|^2)+1e-6 "
        f"(max abs err: idx kernel {max(errs):.3e}, min kernel {max(min_errs):.3e}), "
        f"ties lowest-index, {flips} index "
        f"differences at near-ties; idx kernel {ms_idx:.4f} ms, min kernel "
        f"{ms_min:.4f} ms, plain {plain_ms:.4f} ms")
    pairs = BATCH * n * m
    io = BATCH * (n + m) * (12 + 8)  # coordinates and two penalties per point
    out_min = BATCH * (n + m) * 8  # two fp32 mins per point
    return dict(
        idx=dict(max_abs_err=max(errs), ms=ms_idx, plain_ms=plain_ms, library_ms=None,
                 **bound(io + 2 * out_min, pairs * FUSED_OPS_PER_PAIR)),
        min=dict(max_abs_err=max(min_errs), ms=ms_min, plain_ms=plain_ms, library_ms=None,
                 **bound(io + out_min, pairs * FUSED_OPS_PER_PAIR)),
    )


def phase_slice(device, clouds):
    import torch

    from himo_tpu_torch.models.feedforward import frame, init_params, make_model

    pc0, pc1, pch, valid, dt0, n_valid = clouds
    model, cfg = make_model("seflowpp", device=device, dtype="bfloat16")
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    log(f"seflowpp: grid {cfg.pillar.grid_shape}, pfn {cfg.point_feat_dim}, "
        f"base {cfg.base_channels}, depths {cfg.depths}, slots {cfg.instance_slots}, "
        f"refine {cfg.refine.num_query}x{cfg.refine.num_ref}, dtype {cfg.dtype}")
    frame(model, pc0, pc1, pch, valid, dt0)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()

    reset_counts()
    flow, comp_dis, refined = frame(model, pc0, pc1, pch, valid, dt0)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"launches in one batched forward: {launches}")
    expected = dict.fromkeys(launches, 0)
    expected.update(scatter_max_rows=3, nn_argmin_rows=10, nn_min_rows=1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")

    shape = (BATCH, NUM_POINTS, 3)
    for name, t in (("flow", flow), ("comp_dis", comp_dis), ("refined", refined)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise AssertionError(f"{name}: {tuple(t.shape)} {t.dtype}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")
    if not torch.equal(refined, pc0 + flow * (dt0 / 0.1)[..., None]):
        raise AssertionError("refined != pc0 + flow * dt0 / 0.1")
    if bool((flow[~valid] != 0).any()):
        raise AssertionError("padded points got a non-zero flow")

    with plain_kernels(), torch.inference_mode():
        ref_flow, aux = model((pc0, pc1, pch), (valid, valid, valid),
                              with_aux=True, dts=(dt0, dt0))
        ref_refined = pc0 + ref_flow * (dt0 / 0.1)[..., None]
    torch.cuda.synchronize()
    dist = (refined - ref_refined).norm(dim=-1)
    agree = float((dist <= SLICE_TOL_M).float().mean())
    far = dist > SLICE_TOL_M
    slots = aux["slot"]
    bidx, pidx = torch.nonzero(far, as_tuple=True)
    flipped = {(int(b), int(slots[b, p])) for b, p in zip(bidx.tolist(), pidx.tolist())}
    moved = float((ref_flow.abs().sum(-1) > 0).float().mean())
    log(f"kernels vs plain on the card: {agree:.6f} of points within {SLICE_TOL_M} m "
        f"(max {float(dist.max()):.6f} m); {int(far.sum())} points in "
        f"{len(flipped)} (frame, slot) groups differ; "
        f"{moved:.4f} of points have non-zero flow; "
        f"{int((slots >= 0).sum())} slotted points")
    if agree < SLICE_MIN_AGREE:
        raise AssertionError(f"only {agree:.4f} of refined points agree with the plain run")

    def run():
        frame(model, pc0, pc1, pch, valid, dt0)

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    median = float(np.median(times))
    mpts = BATCH * n_valid / median / 1e6
    log(f"forward + de-skew, {BATCH} frames: median {median * 1e3:.3f} ms over 5 "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times)}); {mpts:.4f} Mpts/s "
        f"(B*n_valid/time); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, run, median * 1e3


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (trace in us)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def port_kernel_pattern():
    """A regex for the trace names of the ``__global__`` functions of
    ``himo_tpu_torch/csrc/*.cu`` (each in a top-level anonymous namespace)."""
    from himo_tpu_torch.kernels import _build

    names = set()
    for path in _build.CSRC_DIR.glob("*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", path.read_text()))
    return re.compile(r"(void )?\(anonymous namespace\)::(" + "|".join(sorted(names)) + r")[<(]")


def phase_profile(name: str, fn, wall_ms: float) -> None:
    """Trace ``PROFILE_CALLS`` calls of a main path (already warm) under
    ``torch.profiler`` and print: the profiled wall time per call, the
    device busy time per call (the union of the trace's kernel, memcpy and
    memset intervals), the busy share of the profiled wall and of the
    path's unprofiled median ``wall_ms``, kernel launches per call, the
    kernels with the most device time, and the device time per launch of
    each of the port's own kernels."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(PROFILE_CALLS):
            fn()
            torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - start) * 1e3 / PROFILE_CALLS
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise AssertionError(f"{name}: the trace holds no device activity")
    busy = _busy_ms((e["ts"], e["ts"] + e["dur"]) for e in device) / PROFILE_CALLS
    by_name = {}
    for e in device:
        if e["cat"] == "kernel":
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    launches = sum(n for _, n in by_name.values()) / PROFILE_CALLS
    log(f"[profile {name}] wall {wall_ms:.3f} ms per call unprofiled; profiled wall "
        f"{prof_wall:.3f} ms, device busy {busy:.3f} ms (busy share {busy / prof_wall:.4f} "
        f"of the profiled wall, {busy / wall_ms:.4f} of the unprofiled); "
        f"{launches:.0f} kernel launches per call")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    port_kernel = port_kernel_pattern()
    for kname, (ms, n) in ranked[:PROFILE_TOP]:
        log(f"[profile {name}]   {ms / PROFILE_CALLS:9.3f} ms  {n / PROFILE_CALLS:6.0f} x  "
            f"{kname[:110]}")
    for kname, (ms, n) in ranked:
        if port_kernel.match(kname):
            log(f"[profile {name}] port kernel {ms / n * 1e3:9.3f} us per launch, "
                f"{n / PROFILE_CALLS:4.0f} x per call  {kname[:90]}")


def _grads(model):
    import torch

    return torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
        for p in model.parameters()
    ])


def phase_train(device):
    import torch

    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.training.trainer import (
        TrainConfig,
        make_optimizer,
        make_train_step,
        make_val_step,
        mean_losses,
    )

    config = TrainConfig()
    model, cfg = make_model(config.model, device=device, dtype="bfloat16")
    init_params(model, torch.Generator().manual_seed(0))
    batch = _train_batch(device, config)
    log(f"train: {config.model} {cfg.dtype}, B={config.batch_size} "
        f"N={config.num_points} K={config.loss_points}, lr {config.lr}, warmup "
        f"{config.warmup_steps} (capped), clip {config.grad_clip}, "
        f"steps_per_epoch {STEPS_PER_EPOCH}")

    def plain_reference():
        """Loss terms and gradients at the current parameters with every
        kernel replaced by its plain version (the first call also warms
        cuDNN and cuBLAS)."""
        with plain_kernels():
            model.zero_grad(set_to_none=True)
            terms = mean_losses(model, config, batch)
            terms["total"].backward()
        grads = _grads(model)
        model.zero_grad(set_to_none=True)
        return {k: float(v.detach()) for k, v in terms.items()}, grads

    optimizer, schedule = make_optimizer(model.parameters(), config, STEPS_PER_EPOCH)
    train_step = make_train_step(model, config, optimizer)
    expected = dict.fromkeys(read_counts(), 0)
    expected.update(scatter_max_rows=4, scatter_sum_rows=1, fused_nn_idx=1,
                    segment_rows_sum=3)
    totals = dict.fromkeys(expected, 0)
    times, peaks = [], []
    for step in range(TRAIN_STEPS):
        plain_terms, plain_grads = plain_reference()
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        m = train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        counts = read_counts()
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        if counts != expected:
            raise AssertionError(f"step {step + 1} launches {counts} != {expected}")
        for k, v in counts.items():
            totals[k] += v
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {step + 1}: non-finite metrics {m}")
        moved = max(float((p.detach() - b).abs().max())
                    for p, b in zip(model.parameters(), before))
        lr = schedule(step)
        if step == 0 and (lr != 0.0 or moved != 0.0):
            raise AssertionError(f"step 1: lr {lr}, parameters moved {moved}")
        if step > 0 and moved == 0.0:
            raise AssertionError(f"step {step + 1} (lr {lr}) left the parameters unchanged")
        # Kernels vs plain versions at this step's parameters. The kernel
        # gradients are clipped in place by now: compare the pre-clip norm
        # and the direction.
        worst = max(abs(m[k] - v) / max(abs(v), 1e-12) for k, v in plain_terms.items())
        norm = float(optimizer.last_grad_norm)
        plain_norm = float(plain_grads.norm())
        norm_rel = abs(norm - plain_norm) / plain_norm
        cosine = float(torch.nn.functional.cosine_similarity(
            _grads(model), plain_grads, dim=0))
        log(f"step {step + 1}: lr {lr:.3e}, max |param change| {moved:.3e}, "
            f"{times[-1] * 1e3:.3f} ms, total {m['total']:.6f}; kernels vs plain: "
            f"worst term rel diff {worst:.3e}, grad norm {norm:.6f} vs "
            f"{plain_norm:.6f} (rel {norm_rel:.3e}), cosine {cosine:.6f}")
        if step == 0:
            log("step 1 terms, kernels/plain: " + ", ".join(
                f"{k} {m[k]:.6f}/{plain_terms[k]:.6f}" for k in sorted(plain_terms)))
            if worst > TERM_RTOL or norm_rel > NORM_RTOL or cosine < MIN_COSINE:
                raise AssertionError(
                    f"step 1 through the kernels disagrees with the plain run (limits: "
                    f"terms {TERM_RTOL}, norm {NORM_RTOL}, cosine {MIN_COSINE})")
    peak = max(peaks)

    val_step = make_val_step(model, config)
    val_batch = _train_batch(device, config, with_gt=True)
    val_step(val_batch)  # warm-up of the no-grad forward
    reset_counts()
    out = val_step(val_batch)
    torch.cuda.synchronize()
    val_counts = read_counts()
    want_val = dict.fromkeys(val_counts, 0)
    want_val.update(scatter_max_rows=4, fused_nn=1)
    if val_counts != want_val:
        raise AssertionError(f"val step launches {val_counts} != {want_val}")
    out = {k: float(v) for k, v in out.items()}
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"val step: non-finite {out}")
    for k, v in val_counts.items():
        totals[k] += v

    median = float(np.median(times))
    median_warm = float(np.median(times[1:]))
    log(f"train step B={config.batch_size}: median {median * 1e3:.3f} ms over "
        f"{TRAIN_STEPS} ({', '.join(f'{t * 1e3:.3f}' for t in times)}); median of "
        f"steps 2-{TRAIN_STEPS} {median_warm * 1e3:.3f} ms; peak memory {peak:.2f} GiB; "
        f"val step total_sum {out['total_sum']:.6f} epe "
        f"{out['epe_sum'] / max(out['epe_count'], 1.0):.6f}")
    return totals, lambda: train_step(batch), median_warm * 1e3


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "himo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(himo_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device, smi = phase_device()
    phase_build()
    clouds = _clouds(device)
    scatter = phase_scatter(device, clouds)
    scatter_sum = phase_scatter_sum(device, clouds)
    segment = phase_segment_sum(device)
    nn = phase_nn(device)
    fused = phase_fused(device)
    torch.cuda.empty_cache()
    launches, run_frame, frame_ms = phase_slice(device, clouds)
    phase_profile("inference", run_frame, frame_ms)
    del clouds, run_frame
    torch.cuda.empty_cache()
    train, run_step, step_ms = phase_train(device)
    phase_profile("train_step", run_step, step_ms)
    del run_step
    total = {k: launches[k] + train[k] for k in launches}
    main_nn = NN_SHAPES[0]
    kernels = [
        dict(name="scatter_max_rows", route="cuda",
             source="himo_tpu_torch/csrc/scatter_max.cu",
             replaces="himo_tpu/ops/voxelize.py:334",
             launches=total["scatter_max_rows"], **scatter),
        dict(name="nn_argmin_rows", route="cuda", source="himo_tpu_torch/csrc/nn.cu",
             replaces="himo_tpu/ops/nn.py:168",
             launches=total["nn_argmin_rows"], **nn[main_nn]["argmin"]),
        dict(name="nn_min_rows", route="cuda", source="himo_tpu_torch/csrc/nn.cu",
             replaces="himo_tpu/ops/nn.py:77",
             launches=total["nn_min_rows"], **nn[main_nn]["min"]),
        dict(name="scatter_sum_rows", route="cuda",
             source="himo_tpu_torch/csrc/scatter_sum.cu",
             replaces="himo_tpu/ops/voxelize.py:334",
             launches=total["scatter_sum_rows"], **scatter_sum),
        dict(name="segment_rows_sum", route="cuda",
             source="himo_tpu_torch/csrc/scatter_sum.cu",
             replaces="himo_tpu/ops/voxelize.py:63",
             launches=total["segment_rows_sum"], **segment[SEGMENT_SHAPES[1]]),
        dict(name="fused_nn_idx", route="cuda", source="himo_tpu_torch/csrc/fused_nn.cu",
             replaces="himo_tpu/ops/nn.py:431",
             launches=total["fused_nn_idx"], **fused["idx"]),
        dict(name="fused_nn", route="cuda", source="himo_tpu_torch/csrc/fused_nn.cu",
             replaces="himo_tpu/ops/nn.py:431",
             launches=total["fused_nn"], **fused["min"]),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
