#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is ``seflowpp`` inference + de-skew (what ``bench.py`` times
for the JAX package): the full-width ``seflowpp`` network in bf16 on the
512x512 grid at 0.2 m, 8 frames x 65,536 points x 3 sweeps, then
``comp_dis = flow * dt0 / 0.1`` and ``refined = pc0 + comp_dis``. Weights
are random, from ``init_params`` with a seeded generator.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device — require CUDA; print the card's name and power limit;
2. build — compile ``himo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes, timed with CUDA events beside the plain version;
4. slice — the full forward through the kernels (launch counts checked:
   3 scatter_max, 10 nn_argmin, 1 nn_min), checked against the same
   forward with the plain versions on the card, and timed.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 8
NUM_POINTS = 65536
VALID_FRACTION = 0.92
SCATTER_CHANNELS = 32
NN_SHAPES = ((4096, 8192), (8192, 4096))  # ICP/null/score passes, claim pass
SLICE_TOL_M = 1e-3  # refined points, kernels vs plain versions
SLICE_MIN_AGREE = 0.99


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


@contextlib.contextmanager
def plain_kernels():
    """Route the three kernel wrappers to their plain PyTorch versions (the
    reference run on the card); restored on exit."""
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    saved = (pvox.scatter_max_rows, pnn.nn_argmin_rows, pnn.nn_min_rows)
    pvox.scatter_max_rows = pvox._scatter_max_rows_plain
    pnn.nn_argmin_rows = pnn._nn_argmin_plain
    pnn.nn_min_rows = pnn._nn_min_plain
    try:
        yield
    finally:
        pvox.scatter_max_rows, pnn.nn_argmin_rows, pnn.nn_min_rows = saved


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
    return torch.device("cuda", 0)


def phase_build():
    from himo_tpu_torch.kernels import _build

    for name in ("scatter_max", "nn"):
        start = time.perf_counter()
        path = _build.build(name)
        took = time.perf_counter() - start
        log(f"build {name}: {took:.2f} s -> {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")


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
    log(f"scatter_max B={BATCH} N={NUM_POINTS} C={SCATTER_CHANNELS} rows={rows} "
        f"trash={trash:.3f}: bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms)


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
        out[(n, m)] = dict(
            argmin=dict(max_abs_err=float(err[qv].max()), ms=ms_arg, plain_ms=plain_arg),
            min=dict(max_abs_err=float(err_min[qv].max()), ms=ms_min, plain_ms=plain_min),
        )
    return out


def phase_slice(device, clouds):
    import torch

    from himo_tpu_torch.models.feedforward import frame, init_params, make_model
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    pc0, pc1, pch, valid, dt0, n_valid = clouds
    model, cfg = make_model("seflowpp", device=device, dtype="bfloat16")
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    log(f"seflowpp: grid {cfg.pillar.grid_shape}, pfn {cfg.point_feat_dim}, "
        f"base {cfg.base_channels}, depths {cfg.depths}, slots {cfg.instance_slots}, "
        f"refine {cfg.refine.num_query}x{cfg.refine.num_ref}, dtype {cfg.dtype}")
    frame(model, pc0, pc1, pch, valid, dt0)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()

    counters = (pvox.scatter_max_rows, pnn.nn_argmin_rows, pnn.nn_min_rows)
    for fn in counters:
        fn.launches = 0
    flow, comp_dis, refined = frame(model, pc0, pc1, pch, valid, dt0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"launches in one batched forward: {launches}")
    expected = {"scatter_max_rows": 3, "nn_argmin_rows": 10, "nn_min_rows": 1}
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

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        frame(model, pc0, pc1, pch, valid, dt0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    median = float(np.median(times))
    mpts = BATCH * n_valid / median / 1e6
    log(f"forward + de-skew, {BATCH} frames: median {median * 1e3:.3f} ms over 5 "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times)}); {mpts:.4f} Mpts/s "
        f"(B*n_valid/time); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


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

    device = phase_device()
    phase_build()
    clouds = _clouds(device)
    scatter = phase_scatter(device, clouds)
    nn = phase_nn(device)
    launches = phase_slice(device, clouds)
    main_shape = NN_SHAPES[0]
    kernels = [
        dict(name="scatter_max", route="cuda",
             source="himo_tpu_torch/csrc/scatter_max.cu",
             replaces="himo_tpu/ops/voxelize.py:334",
             launches=launches["scatter_max_rows"], **scatter),
        dict(name="nn_argmin", route="cuda", source="himo_tpu_torch/csrc/nn.cu",
             replaces="himo_tpu/ops/nn.py:168",
             launches=launches["nn_argmin_rows"], **nn[main_shape]["argmin"]),
        dict(name="nn_min", route="cuda", source="himo_tpu_torch/csrc/nn.cu",
             replaces="himo_tpu/ops/nn.py:77",
             launches=launches["nn_min_rows"], **nn[main_shape]["min"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
