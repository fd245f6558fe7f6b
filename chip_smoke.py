#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Twelve main paths, at full width with random weights from seeded generators:

- ``seflowpp`` inference + de-skew (what ``bench.py`` times for the JAX
  package): the network in bf16 on the 512x512 grid at 0.2 m, 8 frames x
  65,536 points x 3 sweeps, then ``comp_dis = flow * dt0 / 0.1`` and
  ``refined = pc0 + comp_dis``;
- the ``seflowpp`` SSL train step (what ``scripts/chip_train_ab.py`` times
  for the JAX package): ``TrainConfig()`` (8 frames x 65,536 points, 16,384
  chamfer points, Adam with warmup and clip), bf16, on that script's batch;
  four optimizer steps, then one validation step;
- path A, the same inference and two train steps on the 256x256 grid at
  0.4 m (``bench.py``'s "256x256 throughput config"), where the pillar max
  and gather take the resident route (K3 max, K4, K3 sum);
- path B, the same inference and two train steps at 131,072 points per
  sweep on the 512x512 grid (one of the buckets the data pipeline pads
  dense multi-LiDAR superframes to), where the pillar max and the gather's backward take the
  stream route (K2 max and sum);
- ``pooling='mean_sorted'``: the same inference and two train steps on the
  512x512 headline's clouds, each sweep sorted by pillar id, pooled by a
  mean from K10 (``sorted_segment_sum``), the decoder's pillar features
  gathered by K11 (``sorted_segment_gather``), K11 and K10 each other's
  backward;
- the ``nsfp`` estimator through the registry, ``NSFPConfig(cluster_prior=
  False)`` (hidden 128, 8 layers, lr 8e-3, 500 Adam steps, 2 m truncation),
  once with the single-NN chamfer (``knn_k=0``) and once with the 4-NN
  smoothed chamfer (``knn_k=4``), on one frame pair of 65,536 points (92 %
  valid): ``lidar_like_cloud`` and the same cloud with its 16 object
  clusters moved 1.5 m (``data.synthetic.moving_objects_pair``);
- the ``fastnsf`` estimator on the same pair, ``FastNSFConfig(
  cluster_prior=False)`` (the 256 x 256 x 16 distance field, 500 steps);
- ``nsfp`` and ``fastnsf`` at the reference's defaults on the same pair:
  the host cluster prior (``models/nsfp.cluster_prior_flow``: HDBSCAN of
  both sweeps' dynamic points and ``icp_flow``'s matcher, numpy and scipy)
  seeds the 500-step optimisation, ``knn_k=0``;
- the ``icpflow`` estimator with ``ICPFlowConfig()`` on the same pair: host
  clustering and matching, then 12 registration iterations, each one K7
  launch over 32 clusters x 1,024 slots against the 65,536-point pc1;
- ``seflowpp_trust`` at 512x512, bf16, 8 frames x 65,536 points x 3 sweeps
  of ``moving_objects_pair`` scenes: each frame's host prior
  (``feedforward.frame_priors``), the forward + de-skew with it, and two
  train steps fed the prior as ``ssl_prior``;
- the training entry point end to end, ``himo_tpu_torch.cli.train.main``
  over scene files the port writes (3 scenes x 12 frames x 64,800 points)
  and labels with its SSL label writer (``training.ssl_labels.
  write_ssl_labels``): ``seflowpp`` bf16, batch 8, 65,536 points, one
  epoch, then a second run of two epochs that resumes from the first's
  checkpoint.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every ``himo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes, timed with CUDA events beside the plain version and, where
   one PyTorch call computes the same function, beside that call; the
   kernel and that call also by their traced device time (``device_ms``),
   since at small shapes CUDA events over back-to-back calls time the host;
   the pillar max (K1 max, K3 max) also split by pass, beside its
   flag-free decode (and both decodes at 1-8 channels), and bitwise on
   signed features; K2 max also bitwise on signed features and timed at
   C = 1 (the dynamic-image loss's max); K10 also at the train step's C =
   65 (its own row in the kernels line); K4 also at unclamped ids; K7 also
   at ``nsfp``'s shape (1 x 65,536 x 65,536) and at ``icpflow``'s (32
   clusters x 1,024 slots, some empty, x 65,536; ``phase_nn_icp``); K6, K7 and both K8 variants bitwise equal
   to their plain versions on quarter-metre grid coordinates, where every
   squared distance is exact in both forms, and K6 to K7's distances there
   (``phase_nn_grid``); then the host cost per call
   of every kernel wrapper, and of K3 sum's split by part, now and as its
   parent ran it (``phase_host_cost``);
4. slice: the full inference forward through the kernels (launch counts
   checked: 3 scatter_max_rows, 10 nn_argmin_rows, 1 nn_min_rows; path A
   3 scatter_max_resident_rows and 1 gather_rows instead of the first,
   path B 3 sorted_scatter_max_rows, mean_sorted 3 sorted_segment_sum and
   1 sorted_segment_gather), checked against the same forward with the
   plain versions on the card, and timed;
5. train: four steps through the kernels (launches checked per step:
   4 scatter_max_rows, 1 scatter_sum_rows, 1 fused_nn_idx, 3 segment_rows_sum,
   3 sorted_gather_rows, the scatter-max backward's take);
   before each, the same loss terms and gradients with the plain versions
   on the card, held against the step's (loss terms within 1e-4 relative,
   gradient norm within 1e-3, cosine >= 0.999; enforced at step 1, logged
   after); step 1 (lr 0) leaves the parameters unchanged and steps 2-4
   change them; one validation step (4 scatter_max_rows, 1 fused_nn); every
   metric finite; step times and peak memory. Paths A and B take two steps
   each the same way (path A per step: 4 scatter_max_resident_rows, 1
   gather_rows, 1 fused_nn_idx, 4 segment_rows_sum; path B: 4
   sorted_scatter_max_rows, 1 sorted_scatter_sum_rows, 1 fused_nn_idx, 3
   segment_rows_sum, 3 sorted_gather_rows); so does mean_sorted (1
   scatter_max_rows for the dynamic-image loss, 4 sorted_segment_sum, 4
   sorted_segment_gather, 1 fused_nn_idx, 4 segment_rows_sum);
6. nsfp, at ``knn_k`` 0 and 4: before the run, the step-1 loss and
   gradient through the kernels against the same through the plain
   versions on the card (loss within 1e-4 relative, at ``knn_k=4`` once
   the share carried by queries whose k-NN lists differ slot by slot is
   set aside; gradient norm within 1e-3, cosine >= 0.999) and the
   launches of one step (2 nn_argmin_rows,
   1 segment_rows_sum, plus 2 knn_rows at ``knn_k=4``); then the 500-step
   run (launch counts checked: 500 x one step's), final loss below the
   first, flow finite and zero on invalid points; time per step and per
   frame, peak memory, and the EPE of moving and static points against the
   known motion (printed only: random initialisation measures no quality);
7. fastnsf: the distance-field build timed alone, then the 500-step run
   (no launch of the port's kernels); the same loss and flow checks;
   then both at their defaults (``phase_opt_prior``): the host prior
   alone (host ms; finite, zero on invalid points, no launch; its coverage
   of the moving points and median error against the known motion), then
   each estimator (launches 500 x one step's for nsfp, none for fastnsf;
   final loss below the first; flow finite and zero on invalid points;
   the moving points' EPE beside the cold start's); then ``icpflow``
   (``phase_icpflow``: exactly 12 nn_argmin_rows launches; flow finite and
   zero on invalid points; the registration through the kernels against
   the plain versions, every filled slot within 1e-2 m; host ms and the
   registration's device ms); then ``seflowpp_trust``
   (``phase_trust``: the host prior per frame, slowest and sum, finite and
   zero on invalid points; the forward as in 4 with the prior, the same
   launches; two train steps as in 5 on the trust frames with the prior
   as ``ssl_prior``, the 512x512 step's launches);
8. profile: after each of the first two paths, three more calls of it
   under ``torch.profiler``, one call each of path A's, path B's and
   mean_sorted's inference and of path B's and mean_sorted's train step,
   one 20-step run each of ``nsfp`` at ``knn_k=4`` and of ``fastnsf``, and
   one call of the ``seflowpp_trust`` forward:
   device busy share, launches per call, the kernels with the most device
   time and each of the port's kernels' device time per launch;
9. train loop (``phase_train_loop``): the port's ``make_dataset`` writes
   the scenes into a temporary directory and ``write_ssl_labels`` labels
   them (host seconds per frame; every scene reads back with its datasets
   unchanged and the four ``ssl_*`` as written, in the reference's
   dtypes); ``cli.train.main`` runs one epoch
   (28 train frames: 3 steps, 8 val frames: 1 val step), then two epochs
   with ``resume``; checked: the resumed run starts at step 3 and ends at
   6, finite metrics, the checkpoints (``ckpts`` by ``val_total``,
   ``ckpts_latest``), the launches (6 train steps' and 2 val steps' as
   above) and every frame read back against the arrays written; printed:
   the host's ms per batch (``batch_iterator`` alone) and per frame (read,
   build), the train step in the loop (synchronized, first run) against
   the same step alone, the main thread's wait per batch, and the device
   busy share of the resumed run's epoch loop (traced).

Each path runs with every launch count set to 0 just before it and read
just after. The second-to-last line is a JSON object with one entry per
kernel entry point (``launches`` summed over the path runs) and one more
for K10 at C = 65 (the mean_sorted train steps' gather backwards, which
K10's wrapper counts by width; K10's own row counts its other widths); the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.

    python3 chip_smoke.py --host-cost ROOT

builds and times only the wrappers of the checkout at ROOT (host us per
call, one JSON line), so that two checkouts compare in one run.
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
GRID_256 = {"pillar.voxel_size": (0.4, 0.4)}  # path A: the 256x256 grid
BIG_POINTS = 131072  # path B: points per sweep (the stream route)
ROUTE_TRAIN_STEPS = 2  # train steps of paths A and B
SCATTER_CHANNELS = 32
DECODE_CHANNELS = (1, 2, 4, 8)  # the max kernel's two decodes, timed side by side
GATHER_CHANNELS = 65  # 64 UNet feature channels + the slot channel
MEAN_CHANNELS = 33  # mean_sorted's pooled rows: 32 PFN channels + the count
K10_STEP = f"sorted_segment_sum (C={GATHER_CHANNELS})"  # K10 in the step's backward
NN_SHAPES = ((4096, 8192), (8192, 4096))  # ICP/null/score passes, claim pass
NN_NSFP_SHAPE = (1, 65536, 65536)  # K7 in nsfp's chamfer: (frames, queries, refs)
ICP_SHAPE = (32, 1024, 65536)  # K7 in icpflow's registration: (clusters, slots, pc1)
ICP_ITERS = 12  # ICPFlowConfig().icp_iters: one K7 launch each
# The registration, kernels vs plain versions, every filled slot: where the
# two distance forms round a near-tie apart, one correspondence differs and
# the cluster's transform moves by millimetres over the 12 iterations.
ICP_TOL_M = 1e-2
SEGMENT_SHAPES = ((16384, 65536), (32768, 16384))  # take_rows bwd, fused bwd
FUSED_POINTS = 16384  # TrainConfig().loss_points
SLICE_TOL_M = 1e-3  # refined points, kernels vs plain versions
SLICE_MIN_AGREE = 0.99
TRAIN_STEPS = 4
STEPS_PER_EPOCH = 10
# Step-1 loss terms (train) and loss (nsfp), kernels vs plain versions: the
# plain versions' |q|^2 + |r|^2 - 2 q.r rounds at about ulp(|q|^2 + |r|^2),
# 5e-4 m^2 at 50 m, where nsfp's nearest distances are a few cm^2.
TERM_RTOL = 1e-4
NORM_RTOL = 1e-3  # step-1 gradient global norm
MIN_COSINE = 0.999  # step-1 gradients
PROFILE_CALLS = 3  # traced calls of each main path
HOST_CALLS, HOST_RUNS = 100, 10  # host cost: 1,000 calls per wrapper or part
HOST_POINTS, HOST_ROWS = 256, 1024  # the host-cost phase's tiny shapes
PROFILE_TOP = 12  # kernels listed by device time
NSFP_POINTS = 65536  # one frame pair of the optimisation estimators
NSFP_ITERS = 500  # NSFPConfig().iterations, FastNSFConfig().iterations
NSFP_PROFILE_ITERS = 20  # steps of the traced nsfp run
NSFP_SHIFT_M = 1.5  # object motion in the pair: 15 m/s over 0.1 s
KNN_K = 4
KNN_DUPLICATES = 64  # reference rows copied once more for the tie check
FASTNSF_DT = None  # FastNSFConfig().dt (a DTConfig) when None
LOOP_SCENES, LOOP_FRAMES = 3, 12  # the train loop's dataset: 36 frames
LOOP_BACKGROUND = 64000  # + 2 x 400 object points = 64,800 points a frame
LOOP_LABEL = "train_loop epoch"  # the profiler range of each train epoch
LOOP_ISOLATED_STEPS = 5
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


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # host-side API calls, with the
# CUPTI correlation id that ties a launch to its device event
SPLIT_LABEL = "device_split call "


def _trace_events(prof) -> list:
    """The complete events of a finished torch.profiler trace (chrome-trace
    dicts: ``name``, ``cat``, ``ts`` and ``dur`` in us, ``args``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _device_events(prof) -> list:
    """The kernel, memcpy and memset events of a finished torch.profiler trace."""
    return [e for e in _trace_events(prof) if e.get("cat") in DEVICE_CATS]


def short_name(name: str) -> str:
    """A trace event's kernel name without its namespace, template arguments
    and parameters (``Memset (Device)`` -> ``Memset``)."""
    bare = re.sub(r"^(void )?\(anonymous namespace\)::", "", name)
    return bare.split("<")[0].split("(")[0].strip()


def split_calls(events: list, calls: range) -> list:
    """The device events of each call in ``calls`` of a trace whose i-th
    call ran in a ``record_function`` range named ``SPLIT_LABEL + str(i)``.
    A device event belongs to the call of its launch, the host-side API
    call with the same correlation id: the call whose range is the last to
    start at or before the launch, where that range is not the one of call
    ``calls.stop``. The ranges are the host's; the trace also holds each on
    the device's timeline (``gpu_user_annotation``), which is ignored."""
    import bisect

    starts = sorted((e["ts"], int(e["name"][len(SPLIT_LABEL):])) for e in events
                    if e.get("name", "").startswith(SPLIT_LABEL)
                    and e.get("cat", "").lower() == "user_annotation")
    times = [t for t, _ in starts]
    call_of = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            at = bisect.bisect_right(times, e["ts"]) - 1
            if at >= 0 and starts[at][1] in calls:
                call_of[corr] = starts[at][1]
    per_call = {i: [] for i in calls}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            i = call_of.get(e.get("args", {}).get("correlation"))
            if i is not None:
                per_call[i].append(e)
    return [per_call[i] for i in calls]


def device_split(fn, iters: int = 20, lead: int = 2) -> dict:
    """Device milliseconds per call of ``fn`` (warm) by pass: the kernel,
    memset and memcpy durations of ``iters`` calls traced by torch.profiler,
    summed by :func:`short_name` and divided by the calls counted. The trace
    now and then lacks a device event (one in a trace of 20 one-kernel
    calls of the 1 x 65,536² NN argmin), so each call runs in a range of its
    own (:func:`split_calls`), ``lead`` untimed calls open the trace and one
    closes it, and a call with fewer device events than the most any timed
    call had is left out. At least half the calls must be whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(lead + iters + 1):
            with record_function(f"{SPLIT_LABEL}{i}"):
                fn()
        torch.cuda.synchronize()
    per_call = split_calls(_trace_events(prof), range(lead, lead + iters))
    most = max(len(c) for c in per_call)
    whole = [c for c in per_call if len(c) == most]
    if most == 0 or 2 * len(whole) < iters:
        raise AssertionError(f"device_split: device events per call {[len(c) for c in per_call]}"
                             f" in a trace of {iters} calls")
    if len(whole) < iters:
        log(f"device_split: {iters - len(whole)} of {iters} traced calls lacked a device "
            f"event and were left out")
    split = {}
    for call in whole:
        for e in call:
            name = short_name(e["name"])
            split[name] = split.get(name, 0.0) + e["dur"] / 1e3 / len(whole)
    return split


def device_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn`` (warm), every pass summed
    (:func:`device_split`). :func:`cuda_ms` times back-to-back calls, so
    where the host takes longer per call than the device it measures the
    host; this leaves out the gaps in which the device waits."""
    return sum(device_split(fn, iters).values())


def device_times(fn, library=None, iters: int = 20) -> dict:
    """``device_ms`` of a kernel wrapper call and of its library call (None
    where there is none), as the kernels line carries them."""
    return dict(device_ms=device_ms(fn, iters),
                library_device_ms=None if library is None else device_ms(library, iters))


def host_us(fn, calls: int = HOST_CALLS, runs: int = HOST_RUNS) -> float:
    """Host microseconds per call of ``fn``: ``time.perf_counter`` over
    ``runs`` runs of ``calls`` calls with no synchronise within a run. The
    device is drained between runs, outside the timing, so that a full
    launch queue never holds the host back."""
    import torch

    fn()
    total = 0.0
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        total += time.perf_counter() - start
    torch.cuda.synchronize()
    return total / (calls * runs) * 1e6


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _wrappers():
    from himo_tpu_torch.ops import knn as pknn
    from himo_tpu_torch.ops import mxu_scatter as pms
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    return {
        (pms, "sorted_segment_sum"): pms._sorted_segment_sum_plain,
        (pms, "sorted_segment_gather"): pms._sorted_segment_gather_plain,
        (pvox, "sorted_gather_rows"): pvox._sorted_gather_rows_plain,
        (pknn, "knn_rows"): pknn._knn_plain,
        (pvox, "scatter_max_rows"): pvox._scatter_max_rows_plain,
        (pvox, "scatter_max_resident_rows"): pvox._scatter_max_rows_plain,
        (pvox, "scatter_sum_rows"): pvox._scatter_sum_rows_plain,
        (pvox, "sorted_scatter_max_rows"): pvox._scatter_max_rows_plain,
        (pvox, "sorted_scatter_sum_rows"): pvox._scatter_sum_rows_plain,
        (pvox, "gather_rows"): pvox._gather_rows_plain,
        (pnn, "nn_argmin_rows"): pnn._nn_argmin_plain,
        (pnn, "nn_min_rows"): pnn._nn_min_plain,
        (pnn, "segment_rows_sum"): pnn._segment_rows_sum_plain,
        (pnn, "fused_nn"): lambda *a: pnn._fused_nn_plain(*a)[:4],
        (pnn, "fused_nn_idx"): pnn._fused_nn_plain,
    }


def reset_counts() -> None:
    from himo_tpu_torch.ops import mxu_scatter as pms

    for mod, name in _wrappers():
        getattr(mod, name).launches = 0
    pms.sorted_segment_sum.launches_by_c = {}


def read_counts() -> dict:
    """Each wrapper's launches since :func:`reset_counts`, K10's by width
    as its wrapper counts them: ``K10_STEP`` at C = 65, the train step's
    gather backward, and ``sorted_segment_sum`` at every other width."""
    from himo_tpu_torch.ops import mxu_scatter as pms

    counts = {name: getattr(mod, name).launches for mod, name in _wrappers()}
    by_c = pms.sorted_segment_sum.launches_by_c
    counts["sorted_segment_sum"] = sum(v for c, v in by_c.items() if c != GATHER_CHANNELS)
    counts[K10_STEP] = by_c.get(GATHER_CHANNELS, 0)
    return counts


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
        entry, spills = "", ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                log(f"    {entry}: {line.split(':', 1)[-1].strip()}; {spills}")


def _clouds(device, n=None):
    """(pc0, pc1, pc_hist, valid, dt0, n_valid): BATCH frames of ``n``
    points (NUM_POINTS when None) from ``lidar_like_cloud`` (seed 0), the
    first 92 % of each frame valid."""
    import torch

    from himo_tpu_torch.data.synthetic import lidar_like_cloud

    n = NUM_POINTS if n is None else n
    rng = np.random.default_rng(0)
    pc0, pc1, pch = (
        torch.from_numpy(lidar_like_cloud(rng, BATCH, n)).to(device)
        for _ in range(3)
    )
    n_valid = int(n * VALID_FRACTION)
    valid = (torch.arange(n, device=device) < n_valid)[None].repeat(BATCH, 1)
    dt0 = torch.from_numpy(
        rng.uniform(0, 0.1, size=(BATCH, n)).astype(np.float32)
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


def _pillar_ids(clouds, voxel_size=None):
    """The first sweep's (B, N) pillar ids on the default grid, or at
    ``voxel_size``, and the row count."""
    from himo_tpu_torch.ops import voxelize as pvox

    pc0, _, _, valid, _, _ = clouds
    cfg = pvox.PillarConfig() if voxel_size is None else pvox.PillarConfig(
        voxel_size=voxel_size)
    return pvox.voxelize_pillars(pc0, valid, cfg).pillar_ids.contiguous(), cfg.num_pillars


def _relu_feats(device, shape, seed):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.relu(torch.randn(*shape, device=device, generator=gen))


def _sparse_cotangents(device, shape, seed):
    """Normal values with half of them zero (the cotangents of ReLU'd
    pillar features)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn(*shape, device=device, generator=gen)
    return torch.where(torch.rand(vals.shape, device=device, generator=gen) < 0.5,
                       vals, torch.zeros_like(vals))


def _reduce_bound(pids, rows, c, stream):
    """Bound of a per-row reduce of (B, N, c) values into (B, rows, c): the
    values of points with an id below ``rows`` read once, every id read
    once (a sorted ``stream`` only up to its first trash id), the table
    written once; one fp32 operation per value read."""
    b, n = pids.shape
    live = int((pids < rows).sum())
    return bound((live if stream else b * n) * 4 + live * c * 4 + b * rows * c * 4,
                 live * c)


def _bitwise(name, got, want) -> None:
    """Raise unless a kernel's fp32 output equals its plain version's bit for
    bit."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"{name} kernel differs from plain in {bad} values")


def _check_max(name, fn, plain, pids, feats, rows, stream=False):
    """Hold a per-row max kernel ``fn(pids, feats, rows)`` bitwise against
    its plain version; time both and ``torch.zeros`` + ``scatter_reduce_``
    amax on the same inputs (a new table, unreached rows 0, as the
    wrapper); split the kernel's device time by pass."""
    import torch

    b, n, c = feats.shape
    trash = float((pids >= rows).float().mean())
    got = fn(pids, feats, rows)
    want = plain(pids, feats, rows)
    _bitwise(name, got, want)
    ms = cuda_ms(lambda: fn(pids, feats, rows))
    plain_ms = cuda_ms(lambda: plain(pids, feats, rows))
    flat = _flat_rows(pids, rows)[:, None].expand(-1, c)
    src = feats.reshape(-1, c)

    def library():
        return torch.zeros(b * rows + 1, c, device=feats.device).scatter_reduce_(
            0, flat, src, "amax", include_self=False)

    library_ms = cuda_ms(library)
    split = device_split(lambda: fn(pids, feats, rows))
    dev = dict(device_ms=sum(split.values()), library_device_ms=device_ms(library))
    log(f"{name} B={b} N={n} C={c} rows={rows} trash={trash:.3f}: bitwise equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_reduce_ amax {library_ms:.4f} ms; "
        f"device {dev['device_ms']:.4f} / {dev['library_device_ms']:.4f} ms; kernel's "
        f"device ms by pass: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **dev, **_reduce_bound(pids, rows, c, stream))


def _check_signed_max(name, fn, pids, rows):
    """Hold a per-row max kernel ``fn(pids, feats, rows)`` bitwise against
    its plain version on signed features: (B, N, 32) normal values, a tenth
    of them -0.0 and a thousandth -inf (ReLU'd features never reach the
    keys of negative floats); a row reached only by -0.0 reads +0.0, and so
    does a max of -inf."""
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    b, n = pids.shape
    gen = torch.Generator(device=pids.device).manual_seed(9)
    feats = torch.randn(b, n, SCATTER_CHANNELS, device=pids.device, generator=gen)
    draw = torch.rand(feats.shape, device=pids.device, generator=gen)
    feats = torch.where(draw < 0.1, torch.full_like(feats, -0.0), feats)
    feats = torch.where(draw > 0.999, torch.full_like(feats, float("-inf")), feats)
    want = pvox._scatter_max_rows_plain(pids, feats, rows)
    _bitwise(f"{name} (signed)", fn(pids, feats, rows), want)
    log(f"{name} B={b} N={n} C={SCATTER_CHANNELS} rows={rows}, signed features, "
        f"{float((draw < 0.1).float().mean()):.3f} of them -0.0, "
        f"{float((draw > 0.999).float().mean()):.4f} -inf: bitwise equal; "
        f"{float((want < 0).float().mean()):.4f} of cells hold a negative max")


def _check_decode(name, pids, feats, rows, flagged):
    """The max kernel with the decode ``flagged`` picks (the table of
    reached rows, or every word of the image read once more) whatever the
    channel count: bitwise against the plain version, its device time split
    by pass."""
    from himo_tpu_torch.ops import voxelize as pvox

    def fn():
        return pvox._run_max_kernel(pids, feats, rows, flagged=flagged)

    kind = "flagged" if flagged else "flag-free"
    _bitwise(f"{name} ({kind} decode)", fn(), pvox._scatter_max_rows_plain(pids, feats, rows))
    split = device_split(fn)
    log(f"{name} C={feats.shape[2]} {kind} decode: bitwise equal; device "
        f"{sum(split.values()):.4f} ms; by pass: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))


def phase_scatter(device, clouds):
    """K1 max: the 512x512 pillar pool, (B, N, 32) ReLU'd features at the
    main path's pillar ids (timed; the flag-free decode too), then signed
    ones (bitwise only); then both decodes at the few channels around the
    wrappers' switch (the dynamic-image loss's max has C = 1)."""
    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(clouds)
    feats = _relu_feats(device, (BATCH, NUM_POINTS, SCATTER_CHANNELS), 1)
    out = _check_max("scatter_max_rows", pvox.scatter_max_rows,
                     pvox._scatter_max_rows_plain, pids, feats, rows)
    _check_decode("scatter_max_rows", pids, feats, rows, flagged=False)
    _check_signed_max("scatter_max_rows", pvox.scatter_max_rows, pids, rows)
    for c in DECODE_CHANNELS:
        few = _relu_feats(device, (BATCH, NUM_POINTS, c), 7)
        for flagged in (True, False):
            _check_decode("scatter_max_rows", pids, few, rows, flagged)
    return out


def phase_scatter_resident(device, clouds):
    """K3 max: path A's 256x256 pillar pool, the same features at the
    256x256 pillar ids (timed; the flag-free decode too), then signed ones
    (bitwise only)."""
    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(clouds, GRID_256["pillar.voxel_size"])
    feats = _relu_feats(device, (BATCH, NUM_POINTS, SCATTER_CHANNELS), 1)
    out = _check_max("scatter_max_resident_rows", pvox.scatter_max_resident_rows,
                     pvox._scatter_max_rows_plain, pids, feats, rows)
    _check_decode("scatter_max_resident_rows", pids, feats, rows, flagged=False)
    _check_signed_max("scatter_max_resident_rows", pvox.scatter_max_resident_rows, pids, rows)
    return out


def _check_sum(name, got, want, mag):
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 1e-5 * mag + 1e-6).all()):
        raise AssertionError(f"{name}: |kernel - plain| above 1e-5*sum|x|+1e-6 "
                             f"(max {float(err.max())})")
    return float(err.max())


def _check_sum_kernel(name, fn, plain, ids, vals, rows, stream=False):
    """Hold a per-row sum kernel ``fn(ids, vals, rows)`` against its plain
    version within 1e-5 * sum|x| + 1e-6; time both and ``torch.zeros`` +
    ``index_add_`` on the same inputs (a new zeroed table, as the
    wrapper)."""
    import torch

    b, n, c = vals.shape
    got = fn(ids, vals, rows)
    want = plain(ids, vals, rows)
    mag = plain(ids, vals.abs(), rows)
    err = _check_sum(name, got, want, mag)
    del got, want, mag
    ms = cuda_ms(lambda: fn(ids, vals, rows))
    plain_ms = cuda_ms(lambda: plain(ids, vals, rows))
    flat = _flat_rows(ids, rows)
    src = vals.reshape(-1, c)

    def library():
        return torch.zeros(b * rows + 1, c, device=vals.device).index_add_(0, flat, src)

    library_ms = cuda_ms(library)
    dev = device_times(lambda: fn(ids, vals, rows), library)
    log(f"{name} B={b} N={n} C={c} rows={rows}: within 1e-5*sum|x|+1e-6 "
        f"(max abs err {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_add_ {library_ms:.4f} ms; device {dev['device_ms']:.4f} / "
        f"{dev['library_device_ms']:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **dev,
                **_reduce_bound(ids, rows, c, stream))


def phase_scatter_sum(device, clouds):
    """K1 sum: the 512x512 gather_pillars backward, (B, N, 65) fp32 into
    (B, 512^2, 65), at the pillar ids of the main path's cloud."""
    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(clouds)
    vals = _sparse_cotangents(device, (BATCH, NUM_POINTS, GATHER_CHANNELS), 2)
    return _check_sum_kernel("scatter_sum_rows", pvox.scatter_sum_rows,
                             pvox._scatter_sum_rows_plain, pids, vals, rows)


def phase_gather(device, clouds):
    """K4: path A's pillar gather, a (B, 256^2, 65) fp32 image at the
    256x256 pillar ids clamped to the last row (the rows the kernel reads);
    bitwise against the plain version, beside ``index_select`` of the
    flattened rows (the flat index made beforehand); then bitwise at the
    unclamped ids, as gather_pillars passes them (the trash id ``rows``,
    which the kernel clamps)."""
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(clouds, GRID_256["pillar.voxel_size"])
    ids = torch.clamp(pids, max=rows - 1)
    gen = torch.Generator(device=device).manual_seed(3)
    image = torch.randn(BATCH, rows, GATHER_CHANNELS, device=device, generator=gen)
    table = image.reshape(-1, GATHER_CHANNELS)
    flat = _flat_rows(ids, rows)
    out = _check_gather("gather_rows", pvox.gather_rows, pvox._gather_rows_plain,
                        (image, ids), ids, lambda: torch.index_select(table, 0, flat))
    _bitwise("gather_rows (unclamped ids)", pvox.gather_rows(image, pids),
             pvox._gather_rows_plain(image, pids))
    log(f"gather_rows at the unclamped ids ({float((pids >= rows).float().mean()):.3f} "
        f"at the trash id {rows}): bitwise equal")
    return out


def _log_runs(spids, rows):
    """The shape of a sorted stream's runs, which K2 and K10 work over: the
    share of rows they reach, points per run (mean and most), and each
    frame's rows before its first and after its last reached row (the
    largest of each over the frames)."""
    import torch

    b = spids.shape[0]
    ids = spids.to(torch.int64)
    live = ids < rows
    key = (torch.arange(b, device=ids.device)[:, None] * rows + ids)[live]
    counts = torch.unique_consecutive(key, return_counts=True)[1]
    big = torch.iinfo(torch.int64).max
    head = torch.where(live, ids, torch.full_like(ids, big)).amin(1)
    tail = rows - 1 - torch.where(live, ids, torch.full_like(ids, -1)).amax(1)
    log(f"sorted stream B={b} N={spids.shape[1]} rows={rows}: runs reach "
        f"{counts.numel() / (b * rows):.4f} of the rows, {float(counts.float().mean()):.4f} "
        f"points per run (most {int(counts.max())}); largest head gap {int(head.max())} "
        f"rows, tail gap {int(tail.max())}")


def phase_sorted(device, big):
    """K2 at path B's shapes: the 512x512 pillar ids of the 131,072-point
    clouds, sorted as the stream route sorts them (stable); the max of
    (B, N, 32) ReLU'd features (timed and split by pass), of signed ones
    (bitwise only) and of the dynamic-image loss's (B, N, 1) values, 0 or 1
    (timed); the sum of (B, N, 65) cotangents. The sum must also be
    bitwise equal from launch to launch. Beside them, at equal work: the
    sort itself, and the table route's atomic kernels (K1) on the same
    points unsorted."""
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(big)
    n = pids.shape[1]
    feats = _relu_feats(device, (BATCH, n, SCATTER_CHANNELS), 4)
    spids, sfeats = pvox._sort_rows(pids, feats)
    _log_runs(spids, rows)
    out_max = _check_max("sorted_scatter_max_rows", pvox.sorted_scatter_max_rows,
                         pvox._scatter_max_rows_plain, spids, sfeats, rows, stream=True)
    _check_signed_max("sorted_scatter_max_rows", pvox.sorted_scatter_max_rows, spids, rows)
    gen = torch.Generator(device=device).manual_seed(13)
    positive = (torch.rand(BATCH, n, 1, device=device, generator=gen) < 0.3).float()
    _, spositive = pvox._sort_rows(pids, positive)
    out_c1 = _check_max("sorted_scatter_max_rows", pvox.sorted_scatter_max_rows,
                        pvox._scatter_max_rows_plain, spids, spositive, rows, stream=True)
    del positive, spositive
    sort_max = cuda_ms(lambda: pvox._sort_rows(pids, feats))
    k1_max = cuda_ms(lambda: pvox.scatter_max_rows(pids, feats, rows))
    del feats, sfeats
    vals = _sparse_cotangents(device, (BATCH, n, GATHER_CHANNELS), 5)
    _, svals = pvox._sort_rows(pids, vals)
    out_sum = _check_sum_kernel("sorted_scatter_sum_rows", pvox.sorted_scatter_sum_rows,
                                pvox._scatter_sum_rows_plain, spids, svals, rows,
                                stream=True)
    first = pvox.sorted_scatter_sum_rows(spids, svals, rows)
    again = pvox.sorted_scatter_sum_rows(spids, svals, rows)
    plain = pvox._scatter_sum_rows_plain(spids, svals, rows)
    torch.cuda.synchronize()
    if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("sorted_scatter_sum_rows differs from launch to launch")
    vs_plain = "bitwise equal to" if torch.equal(first, plain) else "not bitwise equal to"
    del first, again, plain
    sort_sum = cuda_ms(lambda: pvox._sort_rows(pids, vals))
    k1_sum = cuda_ms(lambda: pvox.scatter_sum_rows(pids, vals, rows))
    log(f"sorted_scatter_sum_rows: bitwise equal from launch to launch, {vs_plain} "
        f"the plain version on the card (index_add_'s atomics)")
    log(f"sorted_scatter_max_rows at C=1 (the dynamic-image loss's max): kernel "
        f"{out_c1['ms']:.4f} ms, device {out_c1['device_ms']:.4f} ms, bound "
        f"{out_c1['bound_ms']:.4f} ms")
    log(f"at equal work, B={BATCH} N={n} rows={rows}: max C={SCATTER_CHANNELS} sorted "
        f"kernel {out_max['ms']:.4f} ms + stable sort {sort_max:.4f} ms vs atomic "
        f"scatter_max_rows {k1_max:.4f} ms; sum C={GATHER_CHANNELS} sorted kernel "
        f"{out_sum['ms']:.4f} ms + stable sort {sort_sum:.4f} ms vs atomic "
        f"scatter_sum_rows {k1_sum:.4f} ms")
    return out_max, out_sum


def phase_sorted_sum(device, clouds):
    """K10 at the mean_sorted path's shapes: the 512x512 pillar ids of the
    main path's first sweep, sorted as the model sorts them (stable; the
    runs' shape logged), and (B, N, 33) values (32 features and the count;
    normal values, half of them zero, not bf16 values, so that the rounding
    shows), with the rounding flag off and on, each bitwise from launch to
    launch. The flag on is the path's (bf16). Then the train step's width:
    (B, N, 65) cotangents at the same ids (the backward of the pooled
    gather), rounding on. Returns the kernels line's rows at C = 33 and 65,
    both with the rounding on."""
    import torch

    from himo_tpu_torch.ops import mxu_scatter as pms
    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(clouds)
    vals = _sparse_cotangents(device, (BATCH, NUM_POINTS, MEAN_CHANNELS), 6)
    spids, svals = pvox._sort_rows(pids, vals)
    del vals
    _log_runs(spids, rows)
    cot = _sparse_cotangents(device, (BATCH, NUM_POINTS, GATHER_CHANNELS), 7)
    _, scot = pvox._sort_rows(pids, cot)
    del cot
    out = {}
    for c, bf16, values in ((MEAN_CHANNELS, False, svals), (MEAN_CHANNELS, True, svals),
                            (GATHER_CHANNELS, True, scot)):
        name = f"sorted_segment_sum C={c} bf16={int(bf16)}"

        def fn(i, v, r, _b=bf16):
            return pms.sorted_segment_sum(i, v, r, _b)

        def plain(i, v, r, _b=bf16):
            return pms._sorted_segment_sum_plain(i, v, r, _b)

        out[c, bf16] = _check_sum_kernel(name, fn, plain, spids, values, rows, stream=True)
        first, again = fn(spids, values, rows), fn(spids, values, rows)
        torch.cuda.synchronize()
        if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{name} differs from launch to launch")
        log(f"{name}: bitwise equal from launch to launch")
    return out[MEAN_CHANNELS, True], out[GATHER_CHANNELS, True]


def _check_gather(name, fn, plain, args, ids, library):
    """Hold a row gather ``fn(image, ids, ...)`` bitwise against its plain
    version; time both and the ``library`` call. Bound: the (B, N) id
    tensors among ``args`` read once, the image rows the ids reach read
    once, the output written once."""
    import torch

    image = args[0]
    b, rows, c = image.shape
    n = ids.shape[1]
    got = fn(*args)
    want = plain(*args)
    _bitwise(name, got, want)
    ms = cuda_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = cuda_ms(library)
    dev = device_times(lambda: fn(*args), library)
    flat = _flat_rows(ids, rows)
    reached = int(torch.unique(flat[flat < b * rows]).numel())
    id_tensors = sum(1 for a in args[1:] if torch.is_tensor(a))
    lower = bound(b * n * 4 * id_tensors + reached * c * 4 + b * n * c * 4, 0)
    log(f"{name} B={b} N={n} C={c} rows={rows} ids past the grid "
        f"{float((ids >= rows).float().mean()):.3f}, reached rows {reached / (b * rows):.3f}: "
        f"bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms; device {dev['device_ms']:.4f} / "
        f"{dev['library_device_ms']:.4f} ms; bound {lower['bound_ms']:.4f} ms")
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **dev, **lower)


def phase_sorted_gathers(device, clouds, big):
    """K11 at the mean_sorted path's gathers: a (B, 512^2, 65) fp32 image
    (the forward's) and a (B, 512^2, 33) one (K10's backward, 3 of the 4
    launches of a train step) at the main path's first sweep's sorted
    512x512 ids (8 % past the grid, the padded points), flag off and on
    (the path's), beside ``index_select`` of the flat rows with one zero
    row appended for ids past the grid (the appended table made
    beforehand); the forward's shape with the flag on is the kernels line's.
    K5 at the 512x512
    train step's take: a (B, 512^2, 64) (cotangent, max) image at the same
    ids, read in sorted order and written back through the stable sort's
    order, beside ``index_select`` of the flat rows at the unsorted ids (the
    plain take it replaces) and the stable argsort the table route runs for
    it; then K5 at path B's 131,072 points."""
    import torch

    from himo_tpu_torch.ops import mxu_scatter as pms
    from himo_tpu_torch.ops import voxelize as pvox

    pids, rows = _pillar_ids(clouds)
    spids, order = pvox._stable_sort(pids)
    gen = torch.Generator(device=device).manual_seed(7)

    def image_and_table(c):
        """A (B, rows, c) normal image and its flat rows with one zero row
        appended (index B * rows, where ``_flat_rows`` sends ids past the
        grid): the library calls' table."""
        image = torch.randn(BATCH, rows, c, device=device, generator=gen)
        return image, torch.cat([image.reshape(-1, c), image.new_zeros(1, c)])

    flat = _flat_rows(spids, rows)
    k11 = {}
    for c in (MEAN_CHANNELS, GATHER_CHANNELS):
        image, table = image_and_table(c)
        for bf16 in (False, True):  # the path's flag (bf16) last
            k11[c] = _check_gather(
                f"sorted_segment_gather bf16={int(bf16)}",
                lambda im, i, _b=bf16: pms.sorted_segment_gather(im, i, _b),
                lambda im, i, _b=bf16: pms._sorted_segment_gather_plain(im, i, _b),
                (image, spids), spids, lambda: torch.index_select(table, 0, flat))
        del image, table

    image, table = image_and_table(2 * SCATTER_CHANNELS)
    flat = _flat_rows(pids, rows)
    k5 = _check_gather("sorted_gather_rows", pvox.sorted_gather_rows,
                       pvox._sorted_gather_rows_plain, (image, spids, order), pids,
                       lambda: torch.index_select(table, 0, flat))
    sort_ms = cuda_ms(lambda: pvox._stable_sort(pids))
    bpids, _ = _pillar_ids(big)
    bsorted, border = pvox._stable_sort(bpids)
    bflat = _flat_rows(bpids, rows)
    _check_gather(f"sorted_gather_rows (path B, {bpids.shape[1]} points)",
                  pvox.sorted_gather_rows, pvox._sorted_gather_rows_plain,
                  (image, bsorted, border), bpids, lambda: torch.index_select(table, 0, bflat))
    big_sort_ms = cuda_ms(lambda: pvox._stable_sort(bpids))
    log(f"sorted_gather_rows: the table route's stable argsort of the ids "
        f"{sort_ms:.4f} ms ({NUM_POINTS} points), {big_sort_ms:.4f} ms "
        f"({bpids.shape[1]} points; the stream route reuses its forward's)")
    return k11[GATHER_CHANNELS], k5


def phase_segment_sum(device):
    """K3 sum at both train-step shapes: take_rows' backward (16,384 rows
    of 3 into 65,536) and the fused NN backward (32,768 into 16,384). At
    these shapes CUDA events over back-to-back calls time the host's work
    per call as much as the device's, so each call, and ``torch.zeros`` +
    ``index_add_``, is also timed by the device alone (``device_ms``:
    kernels plus memsets per call, from a trace of the same loop)."""
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

        def library():  # a new zeroed table, as the wrapper returns
            return torch.zeros(BATCH * rows + 1, 3, device=device).index_add_(0, flat, src)

        library_ms = cuda_ms(library, iters=50)
        dev = device_times(lambda: pnn.segment_rows_sum(vals, ids, rows), library, iters=50)
        log(f"segment_rows_sum B={BATCH} {n}x3 -> {rows}: within 1e-5*sum|x|+1e-6 "
            f"(max abs err {err:.3e}); events per call: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, zeros + index_add_ {library_ms:.4f} ms; device per call "
            f"(kernels + memsets): kernel {dev['device_ms'] * 1e3:.3f} us, zeros + "
            f"index_add_ {dev['library_device_ms'] * 1e3:.3f} us")
        pts = BATCH * n
        out[(n, rows)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, **dev,
                              **bound(pts * 4 + pts * 12 + BATCH * rows * 12, pts * 3))
    return out


def wrapper_host_us(device) -> dict:
    """Host microseconds per call (:func:`host_us`) of every kernel wrapper
    at a tiny shape: 1 frame of HOST_POINTS points into HOST_ROWS rows (32
    channels for the maxes, 65 for the gathers, 33 for K10, 3 for the sums
    and clouds), where the device needs a few microseconds per launch and
    the host's work is what a caller waits for. Only the wrappers' public
    signatures are used, so that ``--host-cost ROOT`` times an earlier
    checkout's wrappers the same way."""
    import torch

    from himo_tpu_torch.ops import knn as pknn
    from himo_tpu_torch.ops import mxu_scatter as pms
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    gen = torch.Generator(device=device).manual_seed(11)
    n, rows = HOST_POINTS, HOST_ROWS

    def normal(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    ids = torch.randint(0, rows + 8, (1, n), device=device, generator=gen,
                        dtype=torch.int32).sort(dim=1).values.contiguous()  # sorted
    order = torch.randperm(n, device=device, generator=gen).to(torch.int32)[None].contiguous()
    v3, v32, v33, image = normal(1, n, 3), normal(1, n, 32), normal(1, n, 33), normal(1, rows, 65)
    q, r = normal(1, n, 3) * 10, normal(1, n, 3) * 10
    pen = torch.zeros(1, n, device=device)
    calls = {
        "scatter_max_rows": lambda: pvox.scatter_max_rows(ids, v32, rows),
        "scatter_max_resident_rows": lambda: pvox.scatter_max_resident_rows(ids, v32, rows),
        "scatter_sum_rows": lambda: pvox.scatter_sum_rows(ids, v3, rows),
        "sorted_scatter_max_rows": lambda: pvox.sorted_scatter_max_rows(ids, v32, rows),
        "sorted_scatter_sum_rows": lambda: pvox.sorted_scatter_sum_rows(ids, v3, rows),
        "gather_rows": lambda: pvox.gather_rows(image, ids),
        "sorted_gather_rows": lambda: pvox.sorted_gather_rows(image, ids, order),
        "segment_rows_sum": lambda: pnn.segment_rows_sum(v3, ids, rows),
        "nn_min_rows": lambda: pnn.nn_min_rows(q, r),
        "nn_argmin_rows": lambda: pnn.nn_argmin_rows(q, r),
        "fused_nn": lambda: pnn.fused_nn(q, r, pen, pen, pen, pen),
        "fused_nn_idx": lambda: pnn.fused_nn_idx(q, r, pen, pen, pen, pen),
        "knn_rows": lambda: pknn.knn_rows(q, r, KNN_K),
        "sorted_segment_sum": lambda: pms.sorted_segment_sum(ids, v33, rows, True),
        "sorted_segment_gather": lambda: pms.sorted_segment_gather(image, ids, True),
    }
    return {name: host_us(fn) for name, fn in calls.items()}


def _parent_rows_checks(name, ids, vals):
    """The row wrappers' argument checks as the parent of the launch helper
    ran them (``ops.voxelize._check_rows_args`` before it), for the host-cost
    replay."""
    import torch

    if vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"{name}: {vals.dtype} / {ids.dtype}")
    if not (vals.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if vals.dim() != 3 or ids.shape != vals.shape[:2]:
        raise ValueError(f"shapes {tuple(ids.shape)} / {tuple(vals.shape)}")
    if ids.device != vals.device:
        raise ValueError("ids and values on different devices")


def phase_host_cost(device):
    """The kernel wrappers' host work per call. First every wrapper whole
    (:func:`wrapper_host_us`). Then K3 sum's wrapper at the fused NN
    backward's shape split by part (checks, allocation, binding, stream,
    the ctypes call), as it runs now and as its parent ran it, replayed
    step by step: the earlier checks, ``torch.zeros``, a signature dict
    built and walked per call as the parent's ``_build.load`` did, and a
    ``torch.cuda.Stream`` object per call. The replay's ctypes call goes to
    today's entry point, which also zeroes the table (the parent's did
    not). Last, the raw stream handle the launch helper reads is held
    against ``torch.cuda.current_stream`` outside and inside a side
    stream, and a launch inside the side stream against the plain version."""
    import ctypes

    import torch

    from himo_tpu_torch.kernels import _build
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    whole = wrapper_host_us(device)
    log("host us per call, every wrapper (1 frame, "
        f"{HOST_POINTS} points, {HOST_ROWS} rows): "
        + ", ".join(f"{k} {v:.2f}" for k, v in whole.items()))
    n, rows = SEGMENT_SHAPES[1]
    gen = torch.Generator(device=device).manual_seed(12)
    ids = torch.randint(0, rows, (BATCH, n), device=device, generator=gen, dtype=torch.int32)
    vals = torch.randn(BATCH, n, 3, device=device, generator=gen)
    b, c = BATCH, 3
    entry = pvox._SCATTER_SUM
    fn = entry.bind()
    raw = torch._C._cuda_getCurrentRawStream
    index = vals.get_device()
    out = torch.empty((b, rows, c), device=device)
    stream = raw(index)
    stream_arg = ctypes.c_void_p(stream)  # as the parent's stream part gave it
    name = entry.name
    loaded, bound = {"scatter_sum": _build.library("scatter_sum")}, {("scatter_sum", name)}

    def parent_binding():
        signatures = {name: pvox._ROWS_ARGTYPES + (_build.PTR,)}
        lib = loaded.get("scatter_sum")
        for fn_name, _ in signatures.items():
            if ("scatter_sum", fn_name) in bound:
                continue
        return getattr(lib, name)

    def parent_stream():
        return ctypes.c_void_p(torch.cuda.current_stream(vals.device).cuda_stream)

    def parent_call():
        if vals.device.type == "cpu":
            raise AssertionError("not on the card")
        _parent_rows_checks(name, ids, vals)
        table = torch.zeros((b, rows, c), dtype=torch.float32, device=vals.device)
        code = parent_binding()(ids.data_ptr(), vals.data_ptr(), table.data_ptr(), b, n, c,
                                rows, parent_stream())
        _build.check(code, name)
        return table

    parts = {
        "after": {
            "checks": lambda: pvox._check_rows_args(name, ids, vals),
            "allocation": lambda: vals.new_empty((b, rows, c)),
            "binding": lambda: entry._fn or entry.bind(),
            "stream": lambda: raw(index),
            "ctypes call": lambda: fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(), b, n,
                                      c, rows, stream),
            "whole call": lambda: pnn.segment_rows_sum(vals, ids, rows),
        },
        "before (replayed)": {
            "checks": lambda: _parent_rows_checks(name, ids, vals),
            "allocation": lambda: torch.zeros((b, rows, c), dtype=torch.float32,
                                              device=vals.device),
            "binding": parent_binding,
            "stream": parent_stream,
            "ctypes call": lambda: fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(), b, n,
                                      c, rows, stream_arg),
            "whole call": parent_call,
        },
    }
    split = {}
    for when, steps in parts.items():
        split[when] = {part: host_us(step) for part, step in steps.items()}
        log(f"segment_rows_sum B={b} {n}x{c} -> {rows}, host us per call {when}: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split[when].items()))
    side = torch.cuda.Stream(device)
    torch.cuda.synchronize()
    if raw(index) != torch.cuda.current_stream(device).cuda_stream:
        raise AssertionError("raw stream handle differs from the current stream's")
    with torch.cuda.stream(side):
        if raw(index) != side.cuda_stream:
            raise AssertionError("raw stream handle ignores torch.cuda.stream(...)")
        got = pnn.segment_rows_sum(vals, ids, rows)
    side.synchronize()
    _check_sum("segment_rows_sum on a side stream", got,
               pnn._segment_rows_sum_plain(vals, ids, rows),
               pnn._segment_rows_sum_plain(vals.abs(), ids, rows))
    log("raw stream handle equals torch.cuda.current_stream's, inside a side stream too; "
        "a launch there matches the plain version")
    return whole, split


def _nn_inputs(device, n, m, seed, batch=BATCH):
    import torch

    from himo_tpu_torch.ops import nn as pnn

    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(batch, n, 3, device=device, generator=gen) * 80.0 - 40.0
    r = torch.rand(batch, m, 3, device=device, generator=gen) * 80.0 - 40.0
    r[:, m // 2 : m // 2 + 64] = r[:, :64]  # exact duplicate refs
    q[:, :32] = r[:, :32]  # queries on duplicated refs: lowest index must win
    qv = torch.rand(batch, n, device=device, generator=gen) > 0.1
    rv = torch.rand(batch, m, device=device, generator=gen) > 0.1
    qv[:, :32] = True
    rv[:, :64] = True
    rv[:, m // 2 : m // 2 + 64] = True
    return pnn._pad_coords(q, qv), pnn._pad_coords(r, rv), qv


def phase_nn(device):
    """K6 and K7 at the refine head's shapes (NN_SHAPES, B8), and K7 at
    ``nsfp``'s (NN_NSFP_SHAPE, one frame), on uniform clouds with exact
    duplicates: within tolerance of the plain versions, the index at the
    min, duplicates resolved to the lowest index; timed."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    out = {}
    for batch, n, m in [(BATCH, n, m) for n, m in NN_SHAPES] + [NN_NSFP_SHAPE]:
        q, r, qv = _nn_inputs(device, n, m, seed=n + m, batch=batch)
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
        pairs = batch * n * m
        io = batch * (n + m) * 12
        ms_arg = cuda_ms(lambda: pnn.nn_argmin_rows(q, r))
        plain_arg = cuda_ms(lambda: pnn._nn_argmin_plain(q, r), iters=5)
        if (batch, n, m) == NN_NSFP_SHAPE:
            dev = device_times(lambda: pnn.nn_argmin_rows(q, r))["device_ms"]
            bnd = bound(io + batch * n * 8, pairs * NN_OPS_PER_PAIR)
            # K6 here too: off the main paths, the eval chamfer's shape.
            min_ms = cuda_ms(lambda: pnn.nn_min_rows(q, r))
            min_dev = device_times(lambda: pnn.nn_min_rows(q, r))["device_ms"]
            min_plain = cuda_ms(lambda: pnn._nn_min_plain(q, r), iters=5)
            min_bnd = bound(io + batch * n * 4, pairs * NN_OPS_PER_PAIR)
            log(f"nn B={batch} {n}x{m}: argmin d2 within tolerance, ties lowest-index, "
                f"{flips} index differences at near-ties; argmin kernel {ms_arg:.4f} ms, "
                f"device {dev:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                f"plain {plain_arg:.4f} ms; min kernel {min_ms:.4f} ms, device "
                f"{min_dev:.4f} ms, bound {min_bnd['bound_ms']:.4f} ms "
                f"({min_bnd['bound_by']}), plain {min_plain:.4f} ms")
            continue
        ms_min = cuda_ms(lambda: pnn.nn_min_rows(q, r))
        plain_min = cuda_ms(lambda: pnn._nn_min_plain(q, r), iters=5)
        log(f"nn B={batch} {n}x{m}: d2 within tolerance, ties lowest-index, "
            f"{flips} argmin index differences at near-ties; "
            f"argmin kernel {ms_arg:.4f} ms plain {plain_arg:.4f} ms; "
            f"min kernel {ms_min:.4f} ms plain {plain_min:.4f} ms")
        out[(n, m)] = dict(
            argmin=dict(max_abs_err=float(err[qv].max()), ms=ms_arg, plain_ms=plain_arg,
                        library_ms=None, **device_times(lambda: pnn.nn_argmin_rows(q, r)),
                        **bound(io + BATCH * n * 8, pairs * NN_OPS_PER_PAIR)),
            min=dict(max_abs_err=float(err_min[qv].max()), ms=ms_min, plain_ms=plain_min,
                     library_ms=None, **device_times(lambda: pnn.nn_min_rows(q, r)),
                     **bound(io + BATCH * n * 4, pairs * NN_OPS_PER_PAIR)),
        )
    return out


def _train_batch(device, config, with_gt: bool = False):
    import torch

    from himo_tpu_torch.data.synthetic import train_batch

    arrays = train_batch(np.random.default_rng(0), config.batch_size,
                         config.num_points, config.loss_points, with_gt=with_gt)
    return {key: torch.from_numpy(v).to(device) for key, v in arrays.items()}


def _fused_inputs(device):
    """K8's arguments at the train step's shape: the chamfer samples of the
    batch (16,384 per side and frame), its validity and dynamic masks as
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
    return q, r, pen(ones_q), pen(d0), pen(ones_r), pen(d1)


def phase_fused(device):
    """K8 at the train step's shape (:func:`_fused_inputs`)."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    args = _fused_inputs(device)
    q, r = args[:2]
    n, m = q.shape[1], r.shape[1]
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
                 **device_times(lambda: pnn.fused_nn_idx(*args), iters=10),
                 **bound(io + 2 * out_min, pairs * FUSED_OPS_PER_PAIR)),
        min=dict(max_abs_err=max(min_errs), ms=ms_min, plain_ms=plain_ms, library_ms=None,
                 **device_times(lambda: pnn.fused_nn(*args), iters=10),
                 **bound(io + out_min, pairs * FUSED_OPS_PER_PAIR)),
    )


def _grid_points(gen, batch, n, device):
    """(batch, n, 3) points on the quarter-metre grid in [-8, 8]: every
    squared distance is a multiple of 1/16 below 2^10, exact in fp32 in the
    kernels' form and the plain versions' alike, and ties abound."""
    import torch

    ticks = torch.randint(-32, 33, (batch, n, 3), device=device, generator=gen)
    return ticks.to(torch.float32) / 4


def phase_nn_grid(device):
    """K6 and K7 (NN_SHAPES, B8) and K8 in both variants (FUSED_POINTS, B8,
    random validity and dynamic masks as penalties) on grid coordinates with
    exact duplicates: each kernel's values and indices equal its plain
    version's bit for bit (K8's column mins meet across query blocks there),
    and K6's distances equal K7's."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    gen = torch.Generator(device=device).manual_seed(21)
    for n, m in NN_SHAPES:
        q, r = _grid_points(gen, BATCH, n, device), _grid_points(gen, BATCH, m, device)
        r[:, m // 2 : m // 2 + 64] = r[:, :64]
        q[:, :32] = r[:, :32]
        d, idx = pnn.nn_argmin_rows(q, r)
        pd, pidx = pnn._nn_argmin_plain(q, r)
        _bitwise(f"nn_argmin_rows on the grid, B{BATCH} {n}x{m}", d, pd)
        _bitwise(f"nn_argmin_rows indices on the grid, B{BATCH} {n}x{m}", idx, pidx)
        dmin = pnn.nn_min_rows(q, r)
        _bitwise(f"nn_min_rows on the grid, B{BATCH} {n}x{m}", dmin, pnn._nn_min_plain(q, r))
        _bitwise(f"nn_min_rows against nn_argmin_rows' d2 on the grid, B{BATCH} {n}x{m}",
                 dmin, d)
    n = m = FUSED_POINTS
    q, r = _grid_points(gen, BATCH, n, device), _grid_points(gen, BATCH, m, device)
    r[:, m // 2 : m // 2 + 64] = r[:, :64]
    q[:, :32] = r[:, :32]
    q[:, n - 32 :] = q[:, :32]  # duplicate queries: column-side ties
    live = [torch.rand(BATCH, k, device=device, generator=gen) < 0.85 for k in (n, m)]
    dyn = [v & (torch.rand(v.shape, device=device, generator=gen) < 0.5) for v in live]
    pens = [torch.where(x, 0.0, pnn._MASK_BIG).to(torch.float32).contiguous()
            for x in (live[0], dyn[0], live[1], dyn[1])]
    outs = pnn.fused_nn_idx(q, r, *pens)
    mins = pnn.fused_nn(q, r, *pens)
    plain = pnn._fused_nn_plain(q, r, *pens)
    for k in range(8):
        _bitwise(f"fused_nn_idx output {k} on the grid", outs[k], plain[k])
    for k in range(4):
        _bitwise(f"fused_nn output {k} on the grid", mins[k], plain[k])
    log(f"grid coordinates: nn_min_rows and nn_argmin_rows at B{BATCH} {NN_SHAPES} "
        f"(nn_min_rows also equal to nn_argmin_rows' d2) and fused_nn_idx / "
        f"fused_nn at B{BATCH} {n}x{m} (masked) bitwise equal to their plain versions, "
        "values and indices")


def _nsfp_pair(device):
    """The optimisation estimators' frame pair: (pc0, pc1, known flow,
    moving mask, valid0, valid1), each of NSFP_POINTS rows on ``device``;
    a random 92 % of each cloud is valid."""
    import torch

    from himo_tpu_torch.data.synthetic import moving_objects_pair

    rng = np.random.default_rng(0)
    arrays = moving_objects_pair(rng, NSFP_POINTS, NSFP_SHIFT_M)
    valid = [rng.random(NSFP_POINTS) < VALID_FRACTION for _ in range(2)]
    return tuple(torch.from_numpy(a).to(device) for a in (*arrays, *valid))


def knn_agreement(got, want, q):
    """Hold (N, k) kernel distances against the plain version's for the
    (N, 3) queries ``q``: per value, ``tol = 1e-5 * (|q|^2 + |r|^2) + 1e-6``
    with ``|r| <= |q| + sqrt(d)``. The two forms round differently, so two
    references at nearly one distance may collapse into one slot in one
    form and not in the other, which shifts the later slots: the lists must
    agree as sets within the tolerance (every kernel value near a plain
    value and every plain value up to the kernel's last near a kernel
    value), and slot by slot on most queries. Returns (set-agreeing mask,
    slot-by-slot mask, tolerance)."""
    import torch

    qn = (q.double() ** 2).sum(-1, keepdim=True)
    tol = 1e-5 * (qn + (qn.sqrt() + want.double().clamp(min=0).sqrt()) ** 2) + 1e-6
    near = (got.double()[:, :, None] - want.double()[:, None, :]).abs() <= tol[:, None, :]
    beyond = want.double() > got.double()[:, -1:] + tol
    as_sets = near.any(-1).all(-1) & (near.any(1) | beyond).all(-1)
    slotwise = ((got.double() - want.double()).abs() <= tol).all(-1)
    return as_sets, slotwise & as_sets, tol


def _knn_inputs(pair):
    """K9's inputs at the nsfp loss's shape: (q, r, query valid), 1 x 65,536
    queries x 65,537 references (the clouds as ``knn_distance_sq`` pads
    them, one SENTINEL row appended), with reference rows 0..63 held twice
    and queries 0..31 on them (the collapse rule)."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    pc0, pc1, _, _, v0, v1 = pair
    n = pc0.shape[0]
    qp, rp, qv, rv = pc0.clone(), pc1.clone(), v0.clone(), v1.clone()
    dup = KNN_DUPLICATES
    rp[n // 2 : n // 2 + dup] = rp[:dup]  # each of rows 0..63 held twice
    qp[: dup // 2] = rp[: dup // 2]  # queries on duplicated references
    qv[: dup // 2] = True
    rv[:dup] = rv[n // 2 : n // 2 + dup] = True
    q = pnn._pad_coords(qp[None], qv[None])
    r = pnn._pad_coords(rp[None], rv[None])
    r = torch.cat([r, torch.full_like(r[:, :1], pnn.SENTINEL)], dim=1).contiguous()
    return q, r, qv


def phase_knn(device, pair):
    """K9 at the nsfp loss's shape (:func:`_knn_inputs`), k=4, with exact
    duplicate references for the collapse rule."""
    import torch

    from himo_tpu_torch.ops import knn as pknn

    q, r, qv = _knn_inputs(pair)
    n, dup = q.shape[1], KNN_DUPLICATES
    got = pknn.knn_rows(q, r, KNN_K)
    want = pknn._knn_plain(q, r, KNN_K)
    torch.cuda.synchronize()
    as_sets, slotwise, tol = knn_agreement(got[0], want[0], q[0])
    live = qv
    if not bool(as_sets[live].all()):
        raise AssertionError(f"knn_rows differs from plain beyond tolerance on "
                             f"{int((~as_sets)[live].sum())} queries")
    aligned = float(slotwise[live].float().mean())
    if aligned < 0.99:
        raise AssertionError(f"knn_rows: only {aligned:.4f} of queries agree slot by slot")
    # Queries 0..31 sit on a reference held twice: slot 1 of both versions
    # is the next DISTINCT distance (float64 brute force), not the copy.
    head = slice(0, dup // 2)
    d64 = ((q[0, head, None].double() - r[0, None].double()) ** 2).sum(-1)
    second = torch.where(d64 > d64.amin(-1, keepdim=True), d64,
                         torch.full_like(d64, float("inf"))).amin(-1)
    for name, vals in (("kernel", got), ("plain", want)):
        if not bool(((vals[0, head, 1].double() - second).abs() <= tol[head, 1]).all()):
            raise AssertionError(f"knn_rows ({name}): duplicated references did not "
                                 f"collapse into one slot")
    # Each kernel value against the nearest plain value (slots may shift).
    err = float((got[0, :, :, None] - want[0, :, None, :]).abs().amin(-1)[live].max())
    ms = cuda_ms(lambda: pknn.knn_rows(q, r, KNN_K))
    plain_ms = cuda_ms(lambda: pknn._knn_plain(q, r, KNN_K), iters=3, warmup=1)
    m = r.shape[1]
    log(f"knn_rows 1x{n}x{m} k={KNN_K}: every query's distances agree as sets within "
        f"1e-5*(|q|^2+|r|^2)+1e-6 (max abs err to the nearest plain value {err:.3e}), "
        f"{aligned:.6f} of queries slot by slot; duplicates collapse alike; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **device_times(lambda: pknn.knn_rows(q, r, KNN_K), iters=10),
                **bound((n + m) * 12 + n * KNN_K * 4, n * m * NN_OPS_PER_PAIR))


INFER_LAUNCHES = dict(scatter_max_rows=3, nn_argmin_rows=10, nn_min_rows=1)
INFER_256_LAUNCHES = dict(scatter_max_resident_rows=3, gather_rows=1, nn_argmin_rows=10,
                          nn_min_rows=1)
INFER_BIG_LAUNCHES = dict(sorted_scatter_max_rows=3, nn_argmin_rows=10, nn_min_rows=1)
INFER_SORTED_LAUNCHES = dict(sorted_segment_sum=3, sorted_segment_gather=1,
                             nn_argmin_rows=10, nn_min_rows=1)


def phase_slice(device, clouds, name="inference", expected=INFER_LAUNCHES,
                model_name="seflowpp", prior=None, **overrides):
    """One path's inference + de-skew on ``clouds`` (the ``model_name``
    preset with the model ``overrides``, and the prior presets' host
    ``prior``); the launches of one forward must be ``expected``."""
    import torch

    from himo_tpu_torch.models.feedforward import frame, init_params, make_model

    pc0, pc1, pch, valid, dt0, n_valid = clouds
    model, cfg = make_model(model_name, device=device, dtype="bfloat16", **overrides)
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    log(f"[{name}] {model_name}: grid {cfg.pillar.grid_shape}, {pc0.shape[1]} points per "
        f"sweep, pooling {cfg.pooling}, pfn {cfg.point_feat_dim}, "
        f"base {cfg.base_channels}, depths {cfg.depths}, slots {cfg.instance_slots}, "
        f"refine {cfg.refine.num_query}x{cfg.refine.num_ref}, dtype {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    frame(model, pc0, pc1, pch, valid, dt0, prior)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()

    reset_counts()
    flow, comp_dis, refined = frame(model, pc0, pc1, pch, valid, dt0, prior)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[{name}] launches in one batched forward: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(expected)
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")

    shape = tuple(pc0.shape)
    for what, t in (("flow", flow), ("comp_dis", comp_dis), ("refined", refined)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise AssertionError(f"{name} {what}: {tuple(t.shape)} {t.dtype}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} {what} has non-finite values")
    if not torch.equal(refined, pc0 + flow * (dt0 / 0.1)[..., None]):
        raise AssertionError(f"{name}: refined != pc0 + flow * dt0 / 0.1")
    if bool((flow[~valid] != 0).any()):
        raise AssertionError(f"{name}: padded points got a non-zero flow")

    with plain_kernels(), torch.inference_mode():
        ref_flow, aux = model((pc0, pc1, pch), (valid, valid, valid), prior,
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
    log(f"[{name}] kernels vs plain on the card: {agree:.6f} of points within {SLICE_TOL_M} m "
        f"(max {float(dist.max()):.6f} m); {int(far.sum())} points in "
        f"{len(flipped)} (frame, slot) groups differ; "
        f"{moved:.4f} of points have non-zero flow; "
        f"{int((slots >= 0).sum())} slotted points")
    if agree < SLICE_MIN_AGREE:
        raise AssertionError(f"{name}: only {agree:.4f} of refined points agree with the "
                             f"plain run")

    def run():
        frame(model, pc0, pc1, pch, valid, dt0, prior)

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    median = float(np.median(times))
    mpts = BATCH * n_valid / median / 1e6
    log(f"[{name}] forward + de-skew, {BATCH} frames: median {median * 1e3:.3f} ms over 5 "
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


def phase_profile(name: str, fn, wall_ms: float, calls: int = PROFILE_CALLS) -> None:
    """Trace ``calls`` calls of a main path (already warm) under
    ``torch.profiler`` and print: the profiled wall time per call, the
    device busy time per call (the union of the trace's kernel, memcpy and
    memset intervals), the busy share of the profiled wall and of the
    path's unprofiled median ``wall_ms``, kernel launches per call, the
    kernels with the most device time, and the device time per launch of
    each of the port's own kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - start) * 1e3 / calls
    device = _device_events(prof)
    if not device:
        raise AssertionError(f"{name}: the trace holds no device activity")
    busy = _busy_ms((e["ts"], e["ts"] + e["dur"]) for e in device) / calls
    by_name = {}
    for e in device:
        if e["cat"] == "kernel":
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    launches = sum(n for _, n in by_name.values()) / calls
    memsets = [e["dur"] / 1e3 for e in device if e["cat"] == "gpu_memset"]
    log(f"[profile {name}] wall {wall_ms:.3f} ms per call unprofiled; profiled wall "
        f"{prof_wall:.3f} ms, device busy {busy:.3f} ms (busy share {busy / prof_wall:.4f} "
        f"of the profiled wall, {busy / wall_ms:.4f} of the unprofiled); "
        f"{launches:.0f} kernel launches per call; {len(memsets) / calls:.0f} memsets per "
        f"call, {sum(memsets) / calls:.3f} ms")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    port_kernel = port_kernel_pattern()
    for kname, (ms, n) in ranked[:PROFILE_TOP]:
        log(f"[profile {name}]   {ms / calls:9.3f} ms  {n / calls:6.0f} x  "
            f"{kname[:110]}")
    for kname, (ms, n) in ranked:
        if port_kernel.match(kname):
            log(f"[profile {name}] port kernel {ms / n * 1e3:9.3f} us per launch, "
                f"{n / calls:4.0f} x per call  {kname[:90]}")


def _grads(model):
    import torch

    return torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
        for p in model.parameters()
    ])


# K5 (sorted_gather_rows) is the scatter-max backward's take of the three
# sweep pools on the table and stream routes (the dynamic-image loss's max
# carries no gradient).
TRAIN_LAUNCHES = dict(scatter_max_rows=4, scatter_sum_rows=1, fused_nn_idx=1,
                      segment_rows_sum=3, sorted_gather_rows=3)
TRAIN_256_LAUNCHES = dict(scatter_max_resident_rows=4, gather_rows=1, fused_nn_idx=1,
                          segment_rows_sum=4)
TRAIN_BIG_LAUNCHES = dict(sorted_scatter_max_rows=4, sorted_scatter_sum_rows=1,
                          fused_nn_idx=1, segment_rows_sum=3, sorted_gather_rows=3)
# mean_sorted: K10 pools three sweeps, K11 gathers; their backwards are each
# other (K11 x 3, K10 x 1 at C = 65); the un-sort's take_rows adds one K3 sum.
TRAIN_SORTED_LAUNCHES = {"scatter_max_rows": 1, "sorted_segment_sum": 3, K10_STEP: 1,
                         "sorted_segment_gather": 4, "fused_nn_idx": 1,
                         "segment_rows_sum": 4}


def phase_train(device, name="train", steps=TRAIN_STEPS, expected=TRAIN_LAUNCHES,
                val=True, num_points=None, model="seflowpp", batch=None, **overrides):
    """``steps`` SSL train steps of the ``model`` preset with the model
    ``overrides`` at ``TrainConfig()`` (``num_points`` per sweep when
    given), on ``batch`` (``data.synthetic.train_batch``'s when None), each
    launching ``expected``, then one validation step when ``val``; returns
    the summed launches, one step for the profile and the median ms of
    steps 2 on."""
    import torch

    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.training.trainer import (
        TrainConfig,
        make_optimizer,
        make_train_step,
        make_val_step,
        mean_losses,
    )

    config = TrainConfig(model=model) if num_points is None else TrainConfig(
        model=model, num_points=num_points)
    model, cfg = make_model(config.model, device=device, dtype="bfloat16", **overrides)
    init_params(model, torch.Generator().manual_seed(0))
    if batch is None:
        batch = _train_batch(device, config)
    log(f"[{name}] {config.model} {cfg.dtype}, pooling {cfg.pooling}, grid "
        f"{cfg.pillar.grid_shape}, "
        f"B={config.batch_size} N={config.num_points} K={config.loss_points}, lr "
        f"{config.lr}, warmup {config.warmup_steps} (capped), clip {config.grad_clip}, "
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
    want = dict.fromkeys(read_counts(), 0)
    want.update(expected)
    totals = dict.fromkeys(want, 0)
    times, peaks = [], []
    for step in range(steps):
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
        if counts != want:
            raise AssertionError(f"{name} step {step + 1} launches {counts} != {want}")
        for k, v in counts.items():
            totals[k] += v
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name} step {step + 1}: non-finite metrics {m}")
        moved = max(float((p.detach() - b).abs().max())
                    for p, b in zip(model.parameters(), before))
        lr = schedule(step)
        if step == 0 and (lr != 0.0 or moved != 0.0):
            raise AssertionError(f"{name} step 1: lr {lr}, parameters moved {moved}")
        if step > 0 and moved == 0.0:
            raise AssertionError(f"{name} step {step + 1} (lr {lr}) left the parameters "
                                 f"unchanged")
        # Kernels vs plain versions at this step's parameters. The kernel
        # gradients are clipped in place by now: compare the pre-clip norm
        # and the direction.
        worst = max(abs(m[k] - v) / max(abs(v), 1e-12) for k, v in plain_terms.items())
        norm = float(optimizer.last_grad_norm)
        plain_norm = float(plain_grads.norm())
        norm_rel = abs(norm - plain_norm) / plain_norm
        cosine = float(torch.nn.functional.cosine_similarity(
            _grads(model), plain_grads, dim=0))
        log(f"[{name}] step {step + 1}: lr {lr:.3e}, max |param change| {moved:.3e}, "
            f"{times[-1] * 1e3:.3f} ms, total {m['total']:.6f}; kernels vs plain: "
            f"worst term rel diff {worst:.3e}, grad norm {norm:.6f} vs "
            f"{plain_norm:.6f} (rel {norm_rel:.3e}), cosine {cosine:.6f}")
        if step == 0:
            log(f"[{name}] step 1 terms, kernels/plain: " + ", ".join(
                f"{k} {m[k]:.6f}/{plain_terms[k]:.6f}" for k in sorted(plain_terms)))
            if worst > TERM_RTOL or norm_rel > NORM_RTOL or cosine < MIN_COSINE:
                raise AssertionError(
                    f"{name} step 1 through the kernels disagrees with the plain run "
                    f"(limits: terms {TERM_RTOL}, norm {NORM_RTOL}, cosine {MIN_COSINE})")
    peak = max(peaks)

    val_note = ""
    if val:
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
        val_note = (f"; val step total_sum {out['total_sum']:.6f} epe "
                    f"{out['epe_sum'] / max(out['epe_count'], 1.0):.6f}")

    median = float(np.median(times))
    median_warm = float(np.median(times[1:]))
    log(f"[{name}] train step B={config.batch_size}: median {median * 1e3:.3f} ms over "
        f"{steps} ({', '.join(f'{t * 1e3:.3f}' for t in times)}); median of "
        f"steps 2-{steps} {median_warm * 1e3:.3f} ms; peak memory {peak:.2f} GiB"
        f"{val_note}")
    return totals, lambda: train_step(batch), median_warm * 1e3


def _timed(fn):
    """(result, seconds) of ``fn()`` on the host clock, synchronized."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def _check_flow(name, flow, loss, first, pair):
    """Flow finite, (N, 3) and zero on invalid points, final loss below the
    first; returns the mean EPE of the valid moving and static points."""
    import torch

    pc0, _, gt, moving, v0, _ = pair
    if tuple(flow.shape) != tuple(pc0.shape) or not bool(torch.isfinite(flow).all()):
        raise AssertionError(f"{name}: flow {tuple(flow.shape)} not finite or misshapen")
    if bool((flow[~v0] != 0).any()):
        raise AssertionError(f"{name}: invalid points got a non-zero flow")
    if not float(loss) < first:
        raise AssertionError(f"{name}: final loss {float(loss)} not below the first {first}")
    epe = (flow - gt).norm(dim=-1)
    return tuple(float(epe[v0 & sel].mean()) for sel in (moving, ~moving))


def _flat_grads(params):
    import torch

    return torch.cat([t.grad.reshape(-1) for group in params for t in group])


def knn_loss_shift(warped, p1, v0, v1, k, cap):
    """The share of the k-NN smoothed chamfer's value (both sides) that the
    queries whose k-NN lists differ slot by slot between the kernel and
    the plain version carry: the sum of their capped k-mean differences
    over each side's valid count; and the fraction of such queries per
    side."""
    import torch

    from himo_tpu_torch.ops import knn as pknn
    from himo_tpu_torch.ops import nn as pnn

    share, fractions = 0.0, []
    with torch.no_grad():
        for a, b, va, vb in ((warped, p1, v0, v1), (p1, warped, v1, v0)):
            got = pknn.knn_distance_sq(a, b, k, va, vb)[0]
            with plain_kernels():
                want = pknn.knn_distance_sq(a, b, k, va, vb)[0]
            _, slotwise, _ = knn_agreement(got, want, a[0])
            odd = ~slotwise & va[0]
            diff = pnn.capped(got, cap).mean(-1) - pnn.capped(want, cap).mean(-1)
            count = float(va.sum())
            share += float(diff[odd].sum()) / max(count, 1.0)
            fractions.append(float(odd.sum()) / max(count, 1.0))
    return share, fractions


def phase_nsfp(device, pair, epe=None):
    """The nsfp estimator at knn_k 0 and KNN_K (see the module docstring),
    ``cluster_prior=False``; returns the summed launch counts and a 20-step
    run for the profile, and records the moving points' EPE at knn_k 0 as
    ``epe["nsfp"]`` when given a dict."""
    import torch

    from himo_tpu_torch.models import nsfp as pn
    from himo_tpu_torch.models.coordinate_mlp import init_mlp
    from himo_tpu_torch.models.registry import get_estimator

    pc0, pc1, _, moving, v0, v1 = pair
    totals = dict.fromkeys(read_counts(), 0)
    for k in (0, KNN_K):
        config = pn.NSFPConfig(cluster_prior=False, knn_k=k, iterations=NSFP_ITERS)
        loss_fn, total_flow = pn.nsfp_loss_fn(pc0, pc1, v0, v1, config)
        init = init_mlp(torch.Generator().manual_seed(0), config.hidden, config.layers,
                        device=device)

        def loss_and_grads():
            p = [tuple(t.clone().requires_grad_() for t in group) for group in init]
            loss = loss_fn(p)
            loss.backward()
            return float(loss.detach()), _flat_grads(p)

        reset_counts()
        first, grads = loss_and_grads()
        per_step = read_counts()
        with plain_kernels():
            plain_first, plain_grads = loss_and_grads()
        expected = dict.fromkeys(per_step, 0)
        expected.update(nn_argmin_rows=2, segment_rows_sum=1)
        if k:
            expected["knn_rows"] = 2
        if per_step != expected:
            raise AssertionError(f"nsfp knn_k={k}: one step launched {per_step} != {expected}")
        # With knn_k > 0, queries whose k-NN lists differ slot by slot (a
        # near-tie collapsed in one form only) carry a known share of the
        # difference: the limit holds for the rest.
        shift, shifted = 0.0, ""
        if k:
            with torch.no_grad():
                warped = pc0[None, :, :3] + total_flow(init)[None]
            shift, fractions = knn_loss_shift(warped, pc1[None, :, :3], v0[None],
                                              v1[None], k, config.max_dist ** 2)
            shifted = (f"; slot-shifted k-NN queries {fractions[0]:.6f} / "
                       f"{fractions[1]:.6f} of each side carry {shift:.6e}")
        loss_rel = abs(first - plain_first - shift) / abs(plain_first)
        norm, plain_norm = float(grads.norm()), float(plain_grads.norm())
        norm_rel = abs(norm - plain_norm) / plain_norm
        cosine = float(torch.nn.functional.cosine_similarity(grads, plain_grads, dim=0))
        log(f"nsfp knn_k={k} step 1, kernels vs plain: loss {first:.6f} vs {plain_first:.6f}"
            f"{shifted} (rel diff of the rest {loss_rel:.3e}), grad norm {norm:.6f} vs "
            f"{plain_norm:.6f} (rel {norm_rel:.3e}), cosine {cosine:.6f}; launches per "
            f"step {per_step}")
        if loss_rel > TERM_RTOL or norm_rel > NORM_RTOL or cosine < MIN_COSINE:
            raise AssertionError(
                f"nsfp knn_k={k} step 1 through the kernels disagrees with the plain "
                f"run (limits: loss {TERM_RTOL}, norm {NORM_RTOL}, cosine {MIN_COSINE})")

        estimate = get_estimator("nsfp", device=device, cluster_prior=False, knn_k=k,
                                 iterations=NSFP_ITERS)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (flow, loss), secs = _timed(lambda: estimate(
            pc0, pc1, v0, v1, torch.Generator().manual_seed(0)))
        counts = read_counts()
        want = {key: v * NSFP_ITERS for key, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"nsfp knn_k={k}: the run launched {counts} != {want}")
        for key, v in counts.items():
            totals[key] += v
        epe_moving, epe_static = _check_flow(f"nsfp knn_k={k}", flow, loss, first, pair)
        if epe is not None and k == 0:
            epe["nsfp"] = epe_moving
        log(f"nsfp knn_k={k}, {NSFP_ITERS} steps on {pc0.shape[0]} points: "
            f"{secs * 1e3:.3f} ms per frame, {secs * 1e3 / NSFP_ITERS:.4f} ms per step; "
            f"loss {first:.6f} -> {float(loss):.6f}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; EPE moving "
            f"{epe_moving:.4f} m ({int((moving & v0).sum())} points), static "
            f"{epe_static:.4f} m (random init: printed, not checked)")

    return (totals, *_profile_run("nsfp", pair, knn_k=KNN_K))


def _profile_run(name, pair, **overrides):
    """A warm NSFP_PROFILE_ITERS-step run of the estimator ``name`` on the
    pair, and its unprofiled wall time in ms (median of 3)."""
    import torch

    from himo_tpu_torch.models.registry import get_estimator

    pc0, pc1, _, _, v0, v1 = pair
    estimate = get_estimator(name, device=pc0.device, cluster_prior=False,
                             iterations=NSFP_PROFILE_ITERS, **overrides)

    def run():
        return estimate(pc0, pc1, v0, v1, torch.Generator().manual_seed(0))

    run()
    return run, float(np.median([_timed(run)[1] for _ in range(3)])) * 1e3


def phase_fastnsf(device, pair, epe=None):
    """The fastnsf estimator on the nsfp pair, ``cluster_prior=False``: the
    distance-field build timed alone, then the full run; it launches none
    of the port's kernels. Returns a 20-step run for the profile, and
    records the moving points' EPE as ``epe["fastnsf"]`` when given a
    dict."""
    import torch

    from himo_tpu_torch.models import fastnsf as pf
    from himo_tpu_torch.models.coordinate_mlp import init_mlp
    from himo_tpu_torch.models.registry import get_estimator
    from himo_tpu_torch.ops.dt import DTConfig, distance_transform

    pc0, pc1, _, _, v0, v1 = pair
    dt = FASTNSF_DT or DTConfig()
    config = pf.FastNSFConfig(cluster_prior=False, dt=dt, iterations=NSFP_ITERS)
    distance_transform(pc1, v1, dt)  # warm-up
    builds = [_timed(lambda: distance_transform(pc1, v1, dt)) for _ in range(3)]
    grid = builds[0][0]
    build_ms = float(np.median([s for _, s in builds])) * 1e3
    loss_fn, _ = pf.fastnsf_loss_fn(pc0, v0, grid, config)
    init = init_mlp(torch.Generator().manual_seed(0), config.hidden, config.layers,
                    device=device)
    with torch.no_grad():
        first = float(loss_fn(init))
    estimate = get_estimator("fastnsf", device=device, cluster_prior=False, dt=dt,
                             iterations=NSFP_ITERS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (flow, loss), secs = _timed(lambda: estimate(
        pc0, pc1, v0, v1, torch.Generator().manual_seed(0)))
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"fastnsf launched port kernels: {counts}")
    epe_moving, epe_static = _check_flow("fastnsf", flow, loss, first, pair)
    if epe is not None:
        epe["fastnsf"] = epe_moving
    step_ms = (secs * 1e3 - build_ms) / NSFP_ITERS
    log(f"fastnsf {dt.grid_shape} field, {NSFP_ITERS} steps on {pc0.shape[0]} points: "
        f"distance-field build {build_ms:.3f} ms, {secs * 1e3:.3f} ms per frame, "
        f"{step_ms:.4f} ms per step; loss {first:.6f} -> {float(loss):.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; EPE moving "
        f"{epe_moving:.4f} m, static {epe_static:.4f} m (printed, not checked)")
    return _profile_run("fastnsf", pair, dt=dt)


def _check_prior(name, prior, valid, gt, moving):
    """A host prior: (N, 3) or (B, N, 3), finite and zero where ``valid``
    is false. Returns its coverage of the valid moving points, the median
    error of the covered moving points against the known motion, and the
    number of covered points that did not move."""
    import torch

    if tuple(prior.shape) != tuple(gt.shape) or prior.dtype != torch.float32:
        raise AssertionError(f"{name}: prior {tuple(prior.shape)} {prior.dtype}")
    if not bool(torch.isfinite(prior).all()):
        raise AssertionError(f"{name}: the prior has non-finite values")
    if bool((prior[~valid] != 0).any()):
        raise AssertionError(f"{name}: the prior is non-zero on invalid points")
    covered = (prior != 0).any(dim=-1)
    coverage = float(covered[moving & valid].float().mean())
    err = (prior - gt).norm(dim=-1)[covered & moving]
    median = float(err.median()) if err.numel() else float("nan")
    return coverage, median, int((covered & ~moving).sum())


def phase_opt_prior(device, pair, cold):
    """``nsfp`` and ``fastnsf`` at the reference's defaults (the host
    cluster prior, ``knn_k=0``, NSFP_ITERS steps) on the nsfp pair: the
    prior alone (host ms, coverage and error against the known motion;
    finite, zero on invalid points, no kernel launched), then each
    estimator through the registry (launches: NSFP_ITERS x one step's for
    nsfp, none for fastnsf; final loss below the first; flow finite and
    zero on invalid points); the moving points' EPE beside the cold start's
    (``cold``, by estimator). Returns the summed launches."""
    import torch

    from himo_tpu_torch.models import fastnsf as pf
    from himo_tpu_torch.models import nsfp as pn
    from himo_tpu_torch.models.coordinate_mlp import init_mlp
    from himo_tpu_torch.models.registry import get_estimator
    from himo_tpu_torch.ops.dt import DTConfig, distance_transform

    pc0, pc1, gt, moving, v0, v1 = pair
    config = pn.NSFPConfig(iterations=NSFP_ITERS)
    reset_counts()
    prior, secs = _timed(lambda: pn.cluster_prior_flow(pc0, pc1, v0, v1, config))
    if any(read_counts().values()):
        raise AssertionError(f"the host prior launched kernels: {read_counts()}")
    coverage, median, static = _check_prior("cluster_prior_flow", prior, v0, gt, moving)
    log(f"cluster_prior_flow (NSFPConfig defaults) on {pc0.shape[0]} points: host "
        f"{secs * 1e3:.3f} ms; covers {coverage:.4f} of the valid moving points, median "
        f"error {median:.6f} m against the known {NSFP_SHIFT_M} m motion, {static} static "
        f"points covered")
    totals = dict.fromkeys(read_counts(), 0)
    dt = FASTNSF_DT or DTConfig()
    for name in ("nsfp", "fastnsf"):
        if name == "nsfp":
            cfg, overrides = config, dict(iterations=NSFP_ITERS)
            loss_fn, _ = pn.nsfp_loss_fn(pc0, pc1, v0, v1, cfg, prior)
        else:
            cfg = pf.FastNSFConfig(dt=dt, iterations=NSFP_ITERS)
            overrides = dict(dt=dt, iterations=NSFP_ITERS)
            grid = distance_transform(pc1, v1, dt)
            loss_fn, _ = pf.fastnsf_loss_fn(pc0, v0, grid, cfg, prior)
        init = init_mlp(torch.Generator().manual_seed(0), cfg.hidden, cfg.layers,
                        device=device)
        with torch.no_grad():
            first = float(loss_fn(init))
        estimate = get_estimator(name, device=device, **overrides)
        if not (estimate.config.cluster_prior and estimate.config.knn_k == 0
                if name == "nsfp" else estimate.config.cluster_prior):
            raise AssertionError(f"{name}: not the reference's defaults {estimate.config}")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (flow, loss), secs = _timed(lambda: estimate(
            pc0, pc1, v0, v1, torch.Generator().manual_seed(0)))
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        if name == "nsfp":
            want.update(nn_argmin_rows=2 * NSFP_ITERS, segment_rows_sum=NSFP_ITERS)
        if counts != want:
            raise AssertionError(f"{name} with the prior launched {counts} != {want}")
        for key, v in counts.items():
            totals[key] += v
        epe_moving, epe_static = _check_flow(f"{name} prior", flow, loss, first, pair)
        log(f"{name} (cluster prior, {NSFP_ITERS} steps): {secs * 1e3:.3f} ms per frame, "
            f"the host prior included; loss {first:.6f} -> {float(loss):.6f}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; EPE moving "
            f"{epe_moving:.4f} m (cold start {cold[name]:.4f} m), static {epe_static:.4f} m "
            f"(printed, not checked)")
    return totals


def _trust_clouds(device, n=None):
    """The prior presets' frames: BATCH frame pairs of ``n`` points
    (NUM_POINTS when None) from ``moving_objects_pair`` (seed 1): pc1 has
    each frame's 16 object clusters moved NSFP_SHIFT_M, the history sweep
    has them moved back as far, a random 92 % of each frame valid (the
    object points are the frame's last 10 %), sweep times uniform in [0,
    0.1) s. Returns the clouds as ``_clouds`` does (``n_valid`` the mean
    valid count), the known flow and the moving mask."""
    import torch

    from himo_tpu_torch.data.synthetic import moving_objects_pair

    n = NUM_POINTS if n is None else n
    rng = np.random.default_rng(1)
    frames = [moving_objects_pair(rng, n, NSFP_SHIFT_M) for _ in range(BATCH)]
    pc0, pc1, flow, moving = (np.stack([f[i] for f in frames]) for i in range(4))
    valid = rng.random((BATCH, n)) < VALID_FRACTION
    n_valid = int(valid.sum()) // BATCH
    dt0 = rng.uniform(0, 0.1, size=(BATCH, n)).astype(np.float32)
    pc0, pc1, pch, flow, moving, valid, dt0 = (
        torch.from_numpy(a).to(device) for a in (pc0, pc1, pc0 - flow, flow, moving,
                                                  valid, dt0))
    return (pc0, pc1, pch, valid, dt0, n_valid), flow, moving


def phase_trust(device):
    """``seflowpp_trust`` at full width (see the module docstring): the host
    prior of each frame (``feedforward.frame_priors``, the registry
    estimator's), the forward + de-skew with it through the kernels against
    the plain versions, then ROUTE_TRAIN_STEPS train steps fed the prior as
    ``ssl_prior``. Returns the forward's launches, the train steps'
    launches and the forward for the profile with its ms."""
    import torch

    from himo_tpu_torch.data.synthetic import train_batch
    from himo_tpu_torch.models.feedforward import frame_priors
    from himo_tpu_torch.training.trainer import TrainConfig

    clouds, gt, moving = _trust_clouds(device)
    pc0, pc1, pch, valid, dt0, n_valid = clouds
    priors, secs = [], []
    reset_counts()
    for b in range(BATCH):
        one = slice(b, b + 1)
        prior_b, s = _timed(lambda: frame_priors(pc0[one], pc1[one], valid[one], valid[one],
                                                 dt0[one], dt0[one]))
        priors.append(prior_b[0])
        secs.append(s)
    if any(read_counts().values()):
        raise AssertionError(f"the host prior launched kernels: {read_counts()}")
    prior = torch.stack(priors)
    coverage, median, static = _check_prior("frame_priors", prior, valid, gt, moving)
    log(f"[inference_trust] host prior of {BATCH} frames of {pc0.shape[1]} points: "
        f"slowest frame {max(secs) * 1e3:.3f} ms, sum {sum(secs) * 1e3:.3f} ms "
        f"({', '.join(f'{s * 1e3:.1f}' for s in secs)}); covers {coverage:.4f} of the "
        f"valid moving points, median error {median:.6f} m, {static} static points covered")
    launches, run, ms = phase_slice(device, clouds, name="inference_trust",
                                    model_name="seflowpp_trust", prior=prior)

    config = TrainConfig(model="seflowpp_trust")
    arrays = train_batch(np.random.default_rng(0), BATCH, config.num_points,
                         config.loss_points)
    batch = {key: torch.from_numpy(v).to(device) for key, v in arrays.items()}
    covered = (prior != 0).any(dim=-1)
    batch.update(pc0=pc0, pc1=pc1, pc_hist=pch, valid0=valid, valid1=valid, valid_hist=valid,
                 dynamic0=moving & valid, dynamic1=moving & valid, prior0=prior,
                 prior_valid0=covered)
    train = phase_train(device, name="train_trust", steps=ROUTE_TRAIN_STEPS,
                        expected=TRAIN_LAUNCHES, val=False, model="seflowpp_trust",
                        batch=batch)[0]
    return launches, train, run, ms


def phase_nn_icp(device):
    """K7 at ``icp_register_clusters``' shape (ICP_SHAPE: clusters x slots
    x pc1 points): each cluster's slots filled up to a random count (the
    rest at the padding sentinel, as ``nn_argmin`` pads masked queries)
    near one uniform cloud that every cluster reads (replicated, as the
    registration feeds it); d2 within tolerance of the plain version on
    the filled slots and the index at the min; timed beside the bound
    (every (slot, point) pair: the kernel walks masked slots too)."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    c, k, m = ICP_SHAPE
    gen = torch.Generator(device=device).manual_seed(7)
    refs = torch.rand(1, m, 3, device=device, generator=gen) * 80.0 - 40.0
    near = torch.randint(0, m, (c, k), device=device, generator=gen)
    q = refs[0, near] + 0.5 * torch.randn(c, k, 3, device=device, generator=gen)
    counts = torch.randint(0, k + 1, (c,), device=device, generator=gen)
    qv = torch.arange(k, device=device)[None] < counts[:, None]
    q = pnn._pad_coords(q, qv)
    r = refs.expand(c, m, 3).contiguous()
    d, idx = pnn.nn_argmin_rows(q, r)
    pd, pidx = pnn._nn_argmin_plain(q, r)
    torch.cuda.synchronize()
    tol = 1e-5 * ((q * q).sum(-1) + torch.gather((r * r).sum(-1), 1, idx.long())) + 1e-6
    err = (d - pd).abs()
    if not bool((err <= tol)[qv].all()):
        raise AssertionError(f"nn_argmin d2 off tolerance at {ICP_SHAPE}: "
                             f"{float(err[qv].max())}")
    chosen = torch.gather(r, 1, idx.long()[..., None].expand(-1, -1, 3))
    if not bool(((((q - chosen) ** 2).sum(-1) - pd).abs() <= tol)[qv].all()):
        raise AssertionError(f"nn_argmin index not at the min at {ICP_SHAPE}")
    flips = int((idx != pidx)[qv].sum())
    del pd, pidx
    ms = cuda_ms(lambda: pnn.nn_argmin_rows(q, r))
    plain_ms = cuda_ms(lambda: pnn._nn_argmin_plain(q, r), iters=3, warmup=1)
    dev = device_times(lambda: pnn.nn_argmin_rows(q, r))["device_ms"]
    bnd = bound(c * (k + m) * 12 + c * k * 8, c * k * m * NN_OPS_PER_PAIR)
    torch.cuda.empty_cache()
    log(f"nn icp B={c} {k}x{m} ({int(qv.sum())} filled slots): argmin d2 within tolerance, "
        f"{flips} index differences at near-ties; kernel {ms:.4f} ms, device {dev:.4f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain {plain_ms:.4f} ms")
    return dict(max_abs_err=float(err[qv].max()), ms=ms, plain_ms=plain_ms, device_ms=dev,
                **bnd)


def phase_icpflow(device, pair):
    """The ``icpflow`` estimator with ``ICPFlowConfig()`` on the nsfp pair:
    exactly ICP_ITERS launches of K7 (one per registration iteration) and
    no other kernel; flow finite, (N, 3) and zero on invalid points; the
    registration (captured from the call) through the kernels against the
    same with the plain versions (every filled slot within ICP_TOL_M); the
    call's ms, split into the registration's wall (synchronized, within
    the call, where the 3x3 SVDs' first use sets up cuSOLVER) and the
    host's rest, the registration's warm wall and device ms; the moving
    points' EPE printed. Returns the launches."""
    import torch

    from himo_tpu_torch.models import icp_flow as pi
    from himo_tpu_torch.models.registry import get_estimator

    pc0, pc1, gt, moving, v0, v1 = pair
    estimate = get_estimator("icpflow", device=device)
    register = pi.icp_register_clusters
    captured = []

    def recording(*args):
        out, seconds = _timed(lambda: register(*args))
        captured.append((args, seconds))
        return out

    pi.icp_register_clusters = recording
    try:
        reset_counts()
        (flow, loss), secs = _timed(lambda: estimate(pc0, pc1, v0, v1))
        counts = read_counts()
    finally:
        pi.icp_register_clusters = register
    want = dict.fromkeys(counts, 0)
    want["nn_argmin_rows"] = ICP_ITERS
    if counts != want or len(captured) != 1:
        raise AssertionError(f"icpflow launched {counts} != {want} "
                             f"({len(captured)} registrations)")
    if tuple(flow.shape) != tuple(pc0.shape) or not bool(torch.isfinite(flow).all()):
        raise AssertionError(f"icpflow: flow {tuple(flow.shape)} not finite or misshapen")
    if bool((flow[~v0] != 0).any()) or float(loss) != 0.0:
        raise AssertionError("icpflow: invalid points got a non-zero flow, or a loss")
    args, reg_wall = captured[0]
    slots = args[1]
    kernel_flow, _, _ = register(*args)
    reg_warm = _timed(lambda: register(*args))[1]
    reg_device = device_ms(lambda: register(*args))
    with plain_kernels():
        plain_flow, _, _ = register(*args)
    torch.cuda.synchronize()
    dist = (kernel_flow - plain_flow).norm(dim=-1)[slots]
    agree = float((dist <= ICP_TOL_M).float().mean())
    close = float((dist <= SLICE_TOL_M).float().mean())
    covered = (flow != 0).any(dim=-1)
    epe = (flow - gt).norm(dim=-1)
    log(f"icpflow (ICPFlowConfig()) on {pc0.shape[0]} points: {secs * 1e3:.3f} ms per "
        f"frame, of which the registration {reg_wall * 1e3:.3f} ms wall (warm "
        f"{reg_warm * 1e3:.3f} ms, device {reg_device:.3f} ms); host (clustering, matching) "
        f"{(secs - reg_wall) * 1e3:.3f} ms; {int(slots.sum())} filled slots in "
        f"{int(slots.any(dim=1).sum())} clusters; {counts['nn_argmin_rows']} nn_argmin_rows "
        f"launches")
    log(f"icpflow registration, kernels vs plain: {agree:.6f} of filled slots within "
        f"{ICP_TOL_M} m, {close:.6f} within {SLICE_TOL_M} m (max "
        f"{float(dist.max()) if dist.numel() else 0.0:.6f} m); covers "
        f"{float(covered[moving & v0].float().mean()):.4f} of the valid moving points; EPE "
        f"moving {float(epe[moving & v0].mean()):.4f} m, static "
        f"{float(epe[~moving & v0].mean()):.4f} m (printed, not checked)")
    if agree < 1.0:
        raise AssertionError(f"icpflow: only {agree:.4f} of the registered slots agree with "
                             f"the plain run within {ICP_TOL_M} m")
    return counts


def _read_datasets(path) -> dict:
    """Every dataset of a scene file, by group and name, as the port's
    reader returns it."""
    from himo_tpu_torch.data import h5

    with h5.File(path) as f:
        return {key: {name: f[key][name][()] for name in f[key].keys()} for key in f.keys()}


SSL_DTYPES = {"ssl_dynamic": np.bool_, "ssl_cluster": np.uint16, "ssl_prior": np.float32,
              "ssl_prior_valid": np.bool_}


def _loop_dataset(root: Path):
    """The train loop's scenes: the port's ``make_dataset``, then SSL labels
    from the port's writer, ``training.ssl_labels.write_ssl_labels``
    (dynamic masks, HDBSCAN clusters, translation priors; each scene
    rewritten whole). Checks that every scene reads back with each dataset
    it had unchanged and the four ``ssl_*`` datasets equal to what the
    writer was given, in the reference's dtypes. Returns the frames as
    ``make_dataset`` wrote them and the labels, both by (scene, group), and
    the labelling's host seconds."""
    from himo_tpu_torch.data import h5, schema
    from himo_tpu_torch.data.synthetic import make_dataset
    from himo_tpu_torch.training import ssl_labels

    make_dataset(root, num_scenes=LOOP_SCENES, num_frames=LOOP_FRAMES, seed=0,
                 num_background=LOOP_BACKGROUND)
    written, before = {}, {}
    for scene in schema.scene_ids(root):
        path = root / f"{scene}.h5"
        before[scene] = _read_datasets(path)
        with h5.File(path) as f:
            for key in f.keys():
                written[(scene, key)] = schema.read_frame(f, key)
    labels = {}
    write = ssl_labels.write_scene_labels

    def recording(path, by_group):
        for key, arrays in by_group.items():
            labels[(Path(path).stem, key)] = dict(zip(ssl_labels.SSL_KEYS, arrays))
        return write(path, by_group)

    ssl_labels.write_scene_labels = recording
    try:
        start = time.perf_counter()
        n = ssl_labels.write_ssl_labels(root, verbose=False)
        secs = time.perf_counter() - start
    finally:
        ssl_labels.write_scene_labels = write
    if not n == len(written) == len(labels):
        raise AssertionError(f"train_loop: {n} frames labelled, {len(labels)} written, "
                             f"{len(written)} in the dataset")
    for scene, groups in before.items():
        after = _read_datasets(root / f"{scene}.h5")
        if after.keys() != groups.keys():
            raise AssertionError(f"train_loop: {scene} groups changed by the label writer")
        for key, arrays in groups.items():
            if set(after[key]) != set(arrays) | set(SSL_DTYPES):
                raise AssertionError(f"train_loop: {scene}/{key} holds {sorted(after[key])}")
            for name, arr in arrays.items():
                got = after[key][name]
                if got.dtype != arr.dtype or got.tobytes() != arr.tobytes():
                    raise AssertionError(f"train_loop: {scene}/{key}/{name} changed")
            for name, dtype in SSL_DTYPES.items():
                got, want = after[key][name], labels[(scene, key)][name]
                if got.dtype != dtype or want.dtype != dtype or \
                        got.tobytes() != want.tobytes():
                    raise AssertionError(f"train_loop: {scene}/{key}/{name} reads back "
                                         f"{got.dtype}, not what was written")
    return written, labels, secs


def traced(fn):
    """``(fn(), events)``: ``fn`` run under torch.profiler (host and
    device), and the finished trace's complete events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, _trace_events(prof)


def window_busy(events: list, label: str):
    """``(busy ms, wall ms)`` over the host ranges named ``label``: the
    union of the device events' intervals clipped to those ranges, and the
    ranges' total length."""
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name") == label and e.get("cat", "").lower() == "user_annotation"]
    if not windows:
        raise AssertionError(f"the trace holds no {label!r} range")
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    clipped = [(max(a, lo), min(b, hi)) for lo, hi in windows for a, b in device
               if a < hi and b > lo]
    return _busy_ms(clipped), sum(hi - lo for lo, hi in windows) / 1e3


@contextlib.contextmanager
def instrumented_loop(record: dict, sync_steps: bool):
    """Wrap the trainer's ``batch_iterator`` and ``make_train_step`` while
    the block runs. Each train epoch (not the val split) runs in a
    ``LOOP_LABEL`` profiler range, its wall time (device work included)
    goes to ``record["epoch_ms"]`` and the time the main thread waited for
    each batch to ``record["wait_ms"]``; with ``sync_steps`` each train
    step is synchronized on both sides and timed into ``record["step_ms"]``."""
    import torch
    from torch.profiler import record_function

    from himo_tpu_torch.training import trainer

    batch_iterator, make_train_step = trainer.batch_iterator, trainer.make_train_step

    def timed_iterator(*args, **kwargs):
        if "gt" in kwargs.get("extra_keys", ()):
            yield from batch_iterator(*args, **kwargs)
            return
        with record_function(LOOP_LABEL):
            start = time.perf_counter()
            batches = batch_iterator(*args, **kwargs)
            while True:
                wait = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                record["wait_ms"].append((time.perf_counter() - wait) * 1e3)
                yield batch
            torch.cuda.synchronize()
            record["epoch_ms"].append((time.perf_counter() - start) * 1e3)

    def timed_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)
        if not sync_steps:
            return step

        def timed_step(batch):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            record["step_ms"].append((time.perf_counter() - start) * 1e3)
            return out

        return timed_step

    trainer.batch_iterator, trainer.make_train_step = timed_iterator, timed_make_train_step
    try:
        yield record
    finally:
        trainer.batch_iterator, trainer.make_train_step = batch_iterator, make_train_step


TRAIN_VAL_LAUNCHES = dict(scatter_max_rows=4, fused_nn=1)


def phase_train_loop(device, smi: str):
    """The training entry point end to end: ``cli.train.main`` (``seflowpp``
    at full width, bf16, batch ``BATCH``, ``NUM_POINTS`` points,
    ``FUSED_POINTS`` chamfer samples) over scene files the port wrote, one
    epoch, then two with ``resume`` (the second run continues at the first
    one's step). Checks the resume step, finite metrics, the checkpoints,
    the launches (every train step's and val step's) and the frames read
    back against the arrays written; prints the host's ms per batch, the
    step in the loop against the same step alone, and the device busy
    share of the resumed run's epoch loop. Returns the launches."""
    import tempfile

    import torch

    from himo_tpu_torch.cli.train import main as train_main
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.training import trainer
    from himo_tpu_torch.training.checkpoints import CheckpointManager

    with tempfile.TemporaryDirectory(prefix="himo_train_loop_") as tmp:
        root, run_dir = Path(tmp) / "av2_train_loop", Path(tmp) / "run"
        start = time.perf_counter()
        written, labels, label_secs = _loop_dataset(root)
        size = sum(p.stat().st_size for p in root.glob("*.h5"))
        dynamic = np.mean([v["ssl_dynamic"].mean() for v in labels.values()])
        prior = np.mean([v["ssl_prior_valid"].mean() for v in labels.values()])
        log(f"[train_loop] {len(written)} frames of {written[next(iter(written))].num_points:,}"
            f" points in {LOOP_SCENES} scenes, {size / 2**20:.1f} MiB, written and labelled "
            f"in {time.perf_counter() - start:.2f} s; SSL labels (write_ssl_labels) "
            f"{label_secs:.3f} s on the host, {label_secs / len(written) * 1e3:.3f} ms per "
            f"frame; {dynamic:.4f} of points dynamic, {prior:.4f} with a prior (means over "
            f"frames); read back: ssl_* as written, every other dataset unchanged")
        kw = dict(dataset_path=str(root), model="seflowpp", batch_size=BATCH,
                  num_points=NUM_POINTS, loss_points=FUSED_POINTS, run_dir=str(run_dir),
                  device=device)
        first_record = {"wait_ms": [], "epoch_ms": [], "step_ms": []}
        reset_counts()
        with instrumented_loop(first_record, sync_steps=True):
            first = train_main(epochs=1, **kw)
        resume_step = CheckpointManager(run_dir / "ckpts_latest").latest_step()
        second_record = {"wait_ms": [], "epoch_ms": [], "step_ms": []}
        with instrumented_loop(second_record, sync_steps=False):
            second, events = traced(lambda: train_main(epochs=2, **kw))
        torch.cuda.synchronize()
        counts = read_counts()

        config = trainer.TrainConfig(batch_size=BATCH, num_points=NUM_POINTS,
                                     loss_points=FUSED_POINTS)
        dataset = SceneFlowDataset(
            root, with_pc1=True, with_history=True,
            extra_keys=("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid"),
            next_keys=("ssl_dynamic",))
        train_idx, val_idx = trainer.split_train_val(len(dataset), BATCH, config.val_fraction)
        steps_per_epoch = len(train_idx) // BATCH
        val_batches = 2 * (len(val_idx) // BATCH)
        if resume_step != steps_per_epoch or first["steps"] != steps_per_epoch:
            raise AssertionError(f"train_loop: the first run saved step {resume_step} after "
                                 f"{first['steps']} steps, not {steps_per_epoch}")
        if second["steps"] != 2 * steps_per_epoch:
            raise AssertionError(f"train_loop: the resumed run ended at step "
                                 f"{second['steps']}, not {2 * steps_per_epoch}")
        if len(second_record["epoch_ms"]) != 1:
            raise AssertionError(f"train_loop: the resumed run trained "
                                 f"{len(second_record['epoch_ms'])} epochs, not 1")
        for name, result in (("first", first), ("resumed", second)):
            bad = {k: v for k, v in result["final_metrics"].items() if not np.isfinite(v)}
            if bad or "val_total" not in result["final_metrics"]:
                raise AssertionError(f"train_loop {name} run: metrics {result['final_metrics']}")
        kept = {d: CheckpointManager(run_dir / d).all_steps() for d in ("ckpts", "ckpts_latest")}
        if kept["ckpts_latest"] != [2 * steps_per_epoch] or \
                kept["ckpts"] != [steps_per_epoch, 2 * steps_per_epoch]:
            raise AssertionError(f"train_loop: checkpoints {kept}")
        lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
        validated = [x["step"] for x in lines if "val/val_total" in x]
        if validated != [steps_per_epoch, 2 * steps_per_epoch]:
            raise AssertionError(f"train_loop: validated at steps {validated}")
        want = dict.fromkeys(counts, 0)
        for name, n in TRAIN_LAUNCHES.items():
            want[name] += second["steps"] * n
        for name, n in TRAIN_VAL_LAUNCHES.items():
            want[name] += val_batches * n
        if counts != want:
            raise AssertionError(f"train_loop launches {counts} != {want} "
                                 f"({second['steps']} train steps, {val_batches} val steps)")

        # What was written reads back, through the loop's dataset.
        for i, (scene, ts) in enumerate(dataset.data_index):
            frame, item = written[(scene, str(ts))], dataset[i]
            for key, arr in (("pc0", frame.lidar), ("pose0", frame.pose),
                             ("lidar_dt", frame.lidar_dt), ("flow", frame.flow),
                             ("gm0", frame.ground_mask),
                             ("flow_instance_id", frame.flow_instance_id),
                             *labels[(scene, str(ts))].items()):
                if item[key].dtype != arr.dtype or item[key].tobytes() != arr.tobytes():
                    raise AssertionError(f"train_loop: {scene}/{ts} {key} read back differs")

        # The host alone: one epoch of batches with nobody waiting on them,
        # and one frame's read and build.
        start = time.perf_counter()
        n_batches = sum(1 for _ in trainer.batch_iterator(
            dataset, config, 3, np.random.default_rng(0), indices=train_idx))
        host_ms = (time.perf_counter() - start) * 1e3 / n_batches
        reads, builds = [], []
        for i in train_idx:
            t0 = time.perf_counter()
            item = dataset[int(i)]
            t1 = time.perf_counter()
            trainer.build_frame_arrays(item, NUM_POINTS, 3, loss_points=FUSED_POINTS,
                                       rng=np.random.default_rng(0))
            reads.append(t1 - t0)
            builds.append(time.perf_counter() - t1)

        # The same step alone, on one of the loop's batches.
        model, _ = make_model("seflowpp", device=device, dtype="bfloat16")
        init_params(model, torch.Generator().manual_seed(0))
        optimizer, _ = trainer.make_optimizer(model.parameters(), config, steps_per_epoch)
        step = trainer.make_train_step(model, config, optimizer)
        batch = trainer.to_device(list(trainer.batch_iterator(
            dataset, config, 3, np.random.default_rng(0), indices=train_idx))[0], device)
        alone = [_timed(lambda: step(batch))[1] * 1e3 for _ in range(LOOP_ISOLATED_STEPS)]
        del model, optimizer, step, batch

    busy, wall = window_busy(events, LOOP_LABEL)
    loop_steps = first_record["step_ms"]
    log(f"[train_loop] {smi}: host {host_ms:.3f} ms per batch of {BATCH} frames "
        f"(batch_iterator alone, {n_batches} batches; a frame: read "
        f"{np.median(reads) * 1e3:.3f} ms + build {np.median(builds) * 1e3:.3f} ms, medians "
        f"of {len(reads)})")
    log(f"[train_loop] {smi}: step in the loop {np.median(loop_steps[1:]):.3f} ms (median of "
        f"steps 2-{len(loop_steps)} of the first run; {', '.join(f'{t:.3f}' for t in loop_steps)})"
        f" vs the same step alone {np.median(alone[1:]):.3f} ms (median of steps 2-"
        f"{len(alone)}; {', '.join(f'{t:.3f}' for t in alone)}); the loop's main thread "
        f"waited {np.median(first_record['wait_ms']):.3f} ms per batch (median; "
        f"{', '.join(f'{t:.3f}' for t in first_record['wait_ms'])}); epoch "
        f"{first_record['epoch_ms'][0]:.3f} ms for {steps_per_epoch} steps")
    log(f"[train_loop] {smi}: resumed run's epoch loop (profiled, steps unsynchronized): "
        f"device busy {busy:.3f} ms of {wall:.3f} ms, busy share {busy / wall:.4f}; epoch "
        f"{second_record['epoch_ms'][0]:.3f} ms, main thread waited "
        f"{np.median(second_record['wait_ms']):.3f} ms per batch (median)")
    log(f"[train_loop] launches of {second['steps']} train steps + {val_batches} val steps: "
        f"{ {k: v for k, v in counts.items() if v} }; final metrics "
        f"{ {k: round(v, 6) for k, v in second['final_metrics'].items()} }; checkpoints {kept}")
    return counts


def main(argv) -> int:
    """No arguments: every phase. ``--host-cost ROOT``: only the host cost
    per call of every wrapper (:func:`wrapper_host_us`) of the checkout at
    ROOT, as one JSON line, to compare two checkouts in one call."""
    if argv and (len(argv) != 2 or argv[0] != "--host-cost"):
        print("usage: chip_smoke.py [--host-cost ROOT]", file=sys.stderr)
        return 2
    root = Path(argv[1]).resolve() if argv else Path(__file__).resolve().parent
    if not (root / "himo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              f"(himo_tpu_torch/ not found in {root})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device, smi = phase_device()
    phase_build()
    if argv:
        print(json.dumps({"root": str(root), "host_us": wrapper_host_us(device)}))
        return 0
    clouds = _clouds(device)
    big = _clouds(device, BIG_POINTS)
    scatter = phase_scatter(device, clouds)
    resident = phase_scatter_resident(device, clouds)
    scatter_sum = phase_scatter_sum(device, clouds)
    gather = phase_gather(device, clouds)
    sorted_max, sorted_sum = phase_sorted(device, big)
    segment_sum_k10, segment_sum_k10_step = phase_sorted_sum(device, clouds)
    segment_gather_k11, sorted_gather_k5 = phase_sorted_gathers(device, clouds, big)
    segment = phase_segment_sum(device)
    phase_host_cost(device)
    nn = phase_nn(device)
    phase_nn_icp(device)
    fused = phase_fused(device)
    phase_nn_grid(device)
    pair = _nsfp_pair(device)
    knn = phase_knn(device, pair)
    torch.cuda.empty_cache()
    paths = []
    launches, run_frame, frame_ms = phase_slice(device, clouds)
    phase_profile("inference", run_frame, frame_ms)
    paths.append(launches)
    launches, run_frame, frame_ms = phase_slice(
        device, clouds, name="inference_256", expected=INFER_256_LAUNCHES, **GRID_256)
    phase_profile("inference_256", run_frame, frame_ms, calls=1)
    paths.append(launches)
    launches, run_frame, frame_ms = phase_slice(
        device, big, name=f"inference_{BIG_POINTS}", expected=INFER_BIG_LAUNCHES)
    phase_profile(f"inference_{BIG_POINTS}", run_frame, frame_ms, calls=1)
    paths.append(launches)
    launches, run_frame, frame_ms = phase_slice(
        device, clouds, name="inference_mean_sorted", expected=INFER_SORTED_LAUNCHES,
        pooling="mean_sorted")
    phase_profile("inference_mean_sorted", run_frame, frame_ms, calls=1)
    paths.append(launches)
    del clouds, big, run_frame
    torch.cuda.empty_cache()
    train, run_step, step_ms = phase_train(device)
    phase_profile("train_step", run_step, step_ms)
    paths.append(train)
    del run_step
    torch.cuda.empty_cache()
    paths.append(phase_train(device, name="train_256", steps=ROUTE_TRAIN_STEPS,
                             expected=TRAIN_256_LAUNCHES, val=False, **GRID_256)[0])
    torch.cuda.empty_cache()
    train, run_step, step_ms = phase_train(
        device, name=f"train_{BIG_POINTS}", steps=ROUTE_TRAIN_STEPS,
        expected=TRAIN_BIG_LAUNCHES, val=False, num_points=BIG_POINTS)
    phase_profile(f"train_step_{BIG_POINTS}", run_step, step_ms, calls=1)
    paths.append(train)
    del run_step
    torch.cuda.empty_cache()
    train, run_step, step_ms = phase_train(
        device, name="train_mean_sorted", steps=ROUTE_TRAIN_STEPS,
        expected=TRAIN_SORTED_LAUNCHES, val=False, pooling="mean_sorted")
    phase_profile("train_step_mean_sorted", run_step, step_ms, calls=1)
    paths.append(train)
    del run_step
    torch.cuda.empty_cache()
    cold = {}
    nsfp, run_nsfp, nsfp_ms = phase_nsfp(device, pair, cold)
    paths.append(nsfp)
    phase_profile(f"nsfp_{NSFP_PROFILE_ITERS}_steps", run_nsfp, nsfp_ms, calls=1)
    run_fastnsf, fastnsf_ms = phase_fastnsf(device, pair, cold)
    phase_profile(f"fastnsf_{NSFP_PROFILE_ITERS}_steps", run_fastnsf, fastnsf_ms, calls=1)
    del run_nsfp, run_fastnsf
    torch.cuda.empty_cache()
    paths.append(phase_opt_prior(device, pair, cold))
    paths.append(phase_icpflow(device, pair))
    del pair
    torch.cuda.empty_cache()
    launches, train, run_frame, frame_ms = phase_trust(device)
    phase_profile("inference_trust", run_frame, frame_ms, calls=1)
    paths += [launches, train]
    del run_frame
    torch.cuda.empty_cache()
    paths.append(phase_train_loop(device, smi))
    total = {k: sum(path[k] for path in paths) for k in read_counts()}
    main_nn = NN_SHAPES[0]
    kernels = [
        dict(name="scatter_max_rows", route="cuda",
             source="himo_tpu_torch/csrc/scatter_max.cu",
             replaces="himo_tpu/ops/voxelize.py:334",
             launches=total["scatter_max_rows"], **scatter),
        dict(name="scatter_max_resident_rows", route="cuda",
             source="himo_tpu_torch/csrc/scatter_max.cu",
             replaces="himo_tpu/ops/voxelize.py:63",
             launches=total["scatter_max_resident_rows"], **resident),
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
        dict(name="gather_rows", route="cuda", source="himo_tpu_torch/csrc/sorted_gather.cu",
             replaces="himo_tpu/ops/voxelize.py:554",
             launches=total["gather_rows"], **gather),
        dict(name="sorted_scatter_max_rows", route="cuda",
             source="himo_tpu_torch/csrc/sorted_scatter.cu",
             replaces="himo_tpu/ops/voxelize.py:228",
             launches=total["sorted_scatter_max_rows"], **sorted_max),
        dict(name="sorted_scatter_sum_rows", route="cuda",
             source="himo_tpu_torch/csrc/sorted_scatter.cu",
             replaces="himo_tpu/ops/voxelize.py:228",
             launches=total["sorted_scatter_sum_rows"], **sorted_sum),
        dict(name="fused_nn_idx", route="cuda", source="himo_tpu_torch/csrc/fused_nn.cu",
             replaces="himo_tpu/ops/nn.py:431",
             launches=total["fused_nn_idx"], **fused["idx"]),
        dict(name="fused_nn", route="cuda", source="himo_tpu_torch/csrc/fused_nn.cu",
             replaces="himo_tpu/ops/nn.py:431",
             launches=total["fused_nn"], **fused["min"]),
        dict(name="knn_rows", route="cuda", source="himo_tpu_torch/csrc/knn.cu",
             replaces="himo_tpu/ops/knn.py:49",
             launches=total["knn_rows"], **knn),
        dict(name="sorted_segment_sum", route="cuda",
             source="himo_tpu_torch/csrc/sorted_scatter.cu",
             replaces="himo_tpu/ops/mxu_scatter.py:75",
             launches=total["sorted_segment_sum"], **segment_sum_k10),
        dict(name=K10_STEP, route="cuda", source="himo_tpu_torch/csrc/sorted_scatter.cu",
             replaces="himo_tpu/ops/mxu_scatter.py:75",
             launches=total[K10_STEP], **segment_sum_k10_step),
        dict(name="sorted_segment_gather", route="cuda",
             source="himo_tpu_torch/csrc/sorted_gather.cu",
             replaces="himo_tpu/ops/mxu_scatter.py:300",
             launches=total["sorted_segment_gather"], **segment_gather_k11),
        dict(name="sorted_gather_rows", route="cuda",
             source="himo_tpu_torch/csrc/sorted_gather.cu",
             replaces="himo_tpu/ops/voxelize.py:630",
             launches=total["sorted_gather_rows"], **sorted_gather_k5),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
