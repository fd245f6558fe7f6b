#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Twenty-two main paths, at full width with random weights from seeded generators
(the last one trains its own):

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
  checkpoint;
- the batched fleet end to end, ``parallel/fleet.fleet_save`` at the JAX
  bench's e2e setting: 12 scenes x 5 frames x 64,800 points that the
  port's ``make_dataset`` writes, ``seflowpp`` bf16, batches of 8 at
  65,536 points, the flow written back into every scene file;
- the per-frame runner through ``himo_tpu_torch.cli.save.main``:
  ``model=fastnsf`` at its defaults (the host cluster prior, the
  scene-start repair), then ``model=seflowpp`` (bf16) from a saved
  checkpoint, on 2 scenes x 4 frames x 64,800 points;
- the flow-mode evaluation, ``cli.eval`` and ``cli.eval_flow``, on what
  those two wrote (in a temporary working directory);
- the leaderboard submission on those scenes: ``cli.save_zip`` of the
  ``perfect`` and ``seflowpp`` flows, ``cli.save_zip_gt``, zip-mode
  ``cli.eval`` and ``cli.score`` (host only; feather files read and written
  by ``io/arrow``, no pandas);
- the viz layer on those scenes (host only, no cv2, matplotlib or open3d):
  ``visualize.main`` of every frame at 960x960 coloured by lidar and by
  flow, an 8-frame APNG fly-through (``save_animation``), both de-skewed
  by the ``perfect`` flow; ``print_refine_ins`` and ``vis_refine_ins`` on
  two objects with the ``seflowpp`` flow; ``schematic.main``; every file
  written by ``viz/png`` and read back;
- downstream segmentation on those scenes: ``cli.seg_h5`` trains SegNet
  (``SegConfig()``: 512x512, depths (64, 128, 256), fp32) one epoch at
  32,768 points a frame, one frame a step, and segments ``raw``, then
  segments ``perfect`` from its checkpoint; ``cli.eval_seg`` scores both;
- downstream detection on the same scenes: ``cli.det_h5`` with
  ``detector=learned`` (DetNet at voxel 0.4: 256x256, depths (64, 128),
  one epoch) and with the geometric detector, on ``raw`` and ``perfect``;
- ingestion from raw logs written on the card's host: ``cli.extract_av2``
  on an AV2 log (12 sweeps x 100,000 points in AV2's dtypes, 80 tracks)
  and ``cli.extract_scania`` in a spawn pool of 2 workers on 2 Scania
  scenes (8 superframes x 131,072 points, 40 boxes a frame, an
  extrinsics YAML), the box test and the ground mask on the card; then
  the AV2 scenes through ``cli.save model=seflowpp`` and ``cli.eval``;
- data parallelism over ``torch.distributed``, in spawned ranks: the
  ``TrainConfig()`` train step through ``make_train_step(..., mesh)`` at
  one NCCL rank, then split over two gloo ranks sharing the card (NCCL
  refuses two ranks on one GPU), then ``fleet_save`` across those two
  ranks on a copy of the fleet's scenes;
- the quality run, ``scripts/torch_quality_evidence.py``'s ``run_one`` on
  three scenes of ``make_benchmark_dataset`` (two ordinary, one
  adversarial; 4 frames of 16,000 + 6 x 400 points): DUFO labels,
  ``train()`` of ``seflowpp`` (fp32, B8, 20,480 points, one epoch), its
  ``fleet_save`` flow, ``nsfp``, ``fastnsf10`` and ``icpflow`` through
  ``estimate_scene_flow``, ``cli.eval`` and ``cli.eval_flow`` on the suite
  and its ``scene_adv`` tranche; then ``scripts/torch_prior_diagnostic.py``
  and ``scripts/torch_flagship_diagnostic.py`` on the trained checkpoint.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every ``himo_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   and the native host library (``csrc/himo_native.cpp``) with g++, one
   compiler per source, all at once;
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
   run (launch counts checked: one step's x 2 at ``knn_k`` 0 on the card,
   whose loop replays a captured step, so the wrappers run for step 0 and
   the capture; x 500 at ``knn_k=4`` and on the CPU), final loss below the
   first, flow finite and zero on invalid points; time per step and per
   frame, peak memory, and the EPE of moving and static points against the
   known motion (printed only: random initialisation measures no quality);
7. fastnsf: the distance-field build timed alone, then the 500-step run
   (no launch of the port's kernels); the same loss and flow checks;
   then both at their defaults (``phase_opt_prior``): the host prior
   alone (host ms; finite, zero on invalid points, no launch; its coverage
   of the moving points and median error against the known motion), then
   each estimator (launches as in 6 for nsfp, none for fastnsf;
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
   busy share of the resumed run's epoch loop (traced);
10. native (``phase_native``): ``pack_frames`` bitwise against numpy at 8
   frames x <= 65,536 x 3, ``KDTree.query`` at 65,536 x 65,536 against
   scipy's float64 ``cKDTree`` (the same index wherever the two best
   distances differ by more than 1e-6 m), the Chamfer distance, and
   ``preload_files``' byte count; host ms of each;
11. fleet (``phase_fleet``): a warm pass, a timed pass (points per second
   with the write-back inside; the producer's, stacking's and readback's
   host ms per batch) and a traced pass (device busy share); checked: 3
   scatter_max_rows, 10 nn_argmin_rows and 1 nn_min_rows per batch, an
   (N, 3) float32 finite flow on every frame, every other dataset
   unchanged, and the first batch's flows against the same step with the
   plain versions (>= 0.99 of points within 1e-3 m);
12. save (``phase_save``): a flow on exactly the frames with a successor,
   every other dataset unchanged, the scene-start repair's count against
   the pairs whose backcast has tracks, and the launches (none for
   ``fastnsf``, the 512x512 forward's per frame for ``seflowpp``); host ms
   per frame;
13. eval (``phase_eval``): ``perfect`` scores below 1e-5 m of MPE and CDE,
   ``raw`` worse, every other flow (and the fleet's) finite; ``eval_flow``
   on the same flows; only the two ``res-*.json`` written, in the
   temporary directory; host ms per frame;
14. submit (``phase_submit``): ``save_zip`` of ``perfect`` and
   ``seflowpp`` and ``save_zip_gt`` (every archive holds the GT's
   sweeps); zip-mode ``cli.eval`` of each equal to flow mode, its totals
   and its printed table; ``cli.score`` of GT and of ``perfect`` against
   GT below 1e-5 m of MPE and CDE, of ``seflowpp`` finite, each writing
   ``scores.json`` and ``res-av2.json``; no kernel launched; the committed
   LZ4 feather fixture read to its generator's columns, its frames decoded
   byte for byte alike by the native library and by numpy; host ms per
   frame of each CLI, the decoders' MB/s;
15. downstream (``phase_downstream``): ``cli.seg_h5``'s step 1 held
   against the plain versions as in 5 (loss within 1e-4 relative); each
   step 1 scatter_max_rows, 1 sorted_gather_rows (K5) and 1
   scatter_sum_rows, each frame 1 scatter_max_rows; the ``seg_*`` and
   ``seg_valid`` datasets written (uint8), every other dataset unchanged;
   the first frame's logits against the plain run (argmax equal where
   the top-2 margin exceeds 1e-3, the labels written equal to it there);
   ``cli.eval_seg``'s mIoU finite; ``cli.det_h5`` learned the same way
   (1 scatter_max_resident_rows a step and a frame, finite metrics), the
   geometric detector with no launch; K1 max, K1 sum, K5 and K3 max at
   these shapes against their plain versions and timed beside their
   library calls; ms per train step and per frame (wall, traced device
   busy, busy share), host ms a frame of the geometric detector;
16. ingest (``phase_ingest``, after submit): every file the card's
   extraction wrote against the same extraction with ``device="cpu"``
   (every group and dataset bitwise, apart from box ids within 1e-4 m of
   a face, at most 1e-4 of the points), the ground masks against the
   generator's labels (>= 0.95 of road points ground, <= 0.05 of object
   points), a second ``main`` of each printing the skip line and leaving
   every file's bytes and ``index_total.pkl``, no kernel launched; the
   AV2 scenes through ``cli.save model=seflowpp`` (the 512x512 forward's
   launches a frame) and ``cli.eval`` (``perfect`` below 1e-5 m, ``raw``
   worse); host ms a frame by stage, ``ground_mask`` and
   ``points_in_boxes`` on the card (CUDA events, traced) and on the CPU,
   the spawn workers' device memory;
17. data parallel (``phase_data_parallel``, after fleet; each spawn of
   ranks has a time limit, and a rank's failure or timeout fails the
   phase): (a) one NCCL rank, 2 steps of the B8 step through the mesh
   (the step's launches each), each all-reduce handing back the rank's
   gradients bitwise and the parameters bitwise equal to a twin stepped
   without a mesh on the same gradients (two plain backward passes of one
   batch are compared too: float atomics may make them differ); (b) two
   gloo ranks on the card, the B8 batch split in two, 2 steps (the step's
   launches each, on each rank): the parameters bitwise equal across the
   ranks after each step (digests; step 2 moves them), step 1's reduced
   gradients against rank 0's one-process B8 step as in 5; (c)
   ``fleet_save`` across the two ranks on a copy of the fleet's scenes:
   each scene written once, ``mesh_shards`` 2, every frame counted, >=
   0.99 of points within 1e-3 m of the one-rank fleet's flows, the
   launches per batch as in 11; printed: each rank's step ms, the gradient
   bucket's MB, the all-reduce's ms (gloo's "through the host"), the
   fleet's points/s ("two ranks sharing one card");
18. viz (``phase_viz``, after submit, on ``phase_save``'s scenes, in a
   temporary directory): the files above, each PNG and the APNG's frames
   read back by ``viz/png``'s readers equal to the images in memory, the
   file names ``{scene_id}_{timestamp}_perfect.png``, ``perfect``'s
   instance MPE below 1e-5 m, the APNG's delays 1/10 s, no kernel
   launched, none of cv2, matplotlib, open3d and PIL in ``sys.modules``;
   host ms per frame by stage (read, ``prepare_frame``, render, encode),
   the files' sizes, the phase's seconds.
19. fleet stages (``phase_fleet_stages``, after eval, the last phase on the
   fleet's scenes): the stage table of
   ``scripts/torch_profile_fleet.py`` over the fleet's scenes (decode,
   rigid flow, ``frame_to_arrays``, the native pack, the pinned upload with
   the step's launch, the synchronize with the readback, the write-back)
   and the device's busy ms a batch from a traced pass;
20. quality (``phase_quality``, last, in a temporary working directory):
   the table (CDE, MPE, EPE 3-way / FD / BS, AccS, AccR of ``raw``,
   ``seflowpp``, ``nsfp``, ``fastnsf10``, ``icpflow``, the suite and its
   ``[adv]`` tranche) with every cell finite, ``nsfp``'s and ``fastnsf10``'s
   MPE below ``raw``'s on the suite (``seflowpp``'s is printed, not gated:
   one epoch on 9 frames), each step's seconds and launches, each step
   launching its kernels (``QUALITY_STEP_KERNELS``), the four ``res-*.json``
   files and nothing else written there, the two diagnostics' lines.

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
import os
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
NSFP_SEGMENT = (1, 65536, 65536)  # nsfp's chamfer backward: (B, N, rows)
FUSED_POINTS = 16384  # TrainConfig().loss_points
SLICE_TOL_M = 1e-3  # refined points, kernels vs plain versions
CORR_SHAPE = (8, 512, 512, 32)  # the BEV correlation's bf16 pillar images at 512x512
CORR_LEVELS = ((2, 4), (8, 3))  # its levels: 256x256 r = 4, 64x64 r = 3
# The correlation's backward against its plain version: both add the same
# exact bf16 products in fp32, in two orders (at most 130 terms: under
# 2^-16 of the gradient of the absolute values, M), and round once to bf16
# (one ulp apart at most, 2^-7 of the value).
CORR_GRAD_REL, CORR_GRAD_ABS = 2.0**-7, 2.0**-16
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
L2_FLUSH_FLOATS = 32 << 20  # 128 MiB written before each cold call: over twice the L2
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
# The native host library: the fleet's packer at its batch, the KD-tree at
# the eval chamfer's full-frame size, the page-cache preload.
NATIVE_FRAMES = (64800, 70000, 61000, 65536, 64800, 58000, 66000, 64800)
NATIVE_TREE = 65536
NATIVE_TIE_M = 1e-6  # indices compared where the two best distances differ by more
NATIVE_RUNS = 5
# The fleet: the JAX bench's end-to-end cell (bench.py:158-180), 12 scenes x
# 5 frames x 64,800 points, batches of 8 at 65,536 points.
FLEET_SCENES, FLEET_FRAMES, FLEET_BACKGROUND = 12, 5, 64000
FLEET_LABEL = "fleet pass"
# Data parallelism (phase_data_parallel): the 512x512 train step at
# TrainConfig() through make_train_step(..., mesh), NCCL at one rank, then
# gloo at two ranks on the one card (NCCL refuses two ranks on one GPU), the
# global batch of BATCH frames split over them; the fleet on a copy of
# phase_fleet's scenes across the two gloo ranks.
DP_STEPS = 2
DP_WORLD = 2
DP_TIMEOUT_S = 600.0  # each spawn of ranks, their start included
DP_ALLREDUCE_ITERS = 20
DP_FLEET_KEY = "fleet_dp"
# A picklable function each spawned rank calls first (None on the card; the
# CPU rehearsal's toy setting in tests/torch_rehearsal.py).
DP_RANK_SETUP = None
# cli.save: 2 scenes x 4 frames x 64,800 points with a perfect method flow
# for the eval.
SAVE_SCENES, SAVE_FRAMES, SAVE_BACKGROUND = 2, 4, 64000
EVAL_PERFECT_MAX = 1e-5  # tests/test_eval_pipeline.py's bound on perfect's MPE and CDE
# The leaderboard submission (save_zip, save_zip_gt, zip-mode cli.eval,
# cli.score) on phase_save's scenes, and the committed LZ4 feather fixture
# (pandas-written; the card's host has no pandas to write one).
SUBMIT_METHODS = ("perfect", "seflowpp")
LZ4_FIXTURE = Path("tests") / "data" / "lz4_fixture.py"
LZ4_RUNS = 5
# The viz layer (host only) on phase_save's scenes: every frame rendered at
# 960x960 by visualize.main, coloured by lidar and by flow, instance panels
# of two objects, an 8-frame APNG fly-through, the schematic. The frames
# are de-skewed by the generator's perfect flow, which every frame holds
# (cli.save writes no flow on a scene's last frame); the instances are
# scored and drawn with the flow cli.save wrote on the card.
VIZ_FLOW = "perfect"
VIZ_INSTANCE_FLOW = "seflowpp"
VIZ_RESOLUTION = 960
VIZ_COLORS = ("lidar", "flow")
VIZ_INSTANCES = [1, 2]
VIZ_ANIMATION_FRAMES = 8
VIZ_ABSENT = ("cv2", "matplotlib", "open3d", "PIL")  # the port writes images without them
# Ingestion (cli.extract_av2, cli.extract_scania) from raw logs written on
# the card's host: one AV2 log of 12 sweeps x 100,000 points (about AV2's
# two stacked 32-beam LiDARs) with 80 cuboid tracks, one of which leaves
# before the last sweep, in AV2's own lidar dtypes; 2 Scania scenes x 8
# superframes x BIG_POINTS with 5 sensors and 40 boxes a frame, one of
# infinite speed, and the vehicle's extrinsics YAML.
INGEST_AV2_LOG = "0c6e62d7-bdfa-3061-8d3d-03b13aa21f68"
INGEST_AV2_SWEEPS, INGEST_AV2_POINTS, INGEST_AV2_TRACKS = 12, 100_000, 80
INGEST_SCANIA_SCENES, INGEST_SCANIA_FRAMES, INGEST_SCANIA_BOXES = 2, 8, 40
INGEST_SCANIA_SENSORS = 5
INGEST_OBJECT_POINTS = 150  # points of each annotated object a sweep
INGEST_STRUCTURE_SHARE = 0.15  # walls: neither ground nor an object
INGEST_BOX_BOTTOM_M = 0.15  # objects' bottom faces above the road
INGEST_NPROC = 2  # extract_scania's spawn pool on the card
INGEST_FACE_TOL_M = 1e-4  # box ids compared exactly farther than this from a face
INGEST_FACE_SHARE = 1e-4  # most points allowed that near a face
INGEST_GROUND_MIN, INGEST_OBJECT_GROUND_MAX = 0.95, 0.05
INGEST_RUNS = 3  # CPU calls of ground_mask / points_in_boxes timed
# (category, (length, width, height) m, top speed m/s), AV2's names and
# Scania's pseudo-label names.
AV2_OBJECTS = (("REGULAR_VEHICLE", (4.6, 1.9, 1.6), 12.0), ("PEDESTRIAN", (0.6, 0.6, 1.75), 1.5),
               ("BICYCLIST", (1.8, 0.6, 1.7), 6.0), ("BOX_TRUCK", (6.0, 2.3, 3.0), 10.0),
               ("CONSTRUCTION_CONE", (0.4, 0.4, 0.7), 0.0))
SCANIA_OBJECTS = (("car", (4.6, 1.9, 1.6), 12.0), ("pedestrian", (0.6, 0.6, 1.75), 1.5),
                  ("bicycle", (1.8, 0.6, 1.7), 6.0), ("truck", (6.5, 2.5, 3.2), 10.0),
                  ("bus", (6.8, 2.5, 3.2), 8.0))
SCANIA_LIDARS = ("FrontLeft", "FrontRight", "RearLeft", "RearRight", "Roof")
INGEST_BOX_DATASETS = ("flow", "flow_is_valid", "flow_category_indices", "flow_instance_id")
# Downstream (cli.seg_h5, cli.eval_seg, cli.det_h5) on phase_save's scenes at
# the reference's defaults: 32,768 points a frame, SegConfig() (512x512,
# depths (64, 128, 256)), DetNetConfig() at det_h5's voxel 0.4 (256x256,
# depths (64, 128)), fp32, one frame a step and a call, one epoch.
DOWNSTREAM_POINTS = 32768
DOWNSTREAM_MODES = ("raw", "perfect")
SEG_OVERRIDES = {}  # SegConfig fields, passed through cli.seg_h5
DET_VOXEL = 0.4  # cli.det_h5's voxel
DOWNSTREAM_TRACE_CALLS = 3
SEG_MARGIN = 1e-3  # argmax compared where the top-2 logit margin exceeds this
# SegNet on the table route: the pillar max (K1 max), its backward's take
# (K5) and the gather's backward (K1 sum); DetNet on the resident route: the
# pillar max (K3 max), its backward plain indexing.
SEG_STEP_LAUNCHES = dict(scatter_max_rows=1, sorted_gather_rows=1, scatter_sum_rows=1)
SEG_FRAME_LAUNCHES = dict(scatter_max_rows=1)
DET_STEP_LAUNCHES = dict(scatter_max_resident_rows=1)
DET_FRAME_LAUNCHES = dict(scatter_max_resident_rows=1)
DOWNSTREAM_LABEL = "downstream call"
# The quality run (scripts/torch_quality_evidence.py's run_one) on a small
# suite: make_benchmark_dataset's first QUALITY_SCENES ordinary scenes and
# QUALITY_ADV_SCENES adversarial one, 4 frames each, at the script's default
# density (16,000 background + 6 x 400 object points a frame); DUFO labels,
# seflowpp trained QUALITY_EPOCHS epoch at 20,480 points, its fleet flow,
# nsfp, fastnsf10 and icpflow; then the evaluations and the two diagnostics
# (the flagship's on QUALITY_DIAG_FRAMES frames).
QUALITY_SCENES, QUALITY_ADV_SCENES = 2, 1
QUALITY_EPOCHS = 1
QUALITY_POINTS = 20480
QUALITY_BACKGROUND, QUALITY_OBJECT_POINTS = 16000, 400
QUALITY_DIAG_FRAMES = 2
QUALITY_GATED = ("nsfp", "fastnsf10")  # MPE below raw's on the full suite
# Kernels each step must launch (none routed to its plain version): the
# train step's K1 max, K1 sum, K5, K3 sum and K8; the fleet forward's K1
# max, K7 and K6; K7 in the optimisation estimators' chamfer and ICP.
QUALITY_STEP_KERNELS = {
    "train seflowpp": ("scatter_max_rows", "scatter_sum_rows", "sorted_gather_rows",
                       "segment_rows_sum", "fused_nn_idx"),
    "fleet seflowpp": ("scatter_max_rows", "nn_argmin_rows", "nn_min_rows"),
    "opt nsfp": ("nn_argmin_rows", "segment_rows_sum"),
    "opt icpflow": ("nn_argmin_rows",),
    "flagship_diagnostic": ("scatter_max_rows", "nn_argmin_rows", "nn_min_rows"),
}
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
LEAD_LABEL = "trace lead"
# One-element fills that open every trace (:func:`traced`). A trace of
# short calls now and then loses the device events of its first calls, a
# count that grows with the process's age, about one for every 12 s
# (scripts/torch_profiler_probe.py: 4 at 60 s, 11 at 150 s, 24 at 300 s).
LEAD_FILLS = 2048
LEAD_LOST: list = []  # the fills that lost their device event, per trace
TRAIL_S = 0.01  # the host's wait after a trace's last call, before it stops
SPLIT_WHOLE = 0.75  # the share of device_split's calls that must be whole


def _trace_events(prof) -> list:
    """The complete events of a finished torch.profiler trace (chrome-trace
    dicts: ``name``, ``cat``, ``ts`` and ``dur`` in us, ``args``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


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


def device_split(fn, iters: int = 20) -> dict:
    """Device milliseconds per call of ``fn`` (warm) by pass: the kernel,
    memset and memcpy durations of ``iters`` calls traced by :func:`traced`,
    summed by :func:`short_name` and divided by the calls counted. Each
    call runs in a range of its own, its device events tied to it by
    correlation id (:func:`split_calls`), and one untimed call closes the
    trace. A call with fewer device events than the most any call held is
    left out and named; fails unless ``SPLIT_WHOLE`` of the calls are
    whole."""
    from torch.profiler import record_function

    fn()

    def run():
        for i in range(iters + 1):
            with record_function(f"{SPLIT_LABEL}{i}"):
                fn()

    _, events = traced(run)
    per_call = split_calls(events, range(iters))
    most = max(len(c) for c in per_call)
    lost = [i for i, c in enumerate(per_call) if len(c) < most]
    if most == 0 or len(lost) > (1 - SPLIT_WHOLE) * iters:
        raise AssertionError(f"device_split: device events per call "
                             f"{[len(c) for c in per_call]} in a trace of {iters} calls")
    if lost:
        log(f"device_split: calls {lost} of {iters} lacked a device event and were left out")
    whole = [c for c in per_call if len(c) == most]
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


def cold_device_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn`` (:func:`device_ms`) with a
    cold L2: a buffer of ``L2_FLUSH_FLOATS`` floats, larger than the card's
    L2, is written before each call, so that what ``fn`` reads comes from
    memory and the L2 holds another buffer's lines, as within a step; the
    passes of that write (those a trace of the write alone holds) are left
    out of the sum."""
    import torch

    flush = torch.empty(L2_FLUSH_FLOATS, device="cuda")

    def write():
        flush.fill_(1.0)

    own = set(device_split(write, iters))
    split = device_split(lambda: (write(), fn()), iters)
    return sum(ms for name, ms in split.items() if name not in own)


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
    from himo_tpu_torch.ops import correlation as pcorr
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
        (pcorr, "correlation_pool"): pcorr._correlation_pool_plain,
        (pcorr, "correlation_volume"): pcorr._correlation_volume_plain,
        (pcorr, "correlation_backward"): pcorr._correlation_backward_plain,
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
    """Every ``csrc/*.cu`` with nvcc and the native host library with the
    C++ compiler, one compiler process each, all at once."""
    from himo_tpu_torch import native
    from himo_tpu_torch.kernels import _build

    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    cxx = native.compiler()
    if cxx is None:
        raise RuntimeError("native: no C++ compiler")
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(native.build, cxx)
        paths = dict(zip(names, pool.map(_build.build, names)))
        host_lib = host.result()
    log(f"build {', '.join(names)} and {native.SOURCE.name}: "
        f"{time.perf_counter() - start:.2f} s in parallel")
    log(f"  himo_native -> {host_lib.name} ({cxx})")
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


def check_sum(name, got, want, mag):
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
    err = check_sum(name, got, want, mag)
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


def _check_gather(name, fn, plain, args, ids, library, cold=False):
    """Hold a row gather ``fn(image, ids, ...)`` bitwise against its plain
    version; time both and the ``library`` call. Bound: the (B, N) id
    tensors among ``args`` read once, the image rows the ids reach read
    once, the output written once; the kernel's share of it (bound over
    device ms) is printed. With ``cold``, the kernel's device ms with a
    cold L2 (:func:`cold_device_ms`) and its share of the bound too."""
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
        f"{dev['library_device_ms']:.4f} ms; bound {lower['bound_ms']:.4f} ms, "
        f"device time at {lower['bound_ms'] / dev['device_ms']:.3f} of its bound")
    if cold:
        cold_ms = cold_device_ms(lambda: fn(*args))
        log(f"{name}: cold L2, device {cold_ms:.4f} ms, at "
            f"{lower['bound_ms'] / cold_ms:.3f} of its bound")
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
    it; then K5 at path B's 131,072 points. K5 is also timed with a cold
    L2 at both."""
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
                       lambda: torch.index_select(table, 0, flat), cold=True)
    sort_ms = cuda_ms(lambda: pvox._stable_sort(pids))
    bpids, _ = _pillar_ids(big)
    bsorted, border = pvox._stable_sort(bpids)
    bflat = _flat_rows(bpids, rows)
    _check_gather(f"sorted_gather_rows (path B, {bpids.shape[1]} points)",
                  pvox.sorted_gather_rows, pvox._sorted_gather_rows_plain,
                  (image, bsorted, border), bpids, lambda: torch.index_select(table, 0, bflat),
                  cold=True)
    big_sort_ms = cuda_ms(lambda: pvox._stable_sort(bpids))
    log(f"sorted_gather_rows: the table route's stable argsort of the ids "
        f"{sort_ms:.4f} ms ({NUM_POINTS} points), {big_sort_ms:.4f} ms "
        f"({bpids.shape[1]} points; the stream route reuses its forward's)")
    return k11[GATHER_CHANNELS], k5


def phase_segment_sum(device):
    """K3 sum at both train-step shapes, take_rows' backward (16,384 rows
    of 3 into 65,536) and the fused NN backward (32,768 into 16,384), and at
    ``nsfp``'s chamfer backward (1 x 65,536 into 65,536): bitwise equal to
    the CPU's sequential ``index_add_`` (the plain version on host copies)
    and to itself over two calls, since it adds each row in point order.
    At these shapes CUDA events over back-to-back calls time the host's
    work per call as much as the device's, so each call, and
    ``torch.zeros`` + ``index_add_``, is also timed by the device alone
    (``device_ms``: kernels plus memsets per call, from a trace of the same
    loop)."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    out = {}
    for b, n, rows in [(BATCH, n, rows) for n, rows in SEGMENT_SHAPES] + [NSFP_SEGMENT]:
        gen = torch.Generator(device=device).manual_seed(n + rows)
        ids = torch.randint(0, rows, (b, n), device=device, generator=gen,
                            dtype=torch.int32)
        ids[:, :64] = 5  # duplicates onto one row
        vals = torch.randn(b, n, 3, device=device, generator=gen)
        got = pnn.segment_rows_sum(vals, ids, rows)
        again = pnn.segment_rows_sum(vals, ids, rows)
        want = pnn._segment_rows_sum_plain(vals.cpu(), ids.cpu(), rows)
        torch.cuda.synchronize()
        if not (torch.equal(got.cpu(), want) and torch.equal(again, got)):
            raise AssertionError(f"segment_rows_sum B={b} {n}->{rows}: not bitwise the "
                                 f"sequential index_add_ (max abs err "
                                 f"{float((got.cpu() - want).abs().max())})")
        ms = cuda_ms(lambda: pnn.segment_rows_sum(vals, ids, rows), iters=50)
        plain_ms = cuda_ms(lambda: pnn._segment_rows_sum_plain(vals, ids, rows), iters=50)
        flat = _flat_rows(ids, rows)
        src = vals.reshape(-1, 3)

        def library():  # a new zeroed table, as the wrapper returns
            return torch.zeros(b * rows + 1, 3, device=device).index_add_(0, flat, src)

        library_ms = cuda_ms(library, iters=50)
        dev = device_times(lambda: pnn.segment_rows_sum(vals, ids, rows), library, iters=50)
        log(f"segment_rows_sum B={b} {n}x3 -> {rows}: bitwise the CPU's sequential "
            f"index_add_ and itself; events per call: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, zeros + index_add_ {library_ms:.4f} ms; device per call "
            f"(sort, take, memset, sum): kernel {dev['device_ms'] * 1e3:.3f} us, zeros + "
            f"index_add_ {dev['library_device_ms'] * 1e3:.3f} us")
        pts = b * n
        out[(n, rows)] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, **dev,
                              **bound(pts * 4 + pts * 12 + b * rows * 12, pts * 3))
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
    backward's shape split by part (checks, allocation, binding, the launch
    helper's device guard when the device is current, stream, the ctypes
    call), as it runs now and as its parent ran it, replayed
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
    current_device = torch._C._cuda_getDevice
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
            "device guard": lambda: current_device() == index,
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
    check_sum("segment_rows_sum on a side stream", got,
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


def _same_bits(name, got, want) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit (bf16 or fp32)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    torch.cuda.synchronize()
    a, b = got.contiguous().view(ints), want.contiguous().view(ints)
    if a.shape != b.shape or not torch.equal(a, b):
        bad = int((a != b).sum()) if a.shape == b.shape else a.numel()
        raise AssertionError(f"{name} kernel differs from plain in {bad} values")


def phase_correlation(device):
    """The BEV correlation's three kernels at the main path's shapes
    (``CORR_SHAPE`` bf16 images at ``CORR_LEVELS``), each against its plain
    version: ``correlation_pool`` and ``correlation_volume`` bit for bit
    (``ops.correlation.torch_order`` holds these shapes to torch's orders),
    ``correlation_backward`` within ``CORR_GRAD_REL |ref| + CORR_GRAD_ABS M``
    of its plain version for cotangents at both levels. Returns the kernels
    line's rows for the three, each timed over one forward's or backward's
    calls."""
    import torch

    from himo_tpu_torch.ops import correlation as pcorr

    b, hh, ww, c = CORR_SHAPE
    gen = torch.Generator(device=device).manual_seed(21)
    img0, img1 = (torch.randn(CORR_SHAPE, device=device, generator=gen).to(torch.bfloat16)
                  for _ in range(2))
    pools = [s for s, _ in CORR_LEVELS]

    def pool(fn=None):
        return (fn or pcorr.correlation_pool)(img0, img1, pools)

    pooled, plain_pooled = pool(), pool(pcorr._correlation_pool_plain)
    for (g0, g1), (w0, w1), s in zip(pooled, plain_pooled, pools):
        _same_bits(f"correlation_pool s={s} (image 0)", g0, w0)
        _same_bits(f"correlation_pool s={s} (image 1)", g1, w1)

    def volumes(fn=None, pairs=pooled):
        return [(fn or pcorr.correlation_volume)(p0, p1, r)
                for (p0, p1), (_, r) in zip(pairs, CORR_LEVELS)]

    vols = volumes()
    for got, want, (s, r) in zip(vols, volumes(pcorr._correlation_volume_plain, plain_pooled),
                                 CORR_LEVELS):
        _same_bits(f"correlation_volume s={s} r={r}", got, want)
    grads = [torch.randn(v.shape, device=device, generator=gen).to(torch.bfloat16)
             for v in vols]

    def backward(fn=None):
        return (fn or pcorr.correlation_backward)(grads, pooled, CORR_LEVELS, img0.shape)

    got = backward()
    want = backward(pcorr._correlation_backward_plain)
    mag = pcorr._correlation_backward_plain(
        [g.abs() for g in grads], [(p0.abs(), p1.abs()) for p0, p1 in pooled], CORR_LEVELS,
        img0.shape)
    worst, back_err = 0.0, 0.0
    for g_, w_, m_ in zip(got, want, mag):
        err = (g_.float() - w_.float()).abs()
        limit = CORR_GRAD_REL * w_.float().abs() + CORR_GRAD_ABS * m_.float()
        worst = max(worst, float((err / (limit + 1e-30)).max()))
        back_err = max(back_err, float(err.max()))
    if worst > 1.0:
        raise AssertionError(f"correlation_backward: {worst:.3f} of its bound off the plain "
                             f"version")
    size = 2  # bf16
    pooled_bytes = [2 * b * (hh // s) * (ww // s) * c * size for s in pools]
    image_bytes = 2 * b * hh * ww * c * size
    vol_bytes = [v.numel() * size for v in vols]
    products = sum(2 * b * (hh // s) * (ww // s) * (2 * r + 1) ** 2 * c for s, r in CORR_LEVELS)
    rows = {}
    for name, fn, plain, err, moved, ops in (
            ("correlation_pool", pool, lambda: pool(pcorr._correlation_pool_plain), 0.0,
             image_bytes + sum(pooled_bytes), b * hh * ww * c * 2 * len(pools)),
            ("correlation_volume", volumes,
             lambda: volumes(pcorr._correlation_volume_plain, plain_pooled), 0.0,
             sum(pooled_bytes) + sum(vol_bytes), products),
            ("correlation_backward", backward,
             lambda: backward(pcorr._correlation_backward_plain), back_err,
             sum(vol_bytes) + sum(pooled_bytes) + image_bytes, 2 * products)):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                          **device_times(fn, iters=10), **bound(moved, ops))
        agree = "bitwise equal" if err == 0.0 else f"{worst:.3f} of its bound off"
        log(f"{name} B={b} C={c} {hh}x{ww} bf16 at {CORR_LEVELS}: {agree} the plain "
            f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; device "
            f"{rows[name]['device_ms']:.4f} ms; bound {rows[name]['bound_ms']:.4f} ms")
    return rows


# The BEV correlation of every forward: one pooling, one volume a level.
CORR_LAUNCHES = dict(correlation_pool=1, correlation_volume=2)
INFER_LAUNCHES = dict(scatter_max_rows=3, nn_argmin_rows=10, nn_min_rows=1, **CORR_LAUNCHES)
INFER_256_LAUNCHES = dict(scatter_max_resident_rows=3, gather_rows=1, nn_argmin_rows=10,
                          nn_min_rows=1, **CORR_LAUNCHES)
INFER_BIG_LAUNCHES = dict(sorted_scatter_max_rows=3, nn_argmin_rows=10, nn_min_rows=1,
                          **CORR_LAUNCHES)
INFER_SORTED_LAUNCHES = dict(sorted_segment_sum=3, sorted_segment_gather=1,
                             nn_argmin_rows=10, nn_min_rows=1, **CORR_LAUNCHES)


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

    def run():
        start = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / calls

    prof_wall, events = traced(run)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
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
# The correlation's backward: one gather a level.
CORR_TRAIN_LAUNCHES = dict(CORR_LAUNCHES, correlation_backward=2)
TRAIN_LAUNCHES = dict(scatter_max_rows=4, scatter_sum_rows=1, fused_nn_idx=1,
                      segment_rows_sum=3, sorted_gather_rows=3, **CORR_TRAIN_LAUNCHES)
TRAIN_256_LAUNCHES = dict(scatter_max_resident_rows=4, gather_rows=1, fused_nn_idx=1,
                          segment_rows_sum=4, **CORR_TRAIN_LAUNCHES)
TRAIN_BIG_LAUNCHES = dict(sorted_scatter_max_rows=4, sorted_scatter_sum_rows=1,
                          fused_nn_idx=1, segment_rows_sum=3, sorted_gather_rows=3,
                          **CORR_TRAIN_LAUNCHES)
# mean_sorted: K10 pools three sweeps, K11 gathers; their backwards are each
# other (K11 x 3, K10 x 1 at C = 65); the un-sort's take_rows adds one K3 sum.
TRAIN_SORTED_LAUNCHES = {"scatter_max_rows": 1, "sorted_segment_sum": 3, K10_STEP: 1,
                         "sorted_segment_gather": 4, "fused_nn_idx": 1,
                         "segment_rows_sum": 4, **CORR_TRAIN_LAUNCHES}


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
        want_val.update(TRAIN_VAL_LAUNCHES)
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


def nsfp_calls(knn_k: int, device) -> int:
    """The steps of an NSFP_ITERS-step nsfp run whose kernel wrappers the
    host calls: on a card at ``knn_k`` 0 the loop replays a CUDA graph of
    its step (``run_adam(cuda_graph=True)``), so step 0 and the capture;
    else every step."""
    import torch

    return 2 if knn_k == 0 and torch.device(device).type == "cuda" else NSFP_ITERS


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
        want = {key: v * nsfp_calls(k, device) for key, v in per_step.items()}
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
    estimator through the registry (launches: ``nsfp_calls(0, device)`` x
    one step's for nsfp, none for fastnsf; final loss below the first; flow finite and
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
            want.update(nn_argmin_rows=2 * nsfp_calls(0, device),
                        segment_rows_sum=nsfp_calls(0, device))
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
    device), and the finished trace's complete events. ``LEAD_FILLS``
    one-element fills, in a ``LEAD_LABEL`` range, open the trace and take
    the loss of its first device events in place of ``fn``'s; their events
    are left out, and how many of them were lost goes to ``LEAD_LOST``.
    Fails when all of them were lost, as the loss may then reach ``fn``.
    The host waits ``TRAIL_S`` after ``fn`` before the trace stops, a
    guard: the probe once lost 5 of 100 calls after the first, in a trace
    whose kernels started 0.6 ms or more after their launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fill = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(LEAD_LABEL):
            for _ in range(LEAD_FILLS):
                fill.zero_()
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRAIL_S)
    events, kept = without_lead(_trace_events(prof))
    LEAD_LOST.append(LEAD_FILLS - kept)
    if kept == 0:
        raise AssertionError(f"traced: the trace lost the device events of all "
                             f"{LEAD_FILLS} fills that open it")
    return out, events


def without_lead(events: list) -> tuple:
    """``(events, kept)``: a trace's events without the device events of
    the launches in its ``LEAD_LABEL`` range, and how many of those it held."""
    lo, hi = next((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == LEAD_LABEL
                  and e.get("cat", "").lower() == "user_annotation")
    lead = {e["args"]["correlation"] for e in events if e.get("cat") in LAUNCH_CATS
            and "correlation" in e.get("args", {}) and lo <= e["ts"] <= hi}
    rest = [e for e in events if e.get("cat") not in DEVICE_CATS
            or e.get("args", {}).get("correlation") not in lead]
    return rest, len(events) - len(rest)


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


TRAIN_VAL_LAUNCHES = dict(scatter_max_rows=4, fused_nn=1, **CORR_LAUNCHES)


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


def _median_ms(fn, runs: int = NATIVE_RUNS):
    """(last result, median host ms) of ``runs`` calls of ``fn``."""
    times, out = [], None
    for _ in range(runs):
        start = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - start) * 1e3)
    return out, float(np.median(times))


def phase_native(smi: str) -> None:
    """The native host library on the card's host: ``pack_frames`` bitwise
    against numpy's pad and stack at the fleet's batch (8 frames, one
    longer than the 65,536-point budget), ``KDTree.query`` at 65,536 x
    65,536 against scipy's float64 ``cKDTree`` (the same index wherever
    the two best float64 distances differ by more than ``NATIVE_TIE_M``),
    the Chamfer distance against ``cKDTree``'s, and ``preload_files``'
    byte count; host ms of each beside scipy's and numpy's."""
    import tempfile

    from scipy.spatial import cKDTree

    from himo_tpu_torch import native
    from himo_tpu_torch.data.synthetic import lidar_like_cloud

    if not native.available():
        raise AssertionError("native: the library is not available on the card's host")
    rng = np.random.default_rng(0)
    frames = [rng.normal(0, 20, (n, 3)).astype(np.float32) for n in NATIVE_FRAMES]
    (batch, valid), pack_ms = _median_ms(lambda: native.pack_frames(frames, NUM_POINTS))

    def numpy_pack():
        out = np.zeros((len(frames), NUM_POINTS, 3), np.float32)
        for b, f in enumerate(frames):
            out[b, : min(len(f), NUM_POINTS)] = f[:NUM_POINTS]
        return out

    want, numpy_ms = _median_ms(numpy_pack)
    if batch.tobytes() != want.tobytes() or \
            valid.sum(1).tolist() != [min(n, NUM_POINTS) for n in NATIVE_FRAMES]:
        raise AssertionError("native: pack_frames differs from numpy's pad and stack")

    tree_pts = lidar_like_cloud(np.random.default_rng(1), 1, NATIVE_TREE)[0]
    queries = lidar_like_cloud(np.random.default_rng(2), 1, NATIVE_TREE)[0] + np.float32(0.05)
    (dist, idx), kd_ms = _median_ms(lambda: native.KDTree(tree_pts).query(queries))
    (ref_d, ref_i), ckd_ms = _median_ms(
        lambda: cKDTree(tree_pts.astype(np.float64)).query(queries.astype(np.float64), k=2))
    clear = ref_d[:, 1] - ref_d[:, 0] > NATIVE_TIE_M
    wrong = int((idx[clear] != ref_i[clear, 0]).sum())
    d_err = float(np.abs(dist.astype(np.float64) - ref_d[:, 0]).max())
    if wrong or d_err > 1e-4:
        raise AssertionError(f"native: KDTree.query differs from cKDTree on {wrong} of "
                             f"{int(clear.sum())} untied queries (max distance error {d_err})")
    cham, cham_ms = _median_ms(lambda: native.chamfer(tree_pts, queries))
    ref_cham = (ref_d[:, 0].mean() + cKDTree(queries.astype(np.float64)).query(
        tree_pts.astype(np.float64))[0].mean()) / 2
    if abs(cham - ref_cham) > 1e-5 * max(ref_cham, 1.0):
        raise AssertionError(f"native: chamfer {cham} against cKDTree's {ref_cham}")

    with tempfile.TemporaryDirectory(prefix="himo_native_") as tmp:
        paths = []
        for k, n in enumerate((4 << 20, (8 << 20) + 123, 77)):
            path = Path(tmp) / f"file{k}.bin"
            path.write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
            paths.append(path)
        size = sum(p.stat().st_size for p in paths)
        got, preload_ms = _median_ms(lambda: native.preload_files(paths))
    if got != size:
        raise AssertionError(f"native: preload_files returned {got} bytes of {size}")
    log(f"[native] {smi}: pack_frames {len(frames)} x <= {NUM_POINTS} x 3 {pack_ms:.3f} ms "
        f"(numpy pad + stack {numpy_ms:.3f}), bitwise equal; KDTree build + query "
        f"{NATIVE_TREE:,} x {NATIVE_TREE:,} {kd_ms:.3f} ms (cKDTree float64 k=2 "
        f"{ckd_ms:.3f}), the same index on all {int(clear.sum()):,} queries whose two best "
        f"distances differ by more than {NATIVE_TIE_M} m ({len(queries) - int(clear.sum())} "
        f"near-ties), max distance error {d_err:.3g} m; chamfer {cham_ms:.3f} ms "
        f"({cham:.6f} m, cKDTree {ref_cham:.6f}); preload_files {size:,} bytes in "
        f"{preload_ms:.3f} ms (medians of {NATIVE_RUNS}; {len(os.sched_getaffinity(0))} cores)")


FLEET_LAUNCHES = INFER_LAUNCHES  # per batch: the 512x512 headline's forward


def _scene_datasets(root: Path) -> dict:
    return {p.stem: _read_datasets(p) for p in sorted(root.glob("*.h5"))}


def _check_written(name, root: Path, before: dict, key: str, frames) -> dict:
    """Each (scene, group) of ``frames`` holds an (N, 3) float32 finite flow
    under ``key``, no other group one, and every other dataset is as it was
    in ``before``; returns the flows by (scene, group)."""
    after, flows = _scene_datasets(root), {}
    want = {(str(s), str(t)) for s, t in frames}
    for scene, groups in before.items():
        if after[scene].keys() != groups.keys():
            raise AssertionError(f"{name}: {scene}'s groups changed")
        for group, arrays in groups.items():
            got = after[scene][group]
            added = set(got) - set(arrays) - {key}
            if added or set(arrays) - set(got):
                raise AssertionError(f"{name}: {scene}/{group} holds {sorted(got)}")
            for ds_name, arr in arrays.items():
                if ds_name == key:
                    continue
                if got[ds_name].dtype != arr.dtype or got[ds_name].tobytes() != arr.tobytes():
                    raise AssertionError(f"{name}: {scene}/{group}/{ds_name} changed")
            if (scene, group) in want:
                flow = got.get(key)
                n = len(arrays["lidar"])
                if flow is None or flow.dtype != np.float32 or flow.shape != (n, 3):
                    raise AssertionError(f"{name}: {scene}/{group} has no (N, 3) float32 {key}")
                if not np.isfinite(flow).all():
                    raise AssertionError(f"{name}: {scene}/{group} {key} is not finite")
                flows[(scene, group)] = flow
            elif key in got and key not in arrays:
                raise AssertionError(f"{name}: {scene}/{group} (no successor) got a {key}")
    return flows


def phase_fleet(device, smi: str, root: Path):
    """The batched fleet end to end (``parallel/fleet.fleet_save``) at the
    JAX bench's e2e setting: ``make_dataset`` writes ``FLEET_SCENES`` x
    ``FLEET_FRAMES`` x 64,800 points into ``root``; ``seflowpp`` bf16 with
    random weights, ``FleetConfig(num_points=NUM_POINTS,
    batch_per_device=BATCH)``; one warm pass, a timed pass (points per
    second with the write-back inside, as ``bench.py`` counts them), and a
    traced pass for the device busy share. Checks the launches per batch,
    a float32 (N, 3) finite flow on every frame, every other dataset
    unchanged, and the first batch's flows against the same step with the
    plain versions. Returns the timed pass's launches."""
    import torch

    from himo_tpu_torch import native
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.synthetic import make_dataset
    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.parallel import fleet
    from torch.profiler import record_function

    start = time.perf_counter()
    make_dataset(root, num_scenes=FLEET_SCENES, num_frames=FLEET_FRAMES, seed=0,
                 num_background=FLEET_BACKGROUND)
    made_s = time.perf_counter() - start
    before = _scene_datasets(root)
    model, _ = make_model("seflowpp", device=device, dtype="bfloat16")
    state = init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    config = fleet.FleetConfig(num_points=NUM_POINTS, batch_per_device=BATCH)
    kw = dict(model="seflowpp", params=state, output_key="fleet", config=config,
              model_overrides={"dtype": "bfloat16"}, verbose=False, device=device)
    fleet.fleet_save(str(root), **kw)  # warm: cuDNN/cuBLAS set-up, page cache
    torch.cuda.synchronize()

    reset_counts()
    start = time.perf_counter()
    stats = fleet.fleet_save(str(root), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = read_counts()
    n_batches = -(-stats["frames"] // BATCH)
    want = dict.fromkeys(launches, 0)
    want.update({k: n_batches * v for k, v in FLEET_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"fleet: launches {launches} != {want} ({n_batches} batches)")

    def traced_pass():
        with record_function(FLEET_LABEL):
            out = fleet.fleet_save(str(root), **kw)
            torch.cuda.synchronize()
        return out

    traced_stats, events = traced(traced_pass)
    busy, traced_wall = window_busy(events, FLEET_LABEL)

    dataset = SceneFlowDataset(root, with_pc1=True, with_history=True,
                               extra_keys=("ssl_prior", "ssl_prior_valid"),
                               next_keys=("lidar_dt",))
    eval_index = SceneFlowDataset(root, eval=True).eval_index
    flows = _check_written("fleet", root, before, "fleet", dataset.data_index)
    if not {(s, str(t)) for s, t in eval_index} <= set(flows):
        raise AssertionError("fleet: a frame of the eval index has no flow")

    # The first batch again, with the plain versions on the card.
    first = [fleet.frame_to_arrays(dataset[i], NUM_POINTS, True, defer_pack=native.available(),
                                   with_dts=True) for i in range(BATCH)]
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in fleet.stack_fleet_batch(first, NUM_POINTS).items()}
    step = fleet.make_fleet_step(model, config, outputs=("flow", "comp_dis"))
    with plain_kernels():
        out = step(batch)
    plain = out["flow"].cpu().numpy()
    moved = float((out["comp_dis"] != 0).any(-1).float().mean())
    dist = []
    for b, (scene, ts) in enumerate(dataset.data_index[:BATCH]):
        n = first[b]["num_real"]
        dist.append(np.linalg.norm(flows[(scene, str(ts))][:n] - plain[b, :n], axis=1))
    dist = np.concatenate(dist)
    agree = float((dist <= SLICE_TOL_M).mean())
    if agree < SLICE_MIN_AGREE:
        raise AssertionError(f"fleet: only {agree:.4f} of the first batch's points agree with "
                             f"the plain versions within {SLICE_TOL_M} m")
    n_pts = stats["points"]
    frame_pts = sorted({len(g["lidar"]) for groups in before.values() for g in groups.values()})
    log(f"[fleet] {smi}: {stats['frames']} frames ({FLEET_SCENES} scenes x {FLEET_FRAMES}) of "
        f"{frame_pts} points written in {made_s:.2f} s; seflowpp bf16, batches of {BATCH} at "
        f"{NUM_POINTS:,} points, {n_batches} batches")
    log(f"[fleet] {smi}: timed pass {wall:.3f} s with the write-back: "
        f"{n_pts / wall / 1e6:.4f} M points/s ({n_pts:,} points; run_fleet "
        f"{stats['seconds']:.3f} s = {stats['points_per_sec'] / 1e6:.4f} M points/s, "
        f"write-back {stats['write_s']:.3f} s); producer {stats['prep_s'] / n_batches * 1e3:.3f} "
        f"host ms per batch (summed over its {config.prep_threads} threads), main thread: "
        f"stack + upload {stats['stack_s'] / n_batches * 1e3:.3f} ms, waiting for a batch "
        f"{stats['wait_s'] / n_batches * 1e3:.3f} ms, readback + consumer "
        f"{stats['drain_s'] / n_batches * 1e3:.3f} ms per batch")
    log(f"[fleet] {smi}: traced pass: device busy {busy:.3f} ms of {traced_wall:.3f} ms, busy "
        f"share {busy / traced_wall:.4f} (run_fleet {traced_stats['seconds']:.3f} s, write-back "
        f"{traced_stats['write_s']:.3f} s)")
    log(f"[fleet] launches {({k: v for k, v in launches.items() if v})}; first "
        f"batch vs plain versions: {agree:.6f} of points within {SLICE_TOL_M} m (max "
        f"{float(dist.max()):.6f} m; {moved:.4f} of its points have a non-zero comp_dis); "
        f"every frame has a finite (N, 3) float32 flow, every other dataset unchanged")
    return launches


def _dp_join(rank: int, world: int, address: str, backend: str, kind: str, setup):
    """Start a spawned rank of ``phase_data_parallel``: the setup hook, the
    card for gloo ranks (both on device 0), the process group, the mesh."""
    if setup is not None:
        setup()
    import torch

    from himo_tpu_torch.parallel import multihost

    if kind == "cuda" and backend == "gloo":
        torch.cuda.set_device(0)
    multihost.initialize(address, world, rank, backend=backend, device=kind,
                         timeout=DP_TIMEOUT_S)
    return multihost.global_mesh(device=kind)


def _dp_model(mesh, config):
    """``seflowpp`` bf16 from seed 0 on the rank's device, broadcast from
    rank 0."""
    import torch

    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.parallel.mesh import replicated

    model, _ = make_model(config.model, device=mesh.device, dtype="bfloat16")
    init_params(model, torch.Generator().manual_seed(0))
    return replicated(mesh, model)


@contextlib.contextmanager
def _recorded_reductions(record: list):
    """While the block runs, each call of ``trainer.reduce_gradients``
    appends (the rank's own gradients, the reduced ones) to ``record``,
    before the clip changes them."""
    from himo_tpu_torch.training import trainer

    reduce = trainer.reduce_gradients

    def recording(params, mesh):
        params = list(params)
        local = [p.grad.detach().clone() for p in params]
        bucket = reduce(params, mesh)
        record.append((local, [p.grad.detach().clone() for p in params]))
        return bucket

    trainer.reduce_gradients = recording
    try:
        yield record
    finally:
        trainer.reduce_gradients = reduce


def _allreduce_ms(mesh, numel: int) -> float:
    """Host ms of one all-reduce of ``numel`` float32 on the rank's device,
    synchronized, averaged over ``DP_ALLREDUCE_ITERS`` after 3 warm ones."""
    import torch
    import torch.distributed as dist

    x = torch.ones(numel, device=mesh.device)
    for _ in range(3):
        dist.all_reduce(x, group=mesh.group)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(DP_ALLREDUCE_ITERS):
        dist.all_reduce(x, group=mesh.group)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / DP_ALLREDUCE_ITERS * 1e3


def _dp_steps(name, mesh, model, config, batch, lines, check=None) -> tuple:
    """``DP_STEPS`` steps of ``make_train_step(..., mesh)`` on this rank's
    ``batch``, each launching ``TRAIN_LAUNCHES``; ``check(step, metrics,
    local, reduced)`` runs after each; the step times go to ``lines``.
    Returns (summed launches, the gradient bucket's numel)."""
    import torch

    from himo_tpu_torch.training import trainer

    optimizer, _ = trainer.make_optimizer(model.parameters(), config, STEPS_PER_EPOCH)
    step = trainer.make_train_step(model, config, optimizer, mesh)
    want = dict.fromkeys(read_counts(), 0)
    want.update(TRAIN_LAUNCHES)
    totals = dict.fromkeys(want, 0)
    times, record = [], []
    with _recorded_reductions(record):
        for i in range(DP_STEPS):
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            counts = read_counts()
            if counts != want:
                raise AssertionError(f"{name} rank {mesh.rank} step {i + 1} launches {counts} "
                                     f"!= {want}")
            for k, v in counts.items():
                totals[k] += v
            metrics = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"{name} step {i + 1}: non-finite metrics {metrics}")
            if check is not None:
                check(i, metrics, *record[-1])
            record.clear()
    numel = sum(p.numel() for p in model.parameters()) + len(list(model.parameters()))
    lines.append(f"[{name}] rank {mesh.rank}: B={len(batch['pc0'])} step ms "
                 f"{', '.join(f'{t:.3f}' for t in times)}")
    return totals, numel


def _producer_ms(root: str, rows) -> tuple:
    """Host ms per batch of one epoch of the trainer's producer
    (``batch_iterator`` at ``TrainConfig()``, keeping ``rows``) over the
    scenes at ``root``, and the batches."""
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.training import trainer

    config = trainer.TrainConfig()
    dataset = SceneFlowDataset(root, with_pc1=True, with_history=True,
                               extra_keys=tuple(SSL_DTYPES), next_keys=("ssl_dynamic",))
    start, n = time.perf_counter(), 0
    for _ in trainer.batch_iterator(dataset, config, 3, np.random.default_rng(0), rows=rows):
        n += 1
    return (time.perf_counter() - start) / n * 1e3, n


def _dp_nccl_rank(rank: int, address: str, setup) -> dict:
    """(a) One NCCL rank: ``DP_STEPS`` steps of the B8 step through the
    mesh. Each step's all-reduce must hand back the rank's own gradients
    bitwise (the sum over one rank, divided by 1), and the parameters must
    equal bitwise those of a twin model stepped without a mesh on the same
    gradients. (Two plain backward passes of one batch are not bitwise
    alike: K1 sum and K3 sum add with float atomics; the rank measures how
    far apart.)"""
    import copy

    import torch

    from himo_tpu_torch.training import trainer

    mesh = _dp_join(rank, 1, address, "nccl", "cuda", setup)
    config = trainer.TrainConfig()
    model = _dp_model(mesh, config)
    twin = copy.deepcopy(model)
    twin_opt, _ = trainer.make_optimizer(twin.parameters(), config, STEPS_PER_EPOCH)
    batch = _train_batch(mesh.device, config)
    lines = []
    runs = []
    for _ in range(2):
        twin.zero_grad(set_to_none=True)
        trainer.mean_losses(twin, config, batch)["total"].backward()
        runs.append(_grads(twin))
    twin.zero_grad(set_to_none=True)
    spread = float((runs[0] - runs[1]).abs().max())
    lines.append(f"[data_parallel] (a) two plain backward passes of one batch: bitwise equal "
                 f"{bool(torch.equal(runs[0], runs[1]))}, max |grad diff| {spread:.3e} (norm "
                 f"{float(runs[0].norm()):.6f})")
    del runs

    def check(i, metrics, local, reduced):
        if not all(torch.equal(a, b) for a, b in zip(local, reduced)):
            raise AssertionError(f"(a) step {i + 1}: NCCL's all-reduce over one rank changed "
                                 "the gradients")
        for p, g in zip(twin.parameters(), local):
            p.grad = g
        twin_opt.step()
        if not all(torch.equal(a, b) for a, b in zip(model.parameters(), twin.parameters())):
            raise AssertionError(f"(a) step {i + 1}: the parameters differ from the twin "
                                 "stepped without a mesh")

    counts, numel = _dp_steps("data_parallel (a) nccl", mesh, model, config, batch, lines,
                              check)
    return {"counts": counts, "lines": lines, "numel": numel,
            "allreduce_ms": _allreduce_ms(mesh, numel), "shape": mesh.shape}


def _dp_gloo_rank(rank: int, address: str, setup, kind: str, fleet_root: str) -> dict:
    """(b) and (c) in one of two gloo ranks on the one card: the global B8
    batch split in two for ``DP_STEPS`` steps (the parameters compared
    across the ranks by digest after each; step 1's reduced gradients held
    against rank 0's single-process step on the whole batch), then the
    fleet on ``fleet_root`` across the ranks."""
    import copy
    import hashlib

    import torch
    import torch.distributed as dist

    from himo_tpu_torch.data import schema
    from himo_tpu_torch.parallel import fleet
    from himo_tpu_torch.parallel.mesh import batch_rows, shard_batch
    from himo_tpu_torch.training import trainer

    mesh = _dp_join(rank, DP_WORLD, address, "gloo", kind, setup)
    config = trainer.TrainConfig()
    model = _dp_model(mesh, config)
    # phase_fleet's weights, for (c): the steps below move the model's.
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    full = _train_batch(mesh.device, config)
    lines, ref = [], {}
    if rank == 0:  # one process's step on the whole batch, through the kernels
        one = copy.deepcopy(model)
        terms = trainer.mean_losses(one, config, full)
        terms["total"].backward()
        ref = {"terms": {k: float(v.detach()) for k, v in terms.items()}, "grads": _grads(one)}
        del one, terms
    batch = shard_batch(mesh, full)
    digests = []

    def check(i, metrics, local, reduced):
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        got = [None] * DP_WORLD
        dist.all_gather_object(got, h.hexdigest(), group=mesh.group)
        if len(set(got)) != 1:
            raise AssertionError(f"(b) step {i + 1}: the ranks' parameters differ")
        digests.append(got[0])
        if i == 0 and rank == 0:
            grads = torch.cat([g.reshape(-1).float() for g in reduced])
            worst = max(abs(metrics[k] - v) / max(abs(v), 1e-12)
                        for k, v in ref["terms"].items())
            norm, want = float(grads.norm()), float(ref["grads"].norm())
            norm_rel = abs(norm - want) / want
            cosine = float(torch.nn.functional.cosine_similarity(grads, ref["grads"], dim=0))
            lines.append(f"[data_parallel] (b) step 1, two B{len(batch['pc0'])} ranks vs one "
                         f"B{len(full['pc0'])} process: worst term rel diff {worst:.3e}, grad "
                         f"norm {norm:.6f} vs {want:.6f} (rel {norm_rel:.3e}), cosine "
                         f"{cosine:.6f}")
            if worst > TERM_RTOL or norm_rel > NORM_RTOL or cosine < MIN_COSINE:
                raise AssertionError(
                    f"(b) step 1's reduced gradients disagree with one process (limits: terms "
                    f"{TERM_RTOL}, norm {NORM_RTOL}, cosine {MIN_COSINE})")

    counts, numel = _dp_steps("data_parallel (b) gloo", mesh, model, config, batch, lines,
                              check)
    out = {"counts": counts, "lines": lines, "numel": numel,
           "allreduce_ms": _allreduce_ms(mesh, numel), "digests": digests,
           "producer": _producer_ms(fleet_root, batch_rows(mesh, config.batch_size))}
    del batch, full, ref
    torch.cuda.empty_cache()

    # (c) the fleet: a warm pass, then the timed pass with its writes counted.
    kw = dict(model="seflowpp", params=state, output_key=DP_FLEET_KEY, mesh=mesh,
              config=fleet.FleetConfig(num_points=NUM_POINTS, batch_per_device=BATCH),
              model_overrides={"dtype": "bfloat16"}, verbose=False)
    fleet.fleet_save(fleet_root, **kw)
    written = []
    write = schema.write_method_flows

    def counted(data_dir, scene_id, key, flows):
        written.append(scene_id)
        write(data_dir, scene_id, key, flows)

    schema.write_method_flows = counted
    try:
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        stats = fleet.fleet_save(fleet_root, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    finally:
        schema.write_method_flows = write
    out.update(fleet_counts=read_counts(), fleet_stats=stats, fleet_wall=wall,
               written=written)
    return out


def phase_data_parallel(device, smi: str, fleet_root: Path, tmp: Path) -> list:
    """Data parallelism on the card: (a) NCCL at one rank
    (:func:`phase_dp_nccl`), then (b) and (c) over two gloo ranks sharing
    it (:func:`phase_dp_gloo`). Returns each part's launches."""
    import torch

    torch.cuda.empty_cache()
    start = time.perf_counter()
    parts = [phase_dp_nccl(smi, tmp)]
    parts += phase_dp_gloo(device, smi, fleet_root, tmp)
    log(f"[data_parallel] {smi}: the phase {time.perf_counter() - start:.1f} s")
    return parts


def phase_dp_nccl(smi: str, tmp: Path) -> dict:
    """(a): one spawned NCCL rank, ``DP_STEPS`` B8 steps through the mesh
    (checks in :func:`_dp_nccl_rank`); prints the all-reduce's ms and the
    bucket's MB. Returns the steps' launches."""
    from himo_tpu_torch.parallel.multihost import run_ranks

    start = time.perf_counter()
    (out,) = run_ranks(_dp_nccl_rank, 1, ((tmp / "rendezvous_nccl").as_uri(), DP_RANK_SETUP),
                       timeout=DP_TIMEOUT_S)
    for line in out["lines"]:
        log(line)
    log(f"[data_parallel] (a) {smi}: NCCL, world size 1, mesh {out['shape']}: {DP_STEPS} "
        f"steps' parameters bitwise equal to a twin stepped without a mesh on the same "
        f"gradients; all-reduce of the gradient bucket ({out['numel'] * 4 / 1e6:.3f} MB) "
        f"{out['allreduce_ms']:.4f} ms; the spawn {time.perf_counter() - start:.1f} s")
    return out["counts"]


def phase_dp_gloo(device, smi: str, fleet_root: Path, tmp: Path) -> list:
    """(b) and (c) over ``DP_WORLD`` spawned gloo ranks on ``device`` (both
    on the one card; gloo's CUDA all-reduce goes through the host):
    the split B8 step (checks in :func:`_dp_gloo_rank`) and the fleet on a
    copy of ``fleet_root``, whose ``fleet`` flows (``phase_fleet``'s, one
    rank) the ranks' flows are held against. Returns the launches of the
    steps and of the fleet's timed pass."""
    import shutil

    from himo_tpu_torch.parallel.multihost import run_ranks

    root = tmp / "av2_fleet_dp"
    shutil.copytree(fleet_root, root)
    before = _scene_datasets(root)
    one_ms, n_batches = _producer_ms(str(root), None)
    start = time.perf_counter()
    outs = run_ranks(_dp_gloo_rank, DP_WORLD,
                     ((tmp / "rendezvous_gloo").as_uri(), DP_RANK_SETUP, device.type,
                      str(root)),
                     timeout=DP_TIMEOUT_S)
    spawn_s = time.perf_counter() - start
    for out in outs:
        for line in out["lines"]:
            log(line)
    # Step 1 (lr 0) keeps the parameters, step 2 moves them.
    if len({tuple(o["digests"]) for o in outs}) != 1 or len(set(outs[0]["digests"])) != DP_STEPS:
        raise AssertionError(f"(b) parameter digests {[o['digests'] for o in outs]}: not "
                             "equal across the ranks, or step 2 did not move them")
    log(f"[data_parallel] (b) {smi}: the trainer's producer, host ms per global batch of "
        f"{BATCH} over {n_batches} batches of the fleet's scenes: one process {one_ms:.1f}; "
        f"each of {DP_WORLD} ranks at once (every frame built, its rows kept) "
        + ", ".join(f"{o['producer'][0]:.1f}" for o in outs))
    log(f"[data_parallel] (b) {smi}: gloo, {DP_WORLD} ranks on one card: parameters bitwise "
        f"equal across the ranks after each of {DP_STEPS} steps; all-reduce of the gradient "
        f"bucket ({outs[0]['numel'] * 4 / 1e6:.3f} MB) through the host "
        + ", ".join(f"rank {r} {o['allreduce_ms']:.3f} ms" for r, o in enumerate(outs)))

    stats = outs[0]["fleet_stats"]
    written = sorted(s for o in outs for s in o["written"])
    if written != sorted(before):
        raise AssertionError(f"(c) scenes written {written}, want each of {sorted(before)} once")
    frames = sum(len(g) for g in before.values())
    if stats["mesh_shards"] != DP_WORLD or stats["frames"] != frames:
        raise AssertionError(f"(c) stats {stats}: want mesh_shards {DP_WORLD}, frames {frames}")
    after = _scene_datasets(root)
    dist = []
    for scene, groups in after.items():
        for group, arrays in groups.items():
            if DP_FLEET_KEY in arrays:
                dist.append(np.linalg.norm(arrays[DP_FLEET_KEY] - arrays["fleet"], axis=1))
    dist = np.concatenate(dist)
    agree = float((dist <= SLICE_TOL_M).mean())
    if agree < SLICE_MIN_AGREE:
        raise AssertionError(f"(c) only {agree:.4f} of points within {SLICE_TOL_M} m of the "
                             "one-rank fleet's flows")
    counts = [o["fleet_counts"] for o in outs]
    for r, (o, c) in enumerate(zip(outs, counts)):
        n_batches = -(-sum(len(before[s]) for s in o["written"]) // BATCH)
        want = dict.fromkeys(c, 0)
        want.update({k: n_batches * v for k, v in FLEET_LAUNCHES.items()})
        if c != want:
            raise AssertionError(f"(c) rank {r}: launches {c} != {want} ({n_batches} batches)")
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    walls = [o["fleet_wall"] for o in outs]
    log(f"[data_parallel] (c) {smi}: fleet_save across {DP_WORLD} gloo ranks, two ranks "
        f"sharing one card: {stats['frames']} frames, {stats['points']:,} points, "
        f"{stats['points'] / max(walls) / 1e6:.4f} M points/s with the write-back (walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s; run_fleet {stats['seconds']:.3f} s = "
        f"{stats['points_per_sec'] / 1e6:.4f} M points/s, write-back {stats['write_s']:.3f} s); "
        f"scenes written once each, by rank: {[len(o['written']) for o in outs]}; "
        f"{agree:.6f} of points within {SLICE_TOL_M} m of the one-rank fleet (max "
        f"{float(dist.max()):.6f} m); launches {({k: v for k, v in total.items() if v})}; "
        f"the spawn {spawn_s:.1f} s")
    return [o["counts"] for o in outs] + [total]


def phase_save(device, smi: str, root: Path):
    """``cli.save.main`` (the per-frame runner) on ``SAVE_SCENES`` x
    ``SAVE_FRAMES`` x 64,800 points written into ``root`` with a perfect
    method flow: ``model=fastnsf`` at its defaults (the host cluster prior
    on, with the scene-start repair), then ``model=seflowpp`` (bf16) from a
    saved random checkpoint. Checks a flow on exactly the frames with a
    successor, every other dataset unchanged, the repair's count against
    the pairs whose backcast has tracks, and the launches (none for
    fastnsf, the headline's forward per frame for seflowpp). Returns the
    launches of both runs."""
    import tempfile

    import torch

    from himo_tpu_torch.cli.save import main as save_main
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.synthetic import make_dataset
    from himo_tpu_torch.models import runner
    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.training.checkpoints import save_checkpoint

    make_dataset(root, num_scenes=SAVE_SCENES, num_frames=SAVE_FRAMES, seed=0,
                 num_background=SAVE_BACKGROUND, method_flows={"perfect": 0.0})
    pairs = SceneFlowDataset(root, eval=True).eval_index  # every frame with a successor
    estimators = []
    get_estimator = runner.get_estimator

    def capturing(*args, **kwargs):
        estimators.append(get_estimator(*args, **kwargs))
        return estimators[-1]

    total = {}
    runner.get_estimator = capturing
    try:
        for model, extra in (("fastnsf", {}), ("seflowpp", {"dtype": "bfloat16"})):
            before = _scene_datasets(root)
            with tempfile.TemporaryDirectory(prefix="himo_ckpt_") as ckpt:
                if model == "seflowpp":
                    net, _ = make_model("seflowpp", device=device, dtype="bfloat16")
                    save_checkpoint(ckpt, {"params": init_params(
                        net, torch.Generator().manual_seed(0))})
                    extra = {**extra, "checkpoint": ckpt}
                    del net
                reset_counts()
                start = time.perf_counter()
                stats = save_main(dataset_path=str(root), model=model, device=device, **extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                launches = read_counts()
            _check_written(f"save {model}", root, before, model, pairs)
            if stats["frames"] != len(pairs):
                raise AssertionError(f"save {model}: {stats['frames']} frames of {len(pairs)}")
            trackers = getattr(estimators[-1], "trackers", None) or {}
            n_pairs = {s: sum(1 for p in pairs if p[0] == s) for s, _ in pairs}
            expected = sum(
                1 for s, tr in trackers.items() if n_pairs.get(s, 0) >= 3
                for j in range(min(2, n_pairs[s])) if tr.backcast(n_frames=n_pairs[s] - j).tracks)
            if stats["repaired"] != expected:
                raise AssertionError(f"save {model}: the repair re-estimated "
                                     f"{stats['repaired']} pairs, not {expected}")
            want = dict.fromkeys(launches, 0)
            if model == "seflowpp":
                want.update({k: len(pairs) * v for k, v in INFER_LAUNCHES.items()})
            if launches != want:
                raise AssertionError(f"save {model}: launches {launches} != {want}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            log(f"[save] {smi}: cli.save model={model}: {stats['frames']} frame pairs of "
                f"{SAVE_SCENES} scenes, {stats['repaired']} re-estimated by the scene-start "
                f"repair (of {len(pairs)}), {wall:.3f} s, "
                f"{wall / (stats['frames'] + stats['repaired']) * 1e3:.3f} host ms per frame "
                f"estimated; launches {({k: v for k, v in launches.items() if v})}; a flow on "
                f"every frame with a successor and none on a scene's last, every other "
                f"dataset unchanged")
    finally:
        runner.get_estimator = get_estimator
    return total


def phase_eval(smi: str, save_root: Path, fleet_root: Path) -> None:
    """Flow-mode ``cli.eval`` and ``cli.eval_flow`` in a temporary working
    directory (they write ``res-*.json`` there): ``perfect`` scores below
    ``EVAL_PERFECT_MAX`` and ``raw`` worse; the saved ``fastnsf`` and
    ``seflowpp`` flows and the fleet's score finite (random weights measure
    no quality); host ms per frame."""
    import tempfile

    from himo_tpu_torch.cli.eval import main as eval_main
    from himo_tpu_torch.cli.eval_flow import main as eval_flow_main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="himo_eval_") as tmp:
        os.chdir(tmp)
        try:
            scores, times = {}, {}
            for root, names in ((save_root, ("perfect", "raw", "fastnsf", "seflowpp")),
                                (fleet_root, ("fleet",))):
                for name in names:
                    start = time.perf_counter()
                    metrics = eval_main(data_dir=str(root), res_name=name)
                    times[name] = (time.perf_counter() - start) / metrics.frame_cnt * 1e3
                    scores[name] = metrics.total_summary()
            start = time.perf_counter()
            flow_scores = eval_flow_main(data_dir=str(save_root),
                                         res_names=["perfect", "raw", "fastnsf", "seflowpp"])
            flow_ms = (time.perf_counter() - start) / 4 * 1e3
            files = sorted(p.name for p in Path(tmp).iterdir())
        finally:
            os.chdir(cwd)
    perfect, raw = scores["perfect"], scores["raw"]
    if not (perfect["mpe"] < EVAL_PERFECT_MAX and perfect["cd"] < EVAL_PERFECT_MAX):
        raise AssertionError(f"eval: perfect scores {perfect}")
    if not (raw["mpe"] > perfect["mpe"] and raw["cd"] > perfect["cd"]):
        raise AssertionError(f"eval: raw {raw} is not worse than perfect {perfect}")
    for name, total in scores.items():
        if total is None or not all(np.isfinite([total["mpe"], total["cd"]])):
            raise AssertionError(f"eval: {name} scores {total}")
    if flow_scores["perfect"]["EPE_3way"] > EVAL_PERFECT_MAX or not all(
            np.isfinite(v) for r in flow_scores.values() for v in r.values()):
        raise AssertionError(f"eval_flow: {flow_scores}")
    if files != ["res-av2.json", "res-flow-av2.json"]:
        raise AssertionError(f"eval wrote {files}")
    log(f"[eval] {smi}: Total MPE / CDE: " + "; ".join(
        f"{k} {v['mpe']:.6f} / {v['cd']:.6f} m ({times[k]:.3f} host ms per frame)"
        for k, v in scores.items()))
    log(f"[eval] {smi}: eval_flow EPE 3-way " + ", ".join(
        f"{k} {v['EPE_3way']:.6f}" for k, v in flow_scores.items())
        + f" m ({flow_ms:.3f} host ms per method)")


def _script(root: Path, name: str):
    """The module ``scripts/{name}.py`` of the checkout at ``root``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, root / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_fleet_stages(device, smi: str, root: Path, fleet_root: Path) -> None:
    """``scripts/torch_profile_fleet.py``'s stage table over the fleet's
    scenes: each stage of the fleet path timed on its own, the upload and
    the step's launch apart from the synchronize and the readback, and
    the device's busy ms a batch from a traced pass."""
    start = time.perf_counter()
    log(f"[fleet_stages] {smi}: scripts/torch_profile_fleet.py over {fleet_root.name}")
    stages = _script(root, "torch_profile_fleet")

    def busy(run):
        return window_busy(traced(run)[1], stages.BATCH_LABEL)[0]

    out = stages.profile(fleet_root, device, busy=busy)
    if not out["busy_ms"] > 0:
        raise AssertionError(f"fleet_stages: device busy {out['busy_ms']} ms a batch")
    log(f"[fleet_stages] {out['frames']} frames, {out['batches']} batches in "
        f"{time.perf_counter() - start:.1f} s")


def phase_quality(device, smi: str, root: Path, tmp: Path) -> dict:
    """The quality path end to end, through ``scripts/torch_quality_evidence.py``'s
    ``run_one`` (working directory ``tmp``, where the evaluations write their
    ``res-*.json``): the suite (``QUALITY_SCENES`` + ``QUALITY_ADV_SCENES``
    scenes of ``make_benchmark_dataset``, seed 0), DUFO labels, ``train()``
    of ``seflowpp`` for ``QUALITY_EPOCHS`` epoch, its fleet flow, ``nsfp``,
    ``fastnsf10`` and ``icpflow``, ``cli.eval`` and ``cli.eval_flow`` on the
    suite and on its ``scene_adv`` tranche; then ``torch_prior_diagnostic``
    and ``torch_flagship_diagnostic`` on the same suite. Prints the table,
    each step's seconds and launches. Fails if a cell is not finite, if
    ``nsfp``'s or ``fastnsf10``'s MPE is not below ``raw``'s on the full
    suite, or if a step did not launch each of its kernels
    (``QUALITY_STEP_KERNELS``). Returns the launches of the whole phase."""
    from himo_tpu_torch.data.synthetic import make_benchmark_dataset

    qe = _script(root, "torch_quality_evidence")
    data = tmp / "av2_quality"
    args = qe.parse_args([
        "--root", str(data), "--epochs", str(QUALITY_EPOCHS), "--seeds", "0",
        "--num-points", str(QUALITY_POINTS), "--bg-points", str(QUALITY_BACKGROUND),
        "--obj-points", str(QUALITY_OBJECT_POINTS), "--device", str(device)])
    steps = []

    def record(label, seconds):
        steps.append((label, seconds, read_counts()))
        reset_counts()

    args.on_step = record
    phase_start = time.perf_counter()
    cwd = os.getcwd()
    tmp.mkdir(parents=True, exist_ok=True)
    os.chdir(tmp)
    try:
        reset_counts()
        start = time.perf_counter()
        make_benchmark_dataset(data, seed=0, num_scenes=QUALITY_SCENES,
                               adversarial_scenes=QUALITY_ADV_SCENES,
                               num_background=args.bg_points,
                               points_per_object=args.obj_points)
        record("dataset", time.perf_counter() - start)
        table = qe.run_one(args, data, 0)
        qe.print_table([table])
        files = sorted(p.name for p in tmp.iterdir() if p.suffix == ".json")
        for name, argv in (
                ("prior_diagnostic", ["--root", str(data)]),
                ("flagship_diagnostic", ["--root", str(data), "--limit",
                                         str(QUALITY_DIAG_FRAMES), "--device", str(device),
                                         "--num-points", str(QUALITY_POINTS)])):
            start = time.perf_counter()
            found = _script(root, f"torch_{name}").main(argv)
            record(name, time.perf_counter() - start)
            log(f"[quality] {name}: {len(found)} fast frame-instances")
    finally:
        os.chdir(cwd)
    phase_s = time.perf_counter() - phase_start
    bad = {m: row for m, row in table.items() if not all(np.isfinite(list(row.values())))}
    if bad:
        raise AssertionError(f"quality: cells not finite: {bad}")
    for m in QUALITY_GATED:
        if not table[m]["MPE"] < table["raw"]["MPE"]:
            raise AssertionError(f"quality: {m} MPE {table[m]['MPE']} is not below raw's "
                                 f"{table['raw']['MPE']}")
    if files != ["res-av2-scene_adv.json", "res-av2.json", "res-flow-av2-scene_adv.json",
                 "res-flow-av2.json"]:
        raise AssertionError(f"quality: the evaluations wrote {files}")
    total = dict.fromkeys(read_counts(), 0)
    for label, seconds, launches in steps:
        missing = [k for k in QUALITY_STEP_KERNELS.get(label, ()) if not launches[k]]
        if missing:
            raise AssertionError(f"quality: {label} launched none of {missing}: {launches}")
        for k, v in launches.items():
            total[k] += v
        log(f"[quality] {smi}: {label} {seconds:.2f} s, launches "
            f"{({k: v for k, v in launches.items() if v})}")
    log(f"[quality] {smi}: {len(table)} rows, every cell finite; " + "; ".join(
        f"{m} MPE {table[m]['MPE']:.6f}" for m in ("raw", *QUALITY_GATED)) +
        f" (gated below raw's); seflowpp MPE {table['seflowpp']['MPE']:.6f} (not gated); "
        f"the phase {phase_s:.1f} s")
    log(f"[quality] launches {({k: v for k, v in total.items() if v})}")
    return total


def _printed(fn, *args, **kwargs):
    """(result, standard output) of ``fn(*args, **kwargs)``."""
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = fn(*args, **kwargs)
    return out, text.getvalue()


def _lz4_fixture(root: Path):
    """The fixture generator module ``tests/data/lz4_fixture.py`` of the
    checkout at ``root`` (numpy only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("lz4_fixture", root / LZ4_FIXTURE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_submit(smi: str, save_root: Path, root: Path) -> None:
    """The leaderboard submission on ``phase_save``'s scenes, in a
    temporary working directory: ``cli.save_zip`` of ``perfect`` and
    ``seflowpp`` (the flow ``cli.save`` wrote through K1 max, K7 and K6)
    and ``cli.save_zip_gt``, each frame's feather file written by
    ``io/arrow``; zip-mode ``cli.eval`` of each method, whose totals and
    printed table must equal flow mode's; ``cli.score`` of the GT archive
    against itself and of ``perfect`` against it (both below
    ``EVAL_PERFECT_MAX``) and of ``seflowpp`` (finite; random weights
    measure no quality). Then the committed LZ4 fixture: every LZ4 frame in
    it decoded by the native library and by ``io/lz4.decode_frame``, byte
    for byte the same, and the columns read equal to the generator's.
    Prints host ms per frame of each CLI and the decoders' MB/s."""
    import shutil
    import tempfile

    from himo_tpu_torch import native
    from himo_tpu_torch.cli.eval import main as eval_main
    from himo_tpu_torch.cli.save_zip import main as save_zip_main
    from himo_tpu_torch.cli.save_zip_gt import main as save_zip_gt_main
    from himo_tpu_torch.cli.score import main as score_main
    from himo_tpu_torch.io import arrow, lz4
    from himo_tpu_torch.io.submission import list_sweep_uuids

    phase_start = time.perf_counter()
    save_root = save_root.resolve()
    cwd = os.getcwd()
    times, scores = {}, {}
    with tempfile.TemporaryDirectory(prefix="himo_submit_") as tmp:
        os.chdir(tmp)
        try:
            zips = {}
            for name in SUBMIT_METHODS:
                start = time.perf_counter()
                zips[name], _ = _printed(save_zip_main, data_dir=str(save_root), res_name=name)
                times[f"save_zip {name}"] = time.perf_counter() - start
            start = time.perf_counter()
            zips["gt"], _ = _printed(save_zip_gt_main, data_dir=str(save_root),
                                     output_dir=str(Path(tmp) / "gt_av2"), res_name="flow")
            times["save_zip_gt"] = time.perf_counter() - start
            frames = len(list_sweep_uuids(zips["gt"]))
            if not frames:
                raise AssertionError(f"submit: no frame in the GT archive of {save_root}")
            for name, path in zips.items():
                if sorted(list_sweep_uuids(path)) != sorted(list_sweep_uuids(zips["gt"])):
                    raise AssertionError(f"submit: {name}'s archive holds other sweeps")
            for name in SUBMIT_METHODS:
                flow, flow_text = _printed(eval_main, data_dir=str(save_root), res_name=name)
                start = time.perf_counter()
                zipped, zip_text = _printed(eval_main, data_dir=str(save_root), res_name=name,
                                            comp_dis_zip=zips[name])
                times[f"eval zip {name}"] = time.perf_counter() - start
                table = "HiMo refinement metrics"
                if "Using provided comp_dis_zip" not in zip_text or \
                        zipped.total_summary() != flow.total_summary() or \
                        zip_text[zip_text.index(table):] != flow_text[flow_text.index(table):]:
                    raise AssertionError(f"submit: zip-mode eval of {name} differs from flow "
                                         f"mode: {zipped.total_summary()} against "
                                         f"{flow.total_summary()}")
            for pred in ("gt", *SUBMIT_METHODS):
                out = Path(tmp) / f"score_{pred}"
                start = time.perf_counter()
                scores[pred], _ = _printed(score_main, ["--gt_zip", zips["gt"], "--pred_zip",
                                                        zips[pred], "--output_dir", str(out)])
                times[f"score {pred}"] = time.perf_counter() - start
                if sorted(p.name for p in out.iterdir()) != ["res-av2.json", "scores.json"]:
                    raise AssertionError(f"submit: score wrote {list(out.iterdir())}")
        finally:
            os.chdir(cwd)
            shutil.rmtree(save_root / "results", ignore_errors=True)
    for pred, s in scores.items():
        if s["num_frames"] != frames or not np.isfinite([s["mpe"], s["chamfer"]]).all():
            raise AssertionError(f"submit: score of {pred}: {s}")
        if pred != "seflowpp" and not (s["mpe"] < EVAL_PERFECT_MAX
                                       and s["chamfer"] < EVAL_PERFECT_MAX):
            raise AssertionError(f"submit: {pred} against GT scores {s}")

    fixture = _lz4_fixture(root)
    frames_seen = []
    decode = lz4.decode

    def recording(data, size):
        frames_seen.append((bytes(data), size))
        return decode(data, size)

    lz4.decode = recording
    try:
        columns = arrow.read_feather(fixture.PATH)
    finally:
        lz4.decode = decode
    want = fixture.columns()
    if list(columns) != list(want) or any(
            columns[k].dtype != v.dtype or columns[k].tobytes() != v.tobytes()
            for k, v in want.items()):
        raise AssertionError("submit: the LZ4 fixture's columns differ from the generator's")
    if not native.available():
        raise AssertionError("submit: the native library is not available on the card's host")
    decoded = sum(size for _, size in frames_seen)
    rates = {}
    for name, fn in (("native", native.lz4_frame_decode), ("numpy", lz4.decode_frame)):
        outs, ms = _median_ms(lambda fn=fn: [fn(f, n) for f, n in frames_seen], LZ4_RUNS)
        rates[name] = (outs, decoded / ms / 1e3)
    if rates["native"][0] != rates["numpy"][0]:
        raise AssertionError("submit: the native and numpy LZ4 decoders differ")
    per_frame = {k: v / frames * 1e3 for k, v in times.items()}
    log(f"[submit] {smi}: host ms per frame over {frames} frames: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_frame.items()))
    log(f"[submit] {smi}: zip-mode eval equals flow mode (totals and table) for "
        f"{', '.join(SUBMIT_METHODS)}; score MPE / CDE: " + "; ".join(
            f"{k} {v['mpe']:.6f} / {v['chamfer']:.6f} m" for k, v in scores.items()))
    log(f"[submit] {smi}: LZ4 fixture ({fixture.PATH.stat().st_size:,} bytes, "
        f"{len(frames_seen)} frames, {decoded:,} bytes decoded): native "
        f"{rates['native'][1]:.1f} MB/s, numpy {rates['numpy'][1]:.1f} MB/s (medians of "
        f"{LZ4_RUNS}), byte for byte the same; columns equal the generator's")
    log(f"[submit] the phase took {time.perf_counter() - phase_start:.1f} s")


@contextlib.contextmanager
def _recorded_images():
    """Every image written through ``viz/png`` while the block runs: yields
    ({path: still}, {path: [APNG frame, ...]})."""
    from himo_tpu_torch.viz import png

    stills, animations = {}, {}
    write, frame = png.write, png.APNGWriter.write

    def recording_write(path, image):
        stills[str(path)] = np.array(image)
        return write(path, image)

    def recording_frame(self, image):
        animations.setdefault(self.path, []).append(np.array(image))
        return frame(self, image)

    png.write, png.APNGWriter.write = recording_write, recording_frame
    try:
        yield stills, animations
    finally:
        png.write, png.APNGWriter.write = write, frame


def phase_viz(smi: str, save_root: Path) -> dict:
    """The viz layer on ``phase_save``'s scenes, in a temporary directory,
    all on the host: ``visualize.main`` of every frame at ``VIZ_RESOLUTION``
    coloured by each of ``VIZ_COLORS``, de-skewed by the ``perfect`` flow;
    ``print_refine_ins`` of ``perfect`` (MPE below ``EVAL_PERFECT_MAX``) and
    of the ``seflowpp`` flow that ``cli.save`` wrote (finite) on
    ``VIZ_INSTANCES``; ``vis_refine_ins`` of those instances with that
    flow; ``save_animation`` of ``VIZ_ANIMATION_FRAMES`` frames (an APNG,
    ``perfect``); ``schematic.main``. Every file is read back with
    ``viz/png``'s readers and must equal the image in memory; no kernel may
    launch, and none of ``VIZ_ABSENT`` may be imported. Prints host ms per frame by stage (read, ``prepare_frame``,
    render, encode), the files' sizes and the phase's seconds. Returns the
    launches (all zero)."""
    phase_start = time.perf_counter()
    import tempfile

    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.viz import animation, png, schematic, view_instance, visualize

    save_root = save_root.resolve()
    reset_counts()
    index = SceneFlowDataset(save_root, vis_name=VIZ_FLOW).data_index
    want_names = sorted(f"{scene}_{ts}_{VIZ_FLOW}.png" for scene, ts in index)
    times, sizes, scores = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="himo_viz_") as tmp, \
            _recorded_images() as (stills, animations):
        out = Path(tmp)
        fly = str(out / "animation.png")
        runs = {
            "visualize.main": (visualize, lambda: [visualize.main(
                data_dir=str(save_root), flow_mode=VIZ_FLOW, color=color,
                out_dir=str(out / color), num_frames=len(index), resolution=VIZ_RESOLUTION)
                for color in VIZ_COLORS]),
            "save_animation": (animation, lambda: animation.save_animation(
                data_dir=str(save_root), flow_mode=VIZ_FLOW, output=fly,
                resolution=VIZ_RESOLUTION, max_frames=VIZ_ANIMATION_FRAMES)),
        }
        for name, (module, run) in runs.items():
            with _stage_timer(SceneFlowDataset, {"read": "__getitem__"}) as read, \
                    _stage_timer(module, {"prepare_frame": "prepare_frame",
                                          "render": "render_bev"}) as host, \
                    _stage_timer(png, {"encode": "image_data"}) as encode:
                _printed(run)
            times[name] = {**read, **host, **encode}
        frames = {"visualize.main": len(VIZ_COLORS) * len(index),
                  "save_animation": len(animations.get(fly, []))}
        bev = [p for color in VIZ_COLORS for p in sorted((out / color).iterdir())]
        for color in VIZ_COLORS:
            got_names = sorted(p.name for p in (out / color).iterdir())
            if got_names != want_names:
                raise AssertionError(f"viz: visualize.main color={color} wrote {got_names}")
        if frames["save_animation"] != min(VIZ_ANIMATION_FRAMES, len(index)):
            raise AssertionError(f"viz: the APNG holds {frames['save_animation']} frames")
        for flow in ("perfect", VIZ_INSTANCE_FLOW):
            (chams, mpes), text = _printed(view_instance.print_refine_ins,
                                           data_dir=str(save_root), flow_mode=flow,
                                           ins_id=VIZ_INSTANCES)
            if len(mpes) != len(VIZ_INSTANCES) or not np.isfinite([*chams, *mpes]).all():
                raise AssertionError(f"viz: print_refine_ins {flow}: {chams} {mpes}\n{text}")
            scores[flow] = (max(chams), max(mpes))
        if not scores["perfect"][1] < EVAL_PERFECT_MAX:
            raise AssertionError(f"viz: perfect's instance MPE {scores['perfect'][1]}")
        panels, _ = _printed(view_instance.vis_refine_ins, data_dir=str(save_root),
                             flow_mode=VIZ_INSTANCE_FLOW, ins_id=VIZ_INSTANCES,
                             out_dir=str(out / "instances"))
        if len(panels) != len(VIZ_INSTANCES):
            raise AssertionError(f"viz: vis_refine_ins wrote {panels}")
        figure, _ = _printed(schematic.main, out_dir=str(out / "figures"))
        for path, want in [*((p, [im]) for p, im in stills.items()), *animations.items()]:
            got = png.read_apng(path)[0] if path in animations else [png.read(path)]
            if len(got) != len(want) or any(
                    g.shape != w.shape or not np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"viz: {path} reads back other than its image")
        if set(png.read_apng(fly)[1]) != {(1, 10)}:
            raise AssertionError("viz: the APNG's frame delays are not 1/10 s")
        for label, paths in (("BEV PNGs", bev), ("instance panels", panels),
                             ("APNG", [fly]), ("schematic", [figure])):
            sizes[label] = (len(paths), sum(Path(p).stat().st_size for p in paths))
        n_files = len(stills) + len(animations)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"viz: a host path launched kernels: {launches}")
    present = [m for m in VIZ_ABSENT if m in sys.modules]
    if present:
        raise AssertionError(f"viz: {present} imported")
    for name, t in times.items():
        log(f"[viz] {smi}: {name} at {VIZ_RESOLUTION}x{VIZ_RESOLUTION}, host ms per frame "
            f"over {frames[name]} frames: " + ", ".join(
                f"{k} {v / frames[name] * 1e3:.3f}" for k, v in t.items()))
    log(f"[viz] {smi}: print_refine_ins instances {VIZ_INSTANCES}, largest chamfer / MPE: "
        + "; ".join(f"{k} {c:.6f} / {m:.6f} m" for k, (c, m) in scores.items()))
    log(f"[viz] {smi}: files: " + ", ".join(
        f"{n} {label} {b:,} bytes" for label, (n, b) in sizes.items())
        + f"; all {n_files} read back equal to their images; no kernel launched; "
        f"none of {', '.join(VIZ_ABSENT)} imported")
    log(f"[viz] the phase took {time.perf_counter() - phase_start:.1f} s")
    return launches


def _yaw_quat(yaw: float):
    return np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)


def _ground_points(rng, n: int) -> np.ndarray:
    """A flat road (2 cm of noise) over the ground mask's grid."""
    return np.stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                     rng.normal(0.0, 0.02, n)], 1)


def _structure_points(rng, n: int) -> np.ndarray:
    """Two walls along the road, 46-50 m to either side, 0.6-6 m high."""
    side = rng.choice([-1.0, 1.0], n)
    return np.stack([rng.uniform(-50, 50, n), side * rng.uniform(46, 50, n),
                     rng.uniform(0.6, 6.0, n)], 1)


def _object_points(rng, dims, yaw: float, center_xy, n: int) -> np.ndarray:
    """``n`` points inside a box (ego frame): within 0.9 of its length and
    width, from 0.3 m above its bottom face (or half its height) to its top."""
    length, width, height = dims
    lx = rng.uniform(-0.45, 0.45, n) * length
    ly = rng.uniform(-0.45, 0.45, n) * width
    z = INGEST_BOX_BOTTOM_M + rng.uniform(min(0.3, height / 2), height, n)
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([center_xy[0] + c * lx - s * ly, center_xy[1] + s * lx + c * ly, z], 1)


def _track_starts(rng, n: int) -> np.ndarray:
    """Start positions in cells 7 m apart within +-35 m, one object a cell."""
    cells = rng.choice(100, n, replace=False)
    return np.stack([cells % 10, cells // 10], 1) * 7.0 - 31.5 + rng.uniform(-1, 1, (n, 2))


def _labelled_cloud(rng, objects, n: int):
    """Ground, ``objects`` (a list of point arrays) and walls, ``n`` points
    in all; (points, ground mask, object mask)."""
    obj = np.concatenate(objects) if objects else np.zeros((0, 3))
    n_struct = int(n * INGEST_STRUCTURE_SHARE)
    n_ground = n - len(obj) - n_struct
    if n_ground <= 0:
        raise ValueError(f"ingest: {len(obj)} object points leave no room for the road")
    pts = np.concatenate([_ground_points(rng, n_ground), obj, _structure_points(rng, n_struct)])
    index = np.arange(n)
    return pts, index < n_ground, (index >= n_ground) & (index < n_ground + len(obj))


def _write_av2_raw(root: Path, seed: int = 0) -> dict:
    """One AV2 log under ``root`` in the sensor layout, in AV2's dtypes
    (lidar x/y/z float16, intensity and laser_number uint8, offset_ns
    uint32; poses and cuboids float64, uuids and categories large strings),
    written by ``io/arrow``: the ego drives +x at 10 m/s turning 0.05 rad/s;
    ``INGEST_AV2_TRACKS`` cuboid tracks move at constant velocity, the last
    one leaving before the last sweep. Returns each sweep's generator labels,
    ``{timestamp_ns: (ground mask, object mask)}``."""
    from himo_tpu_torch.io.arrow import write_feather

    rng = np.random.default_rng(seed)
    log = root / INGEST_AV2_LOG
    lidar = log / "sensors" / "lidar"
    lidar.mkdir(parents=True)
    n_tracks = INGEST_AV2_TRACKS
    kinds = rng.integers(0, len(AV2_OBJECTS), n_tracks)
    start = _track_starts(rng, n_tracks)
    heading = rng.uniform(-np.pi, np.pi, n_tracks)
    speed = np.array([AV2_OBJECTS[k][2] for k in kinds]) * rng.uniform(0, 1, n_tracks)
    uuids = [f"{rng.integers(1 << 32):08x}-{k:04x}-4c1d-9e6a-{rng.integers(1 << 48):012x}"
             for k in range(n_tracks)]
    ts0, poses, annos, labels = 315_969_904_359_876_000, [], [], {}
    for i in range(INGEST_AV2_SWEEPS):
        t, ts = i * 0.1, ts0 + i * 100_000_000
        ego_yaw, ego_xy = 0.05 * t, np.array([10.0 * t, 0.0])
        poses.append((ts, *_yaw_quat(ego_yaw), ego_xy[0], ego_xy[1], 0.0))
        c, s = np.cos(ego_yaw), np.sin(ego_yaw)
        objects = []
        for k in range(n_tracks - (i == INGEST_AV2_SWEEPS - 1)):
            name, dims, _ = AV2_OBJECTS[kinds[k]]
            d = start[k] + speed[k] * t * np.array([np.cos(heading[k]), np.sin(heading[k])]) \
                - ego_xy
            xy = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
            yaw = heading[k] - ego_yaw
            annos.append((ts, uuids[k], name, *dims, *_yaw_quat(yaw), xy[0], xy[1],
                          INGEST_BOX_BOTTOM_M + dims[2] / 2))
            objects.append(_object_points(rng, dims, yaw, xy, INGEST_OBJECT_POINTS))
        pts, ground, obj = _labelled_cloud(rng, objects, INGEST_AV2_POINTS)
        n = len(pts)
        write_feather(dict(
            x=pts[:, 0].astype(np.float16), y=pts[:, 1].astype(np.float16),
            z=pts[:, 2].astype(np.float16),
            intensity=rng.integers(0, 256, n, dtype=np.uint8),
            laser_number=rng.integers(0, 64, n, dtype=np.uint8),
            offset_ns=rng.integers(0, 100_000_000, n, dtype=np.uint32)), lidar / f"{ts}.feather")
        labels[ts] = (ground, obj)
    pose_cols = ("timestamp_ns", "qw", "qx", "qy", "qz", "tx_m", "ty_m", "tz_m")
    write_feather({k: np.array([p[j] for p in poses], np.int64 if j == 0 else np.float64)
                   for j, k in enumerate(pose_cols)}, log / "city_SE3_egovehicle.feather")
    anno_cols = ("timestamp_ns", "track_uuid", "category", "length_m", "width_m", "height_m",
                 "qw", "qx", "qy", "qz", "tx_m", "ty_m", "tz_m")
    kinds_of = {0: np.int64, 1: object, 2: object}
    columns = {k: np.array([a[j] for a in annos], kinds_of.get(j, np.float64))
               for j, k in enumerate(anno_cols)}
    columns["num_interior_pts"] = np.full(len(annos), INGEST_OBJECT_POINTS, np.int64)
    write_feather(columns, log / "annotations.feather")
    return labels


def _extrinsics_text(rng) -> str:
    """A vehicle's generated extrinsics YAML: each LiDAR's name and nominal
    position, with comments, quoted names and flow lists."""
    lines = ["# generated by the calibration pipeline", "---", "vehicle: 'truck07'",
             "parameters:"]
    for i, name in enumerate(SCANIA_LIDARS):
        x, y, z = np.round(rng.uniform([-4, -1.3, 1.5], [4, 1.3, 3.2]), 4)
        lines += [f"  lidarArray_arrayEl{i}:", f"    humanReadableReference: \"{name}\"",
                  "    nominalPosition:", f"      x: {x}", f"      y: {y}", f"      z: {z}",
                  f"    nominalOrientation: [0.0, 0.0, {np.round(rng.uniform(-3, 3), 6)}]"
                  "  # roll, pitch, yaw", "    enabled: yes"]
    return "\n".join(lines) + "\n"


def _write_scania_raw(root: Path, seed: int = 1):
    """``INGEST_SCANIA_SCENES`` raw Scania scenes under ``root``: superframe
    attribute files (float32 X, Y, Z, W; int8 sensor ids 1-5; int32 deltaT
    ns), each scene's sequence JSON, the pseudo-label pickle (boxes moving
    with the ego at 10 m/s, the last of each scene at infinite speed) and
    the vehicle's extrinsics YAML. Returns (pickle path, {(scene, group):
    (ground mask, object mask)})."""
    import pickle

    rng = np.random.default_rng(seed)
    ext = root / "assets" / "private" / "lidar_ext"
    ext.mkdir(parents=True)
    (ext / "truck07-generated.yml").write_text(_extrinsics_text(rng))
    n_boxes, metadata, labels = INGEST_SCANIA_BOXES, [], {}
    for k in range(1, INGEST_SCANIA_SCENES + 1):
        scene_id = f"batch_{k}"
        kinds = rng.integers(0, len(SCANIA_OBJECTS), n_boxes)
        start = _track_starts(rng, n_boxes)
        heading = rng.uniform(-np.pi, np.pi, n_boxes)
        speed = np.array([SCANIA_OBJECTS[j][2] for j in kinds]) * rng.uniform(0, 1, n_boxes)
        velocity = speed[:, None] * np.stack([np.cos(heading), np.sin(heading)], 1)
        speed[-1], velocity[-1] = np.inf, (np.inf, 0.0)  # a single-observation track
        dims = np.array([SCANIA_OBJECTS[j][1] for j in kinds])
        superframes = []
        for i in range(INGEST_SCANIA_FRAMES):
            name = f"superframe_{i + 1:05d}"
            folder = root / scene_id / name
            folder.mkdir(parents=True)
            t = 0.1 * i
            xy = start + np.nan_to_num(velocity, posinf=0.0) * t - [10.0 * t, 0.0]
            objects = [_object_points(rng, dims[j], heading[j], xy[j], INGEST_OBJECT_POINTS)
                       for j in range(n_boxes)]
            pts, ground, obj = _labelled_cloud(rng, objects, BIG_POINTS)
            n, prefix = len(pts), folder / name
            for attr, values in (("X", pts[:, 0]), ("Y", pts[:, 1]), ("Z", pts[:, 2]),
                                 ("W", rng.random(n))):
                values.astype(np.float32).tofile(f"{prefix}_{attr}.bin")
            rng.integers(1, INGEST_SCANIA_SENSORS + 1, n).astype(np.int8).tofile(
                f"{prefix}_sensor.bin")
            rng.integers(0, 100_000_000, n).astype(np.int32).tofile(f"{prefix}_deltaT.bin")
            superframes.append({"timestamp_epoch_ns": 1_600_000_000_000_000_000 + i * 100_000_000,
                                "smoothPosition": {"smothYaw_rad": 0.0, "smoothX_m": 10.0 * t,
                                                   "smoothY_m": 0.0}})
            loc = np.concatenate([xy, INGEST_BOX_BOTTOM_M + dims[:, 2:] / 2], 1)
            metadata.append({"sample_idx": scene_id, "annos": {
                "location": loc, "dimensions": dims, "heading": heading, "speed": speed,
                "velocity": velocity, "name": [SCANIA_OBJECTS[j][0] for j in kinds]}})
            labels[(scene_id, f"{i + 1:05d}")] = (ground, obj)
        (root / scene_id / f"sequence_{k}.json").write_text(json.dumps({
            "vehicle": "Truck07", "superframes": superframes,
            "lidars": {f"lidar{j}": {"name": n} for j, n in enumerate(SCANIA_LIDARS)}}))
    pkl = root / "pseudo_infos.pkl"
    pkl.write_bytes(pickle.dumps(metadata))
    return pkl, labels


@contextlib.contextmanager
def _stage_timer(module, stages: dict):
    """``module``'s functions named in ``stages`` ({stage: name}) timed while
    the block runs; yields the seconds by stage."""
    totals = dict.fromkeys(stages, 0.0)
    saved = {name: getattr(module, name) for name in stages.values()}
    for stage, name in stages.items():
        def timed(*args, _fn=saved[name], _stage=stage, **kwargs):
            start = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                totals[_stage] += time.perf_counter() - start
        setattr(module, name, timed)
    try:
        yield totals
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def _card_memory_peak():
    """The card's used memory, all processes, sampled every 5 ms on a
    thread while the block runs; yields {"base": bytes, "peak": bytes}."""
    import threading

    import torch

    free, total = torch.cuda.mem_get_info(0)
    out = {"base": total - free, "peak": total - free}
    stop = threading.Event()

    def sample():
        while not stop.wait(0.005):
            f, t = torch.cuda.mem_get_info(0)
            out["peak"] = max(out["peak"], t - f)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join(timeout=5)


def _dir_bytes(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def _compare_extraction(name: str, got_root: Path, want_root: Path, boxes_of,
                        device) -> tuple:
    """The card's extraction against the CPU's: the same files, equal
    pickles, every group and dataset bitwise, apart from the points within
    ``INGEST_FACE_TOL_M`` of a face of the boxes they were tested against
    (``boxes_of(scene, group)``; the margins computed on ``device``), where
    the box datasets may differ. Returns (points near a face, of them
    differing, points tested)."""
    import pickle

    from himo_tpu_torch.ops.points_in_boxes import face_margin

    files = sorted(p.name for p in got_root.iterdir())
    if files != sorted(p.name for p in want_root.iterdir()):
        raise AssertionError(f"{name}: files {files} against "
                             f"{sorted(p.name for p in want_root.iterdir())}")
    near = differ = tested = 0
    for fname in files:
        if fname.endswith(".pkl"):
            if pickle.loads((got_root / fname).read_bytes()) != \
                    pickle.loads((want_root / fname).read_bytes()):
                raise AssertionError(f"{name}: {fname} differs")
            continue
        got, want = _read_datasets(got_root / fname), _read_datasets(want_root / fname)
        if list(got) != list(want):
            raise AssertionError(f"{name}: {fname}'s groups differ")
        for key, arrays in want.items():
            if list(got[key]) != list(arrays):
                raise AssertionError(f"{name}: {fname}/{key} holds {list(got[key])}")
            n = len(arrays["lidar"])
            at_face = np.zeros(n, bool)
            if "flow" in arrays:
                at_face = face_margin(arrays["lidar"], boxes_of(Path(fname).stem, key),
                                      device=device) <= INGEST_FACE_TOL_M
                near, tested = near + int(at_face.sum()), tested + n
            moved = np.zeros(n, bool)
            for ds, w in arrays.items():
                g = got[key][ds]
                if g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes():
                    continue
                if ds not in INGEST_BOX_DATASETS or g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"{name}: {fname}/{key}/{ds} differs")
                d = (g != w).reshape(n, -1).any(axis=1)
                if (d & ~at_face).any():
                    raise AssertionError(f"{name}: {fname}/{key}/{ds} differs at "
                                         f"{int((d & ~at_face).sum())} points away from faces")
                moved |= d
            differ += int(moved.sum())
    return near, differ, tested


def _check_ground(name: str, root: Path, labels: dict) -> tuple:
    """The written ground masks against the generator's labels: at least
    ``INGEST_GROUND_MIN`` of road points ground, at most
    ``INGEST_OBJECT_GROUND_MAX`` of object points; returns both shares."""
    hits, scenes = {"ground": [0, 0], "objects": [0, 0]}, {}
    for (scene, key), (ground, objects) in labels.items():
        if scene not in scenes:
            scenes[scene] = _read_datasets(root / f"{scene}.h5")
        gm = scenes[scene][key]["ground_mask"]
        for kind, mask in (("ground", ground), ("objects", objects)):
            hits[kind][0] += int(gm[mask].sum())
            hits[kind][1] += int(mask.sum())
    road, obj = (hits[k][0] / hits[k][1] for k in ("ground", "objects"))
    if road < INGEST_GROUND_MIN or obj > INGEST_OBJECT_GROUND_MAX:
        raise AssertionError(f"{name}: ground_mask marks {road:.4f} of road points and "
                             f"{obj:.4f} of object points ground")
    return road, obj


def _op_times(device, name: str, pts: np.ndarray, boxes: np.ndarray) -> str:
    """``ground_mask`` and ``points_in_boxes`` on one frame of the dataset
    on the card (CUDA events and traced device time) beside the same calls
    on the CPU tensors (host ms, median of ``INGEST_RUNS``); the card's mask
    bitwise the CPU's, its ids equal away from faces."""
    import torch

    from himo_tpu_torch.ops.ground import ground_mask
    from himo_tpu_torch.ops.points_in_boxes import face_margin, points_in_boxes

    cpu_pts, cpu_boxes = torch.from_numpy(pts), torch.from_numpy(boxes)
    dev_pts, dev_boxes = cpu_pts.to(device), cpu_boxes.to(device)
    if not torch.equal(ground_mask(dev_pts).cpu(), ground_mask(cpu_pts)):
        raise AssertionError(f"ingest {name}: ground_mask on the card differs from the CPU's")
    far = face_margin(pts, boxes) > INGEST_FACE_TOL_M
    got, want = points_in_boxes(dev_pts, dev_boxes).cpu().numpy(), \
        points_in_boxes(cpu_pts, cpu_boxes).numpy()
    if (got != want)[far].any():
        raise AssertionError(f"ingest {name}: points_in_boxes on the card differs away from faces")
    parts = []
    for op, card, host in (
            ("ground_mask", lambda: ground_mask(dev_pts), lambda: ground_mask(cpu_pts)),
            ("points_in_boxes", lambda: points_in_boxes(dev_pts, dev_boxes),
             lambda: points_in_boxes(cpu_pts, cpu_boxes))):
        _, plain = _median_ms(host, INGEST_RUNS)
        parts.append(f"{op} {cuda_ms(card):.4f} ms (CUDA events), {device_ms(card):.4f} ms "
                     f"device, plain CPU {plain:.3f} ms")
    return (f"{len(pts):,} points x {len(boxes)} boxes: " + "; ".join(parts))


def _split_line(totals: dict, wall: float, frames: int) -> str:
    per = {k: v / frames * 1e3 for k, v in totals.items()}
    per["flow"] -= per["boxes"]  # compute_*_flow's own numpy, its box test apart
    per["other"] = wall / frames * 1e3 - sum(per.values())
    return ", ".join(f"{k} {v:.2f}" for k, v in per.items())


def phase_ingest(device, smi: str, root: Path) -> dict:
    """Raw logs to evaluated, compensated scenes (``phase_ingest``): the
    generators write an AV2 log and Scania scenes into ``root``;
    ``cli.extract_av2.main(nproc=1)`` and ``cli.extract_scania.main(
    nproc=INGEST_NPROC)`` (a spawn pool, one CUDA context per worker)
    extract them on the card, and again with ``device="cpu"``. Checked:
    every file the card wrote against the CPU's (bitwise but box ids at
    faces, at most ``INGEST_FACE_SHARE`` of the points near one), the
    ground masks against the generator's labels, a second ``main`` of each
    printing the skip line and leaving every file's bytes and
    ``index_total.pkl`` as they were, no kernel of the port launched. Then
    the AV2 scenes through ``cli.save model=seflowpp`` (bf16, a fresh
    checkpoint, ``max_estimation_points=NUM_POINTS``: the 512x512 forward's
    launches a frame) and flow-mode ``cli.eval`` (``perfect``, the GT flow
    written as a method, below ``EVAL_PERFECT_MAX``; ``raw`` worse;
    ``seflowpp`` finite). Prints host ms a frame by stage, the card's and
    the CPU's ms of ``ground_mask`` and ``points_in_boxes`` at these
    shapes, the spawn workers' device memory and the phase's seconds.
    Returns the launches of ``cli.save``."""
    import pickle
    import tempfile

    import torch

    from himo_tpu_torch.cli import extract_av2, extract_scania
    from himo_tpu_torch.cli.eval import main as eval_main
    from himo_tpu_torch.cli.save import main as save_main
    from himo_tpu_torch.data import av2, scania
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.schema import scene_ids, write_method_flows
    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.ops.ground import ground_mask_host
    from himo_tpu_torch.ops.points_in_boxes import points_in_boxes_host
    from himo_tpu_torch.training.checkpoints import save_checkpoint

    phase_start = time.perf_counter()
    raw_av2, raw_scania = root / "av2_raw", root / "scania_raw"
    start = time.perf_counter()
    av2_labels = _write_av2_raw(raw_av2)
    pkl, scania_labels = _write_scania_raw(raw_scania)
    log(f"[ingest] raw logs written in {time.perf_counter() - start:.2f} s: AV2 "
        f"{INGEST_AV2_SWEEPS} sweeps x {INGEST_AV2_POINTS:,} points, {INGEST_AV2_TRACKS} tracks; "
        f"Scania {INGEST_SCANIA_SCENES} scenes x {INGEST_SCANIA_FRAMES} superframes x "
        f"{BIG_POINTS:,} points, {INGEST_SCANIA_BOXES} boxes a frame")
    outs = {(ds, where): root / f"{ds}_h5_{where}" for ds in ("av2", "scania")
            for where in ("card", "cpu")}
    av2_args = dict(origin_data=str(raw_av2))
    scania_args = dict(origin_data=str(raw_scania), metadata_pkl=str(pkl))

    # The ops' first calls in this process (CUDA's lazy module loads) are
    # made here, so that the stage split is the steady state's.
    ground_mask_host(np.zeros((1, 3), np.float32), device)
    points_in_boxes_host(np.zeros((1, 3), np.float32), np.ones((1, 7), np.float32), device)
    reset_counts()
    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with _stage_timer(av2, dict(read="read_sweep", ground="ground_mask_host",
                                boxes="points_in_boxes_host", flow="compute_av2_flow",
                                write="write_frame")) as av2_split:
        extract_av2.main(output_dir=str(outs["av2", "card"]), nproc=1, device=device,
                         **av2_args)
    torch.cuda.synchronize()
    av2_wall, av2_mem = time.perf_counter() - start, torch.cuda.max_memory_allocated()
    def cpu_extractions() -> float:
        start = time.perf_counter()
        extract_av2.main(output_dir=str(outs["av2", "cpu"]), nproc=1, device="cpu",
                         **av2_args)
        extract_scania.main(output_dir=str(outs["scania", "cpu"]), nproc=1, device="cpu",
                            **scania_args)
        return time.perf_counter() - start

    # The reference extractions on the CPU run in a thread of this process
    # while the spawn workers start and extract on the card.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_run = pool.submit(cpu_extractions)
        start = time.perf_counter()
        with _card_memory_peak() as memory:
            extract_scania.main(output_dir=str(outs["scania", "card"]), nproc=INGEST_NPROC,
                                device=device, **scania_args)
        scania_wall = time.perf_counter() - start
        cpu_wall = cpu_run.result()
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"ingest: the extraction launched kernels: {launches}")
    steps = {"extract": time.perf_counter() - phase_start}

    annos = av2.load_annotations(raw_av2 / INGEST_AV2_LOG)
    metadata = pickle.loads(pkl.read_bytes())

    def av2_boxes(scene, key):
        frame = annos.get(int(key), {})
        return av2.track_boxes(frame, list(frame))

    def scania_boxes(scene, key):
        meta = [m for m in metadata if m["sample_idx"] == scene][int(key) - 1]
        return scania.grow_boxes(meta["annos"])[0].astype(np.float32)

    faces = {}
    for ds, boxes_of, labels in (("av2", av2_boxes, {(INGEST_AV2_LOG, str(ts)): v
                                                     for ts, v in av2_labels.items()}),
                                 ("scania", scania_boxes, scania_labels)):
        near, differ, tested = _compare_extraction(f"ingest {ds}", outs[ds, "card"],
                                                   outs[ds, "cpu"], boxes_of, device)
        if near > INGEST_FACE_SHARE * tested:
            raise AssertionError(f"ingest {ds}: {near} of {tested} points within "
                                 f"{INGEST_FACE_TOL_M} m of a face")
        road, obj = _check_ground(f"ingest {ds}", outs[ds, "card"], labels)
        faces[ds] = (near, differ, tested, road, obj)

    for ds, main_fn, args, n_scenes in (("av2", extract_av2.main, av2_args, 1),
                                        ("scania", extract_scania.main, scania_args,
                                         INGEST_SCANIA_SCENES)):
        before = _dir_bytes(outs[ds, "card"])
        _, text = _printed(main_fn, output_dir=str(outs[ds, "card"]), nproc=1, device=device,
                           **args)
        if text.count("already exists with all frames, skip.") != n_scenes:
            raise AssertionError(f"ingest {ds}: the second run printed {text!r}")
        if _dir_bytes(outs[ds, "card"]) != before:
            raise AssertionError(f"ingest {ds}: the second run changed the files' bytes")
    if any(read_counts().values()):
        raise AssertionError(f"ingest: the extraction launched kernels: {read_counts()}")
    steps["checks and second runs"] = time.perf_counter() - phase_start - sum(steps.values())

    # The Scania stage split: one scene again, in this process.
    with _stage_timer(scania, dict(read="read_superframe", ground="ground_mask_host",
                                   boxes="points_in_boxes_host", flow="compute_gt_flow",
                                   write="write_frame")) as scania_split:
        start = time.perf_counter()
        (root / "scania_h5_split").mkdir()
        scania.process_scene(raw_scania, root / "scania_h5_split", "batch_1",
                             [m for m in metadata if m["sample_idx"] == "batch_1"],
                             device=device)
        torch.cuda.synchronize()
        split_wall = time.perf_counter() - start

    first_ts = min(av2_labels)
    av2_pc = av2.read_sweep(raw_av2 / INGEST_AV2_LOG / "sensors" / "lidar" /
                            f"{first_ts}.feather")[0][:, :3].copy()
    op_lines = {
        "av2": _op_times(device, "av2", av2_pc, av2_boxes(None, first_ts)),
        "scania": _op_times(device, "scania", scania.read_superframe(
            str(raw_scania / "batch_1" / "superframe_00001" / "superframe_00001"))[0][:, :3]
            .copy(), scania_boxes("batch_1", "00001")),
    }

    steps["split and op times"] = time.perf_counter() - phase_start - sum(steps.values())

    # The chain: the card's AV2 scenes through cli.save and cli.eval.
    av2_root = outs["av2", "card"]
    for sid in scene_ids(av2_root):
        frames = _read_datasets(av2_root / f"{sid}.h5")
        write_method_flows(av2_root, sid, "perfect",
                           {k: v["flow"] for k, v in frames.items() if "flow" in v})
    pairs = SceneFlowDataset(av2_root, eval=True).eval_index
    before = _scene_datasets(av2_root)
    with tempfile.TemporaryDirectory(prefix="himo_ckpt_") as ckpt:
        net, _ = make_model("seflowpp", device=device, dtype="bfloat16")
        save_checkpoint(ckpt, {"params": init_params(net, torch.Generator().manual_seed(0))})
        del net
        reset_counts()
        start = time.perf_counter()
        stats = save_main(dataset_path=str(av2_root), model="seflowpp", device=device,
                          dtype="bfloat16", checkpoint=ckpt, max_estimation_points=NUM_POINTS)
        torch.cuda.synchronize()
        save_wall = time.perf_counter() - start
        launches = read_counts()
    _check_written("ingest save", av2_root, before, "seflowpp", pairs)
    want = dict.fromkeys(launches, 0)
    want.update({k: len(pairs) * v for k, v in INFER_LAUNCHES.items()})
    if stats["frames"] != len(pairs) or launches != want:
        raise AssertionError(f"ingest save: {stats['frames']} frames of {len(pairs)}, "
                             f"launches {launches} != {want}")
    cwd, scores = os.getcwd(), {}
    with tempfile.TemporaryDirectory(prefix="himo_eval_") as tmp:
        os.chdir(tmp)
        try:
            for name in ("perfect", "raw", "seflowpp"):
                metrics, _ = _printed(eval_main, data_dir=str(av2_root), res_name=name)
                scores[name] = metrics.total_summary()
        finally:
            os.chdir(cwd)
    perfect, raw = scores["perfect"], scores["raw"]
    if not (perfect["mpe"] < EVAL_PERFECT_MAX and perfect["cd"] < EVAL_PERFECT_MAX):
        raise AssertionError(f"ingest eval: perfect scores {perfect}")
    if not (raw["mpe"] > perfect["mpe"] and raw["cd"] > perfect["cd"]):
        raise AssertionError(f"ingest eval: raw {raw} is not worse than perfect {perfect}")
    if not np.isfinite([scores["seflowpp"]["mpe"], scores["seflowpp"]["cd"]]).all():
        raise AssertionError(f"ingest eval: seflowpp scores {scores['seflowpp']}")

    n_av2, n_scania = INGEST_AV2_SWEEPS, INGEST_SCANIA_FRAMES
    for ds, (near, differ, tested, road, obj) in faces.items():
        log(f"[ingest] {smi}: {ds} card vs CPU: every file, group and dataset bitwise; "
            f"{near} of {tested:,} points within {INGEST_FACE_TOL_M} m of a box face "
            f"({differ} of them differ); ground_mask marks {road:.4f} of road points and "
            f"{obj:.4f} of object points ground")
    log(f"[ingest] {smi}: extract_av2 nproc=1 {av2_wall:.3f} s, host ms a sweep: "
        + _split_line(av2_split, av2_wall, n_av2)
        + f"; peak allocated {av2_mem / 2**20:.1f} MiB")
    log(f"[ingest] {smi}: extract_scania nproc={INGEST_NPROC} {scania_wall:.3f} s for "
        f"{INGEST_SCANIA_SCENES} scenes; the card's memory rose by "
        f"{(memory['peak'] - memory['base']) / 2**20:.1f} MiB with {INGEST_NPROC} spawn "
        f"workers ({(memory['peak'] - memory['base']) / INGEST_NPROC / 2**20:.1f} MiB a "
        "worker: its CUDA context and allocations)")
    log(f"[ingest] {smi}: scania one scene in this process {split_wall:.3f} s, host ms a "
        "superframe: " + _split_line(scania_split, split_wall, n_scania))
    log(f"[ingest] the CPU extractions took {cpu_wall:.3f} s, beside the spawn pool")
    for ds, line in op_lines.items():
        log(f"[ingest] {smi}: {ds} {line}")
    log(f"[ingest] {smi}: second runs printed the skip line and left every file's bytes; "
        f"cli.save model=seflowpp {stats['frames']} frame pairs, {save_wall:.3f} s, launches "
        f"{({k: v for k, v in launches.items() if v})}; eval MPE / CDE: " + "; ".join(
            f"{k} {v['mpe']:.6f} / {v['cd']:.6f} m" for k, v in scores.items()))
    steps["save and eval"] = time.perf_counter() - phase_start - sum(steps.values())
    log(f"[ingest] the phase took {time.perf_counter() - phase_start:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in steps.items()))
    return launches


def _snapshot_counts():
    from himo_tpu_torch.ops import mxu_scatter as pms

    return ({key: getattr(*key).launches for key in _wrappers()},
            dict(pms.sorted_segment_sum.launches_by_c))


def _restore_counts(snap) -> None:
    """Set every wrapper's count back to a :func:`_snapshot_counts`, so that
    launches made to compare kernels with their plain versions inside a
    path's run are not counted as the path's."""
    from himo_tpu_torch.ops import mxu_scatter as pms

    counts, by_c = snap
    for key, n in counts.items():
        getattr(*key).launches = n
    pms.sorted_segment_sum.launches_by_c = dict(by_c)


def _check_step_vs_plain(name, model, loss_fn) -> None:
    """The loss and gradients of ``loss_fn()`` through the kernels against
    the same with the plain versions on the card, at the current weights:
    loss within ``TERM_RTOL`` relative, gradient norm within ``NORM_RTOL``,
    cosine at least ``MIN_COSINE``; the launches it makes are not counted."""
    import torch

    snap = _snapshot_counts()
    with plain_kernels():
        model.zero_grad(set_to_none=True)
        plain = loss_fn()
        plain.backward()
    plain_grads = _grads(model)
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    grads = _grads(model)
    model.zero_grad(set_to_none=True)
    _restore_counts(snap)
    loss, plain = float(loss.detach()), float(plain.detach())
    rel = abs(loss - plain) / max(abs(plain), 1e-12)
    norm, plain_norm = float(grads.norm()), float(plain_grads.norm())
    norm_rel = abs(norm - plain_norm) / plain_norm
    cosine = float(torch.nn.functional.cosine_similarity(grads, plain_grads, dim=0))
    log(f"[{name}] step 1, kernels vs plain: loss {loss:.6f} / {plain:.6f} (rel "
        f"{rel:.3e}), grad norm {norm:.6f} / {plain_norm:.6f} (rel {norm_rel:.3e}), "
        f"cosine {cosine:.6f}")
    if not np.isfinite(loss) or rel > TERM_RTOL or norm_rel > NORM_RTOL or cosine < MIN_COSINE:
        raise AssertionError(f"{name} step 1 through the kernels disagrees with the plain run "
                             f"(limits: loss {TERM_RTOL}, norm {NORM_RTOL}, cosine {MIN_COSINE})")


@contextlib.contextmanager
def probed_steps(module, attr: str, name: str, loss_of, expected: dict, record: dict):
    """Wrap ``module.<attr>`` (a train-step factory ``make(model,
    optimizer)``) while the block runs: before the first step, the step's
    loss and gradients are held against the plain versions
    (:func:`_check_step_vs_plain` on ``loss_of(model, *args)``); each step
    is synchronized and timed into ``record["step_ms"]``, must launch
    exactly ``expected`` and return a finite loss; ``record["step"]`` and
    ``record["forward"]`` keep the last step and the network's no-grad
    forward on that step's frame, to be called again."""
    import torch

    make = getattr(module, attr)

    def probed_make(model, optimizer):
        step = make(model, optimizer)

        def probed(*args):
            if not record["step_ms"]:
                _check_step_vs_plain(name, model, lambda: loss_of(model, *args))
            before = read_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss = step(*args)
            torch.cuda.synchronize()
            record["step_ms"].append((time.perf_counter() - start) * 1e3)
            after = read_counts()
            got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if got != expected:
                raise AssertionError(f"{name} step {len(record['step_ms'])} launches {got} "
                                     f"!= {expected}")
            if not np.isfinite(float(loss)):
                raise AssertionError(f"{name} step {len(record['step_ms'])}: loss {loss}")
            record["step"] = lambda: step(*args)
            record["forward"] = torch.inference_mode()(lambda: model(*args[:2]))
            return loss

        return probed

    setattr(module, attr, probed_make)
    try:
        yield record
    finally:
        setattr(module, attr, make)


def _busy_calls(fn, calls: int = DOWNSTREAM_TRACE_CALLS):
    """``(device busy ms, wall ms)`` per call of ``fn`` (warm) over
    ``calls`` traced calls, each in a ``DOWNSTREAM_LABEL`` range and
    synchronized."""
    import torch
    from torch.profiler import record_function

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            with record_function(DOWNSTREAM_LABEL):
                fn()
                torch.cuda.synchronize()

    _, events = traced(run)
    busy, wall = window_busy(events, DOWNSTREAM_LABEL)
    return busy / calls, wall / calls


def _check_seg_written(root: Path, before: dict, key: str) -> None:
    """Every frame group holds what it held in ``before``, bytes unchanged,
    plus a uint8 ``key`` of its point count holding only the three classes'
    category indices, and ``seg_valid`` (uint8 ones)."""
    from himo_tpu_torch.downstream.segmentation import _expand_labels

    classes = set(_expand_labels(np.arange(3)).tolist())
    after = _scene_datasets(root)
    for scene, groups in before.items():
        if after[scene].keys() != groups.keys():
            raise AssertionError(f"seg_h5 {key}: {scene}'s groups changed")
        for group, arrays in groups.items():
            got = after[scene][group]
            if set(got) != set(arrays) | {key, "seg_valid"}:
                raise AssertionError(f"seg_h5 {key}: {scene}/{group} holds {sorted(got)}")
            for ds, arr in arrays.items():
                if ds in (key, "seg_valid"):
                    continue
                if got[ds].dtype != arr.dtype or got[ds].tobytes() != arr.tobytes():
                    raise AssertionError(f"seg_h5 {key}: {scene}/{group}/{ds} changed")
            n = len(arrays["lidar"])
            seg, valid = got[key], got["seg_valid"]
            if seg.dtype != np.uint8 or seg.shape != (n,) or not set(np.unique(seg)) <= classes:
                raise AssertionError(f"seg_h5 {key}: {scene}/{group} {seg.dtype} {seg.shape}")
            if valid.dtype != np.uint8 or valid.shape != (n,) or not (valid == 1).all():
                raise AssertionError(f"seg_h5 {key}: {scene}/{group} seg_valid is not ones")


def _check_seg_first_frame(device, root: Path, ckpt: str, mode: str):
    """The first frame's logits through the kernels against the plain
    versions on the card (the checkpoint's weights, the input as
    ``segment_dataset`` makes it): argmax equal wherever the top-2 margin
    exceeds ``SEG_MARGIN``, and the labels written equal to the kernels'
    there. Returns the max abs difference of the logits and the share of
    points compared."""
    import torch

    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.downstream import segmentation as seg
    from himo_tpu_torch.training.checkpoints import load_checkpoint

    model, _ = seg.make_seg_model(device=device, **SEG_OVERRIDES)
    model.load_state_dict(load_checkpoint(ckpt)["params"])
    model.eval()
    data = SceneFlowDataset(root, vis_name=mode if mode != "raw" else "")[0]
    pts, valid, n = seg.seg_inputs(data, seg._dataset_name(str(root)), mode, DOWNSTREAM_POINTS)
    pts, valid = (torch.from_numpy(a).to(device)[None] for a in (pts, valid))
    snap = _snapshot_counts()
    with torch.inference_mode():
        got = model(pts, valid)[0]
        with plain_kernels():
            want = model(pts, valid)[0]
    _restore_counts(snap)
    m = min(n, DOWNSTREAM_POINTS)
    got, want = got[:m].float().cpu().numpy(), want[:m].float().cpu().numpy()
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > SEG_MARGIN
    if not np.array_equal(got.argmax(1)[sure], want.argmax(1)[sure]):
        raise AssertionError(f"seg_h5 {mode}: the first frame's argmax differs from the plain run")
    written = _read_datasets(root / f"{data['scene_id']}.h5")[str(data["timestamp"])]
    if not np.array_equal(written[f"seg_{mode}"][:m][sure],
                          seg._expand_labels(got.argmax(1))[sure]):
        raise AssertionError(f"seg_h5 {mode}: the labels written are not the kernels' argmax")
    return float(np.abs(got - want).max()), float(sure.mean())


def _downstream_kernels(device, root: Path):
    """K1 max, K1 sum, K5 and K3 max at the downstream shapes: the first
    frame's 32,768 points (``seg_inputs``, raw) on SegNet's grid and on
    DetNet's, features at the networks' widths; each against its plain
    version (bitwise; the sum within 1e-5 * sum|x| + 1e-6) and timed beside
    its library call, its bound printed; K5 also with a cold L2."""
    import torch

    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.downstream.det_net import DetNetConfig
    from himo_tpu_torch.downstream.segmentation import SegConfig, _dataset_name, seg_inputs
    from himo_tpu_torch.ops import voxelize as pvox

    data = SceneFlowDataset(root)[0]
    pts, valid, _ = seg_inputs(data, _dataset_name(str(root)), "raw", DOWNSTREAM_POINTS)
    pts, valid = (torch.from_numpy(a).to(device)[None] for a in (pts, valid))
    seg_cfg = SegConfig(**SEG_OVERRIDES)
    det_cfg = DetNetConfig(pillar=pvox.PillarConfig(voxel_size=(DET_VOXEL, DET_VOXEL)))
    pids = pvox.voxelize_pillars(pts, valid, seg_cfg.pillar).pillar_ids.contiguous()
    rows = seg_cfg.pillar.num_pillars
    width, hidden = seg_cfg.point_feat_dim, seg_cfg.base_channels * 2
    out = {}
    feats = _relu_feats(device, (1, DOWNSTREAM_POINTS, width), 11)
    out["scatter_max_rows"] = _check_max("[downstream] scatter_max_rows (SegNet)",
                                         pvox.scatter_max_rows, pvox._scatter_max_rows_plain,
                                         pids, feats, rows)
    vals = _sparse_cotangents(device, (1, DOWNSTREAM_POINTS, hidden), 12)
    out["scatter_sum_rows"] = _check_sum_kernel("[downstream] scatter_sum_rows (SegNet)",
                                                pvox.scatter_sum_rows,
                                                pvox._scatter_sum_rows_plain, pids, vals, rows)
    spids, order = pvox._stable_sort(pids)
    gen = torch.Generator(device=device).manual_seed(13)
    image = torch.randn(1, rows, 2 * width, device=device, generator=gen)
    table = torch.cat([image.reshape(-1, 2 * width), image.new_zeros(1, 2 * width)])
    flat = _flat_rows(pids, rows)
    out["sorted_gather_rows"] = _check_gather(
        "[downstream] sorted_gather_rows (SegNet)", pvox.sorted_gather_rows,
        pvox._sorted_gather_rows_plain, (image, spids, order), pids,
        lambda: torch.index_select(table, 0, flat), cold=True)
    dpids = pvox.voxelize_pillars(pts, valid, det_cfg.pillar).pillar_ids.contiguous()
    out["scatter_max_resident_rows"] = _check_max(
        "[downstream] scatter_max_resident_rows (DetNet)", pvox.scatter_max_resident_rows,
        pvox._scatter_max_rows_plain, dpids, feats, det_cfg.pillar.num_pillars)
    for k, v in out.items():
        log(f"[downstream] {k}: " + json.dumps(v))
    return out


def phase_downstream(device, smi: str, root: Path) -> dict:
    """The downstream harness end to end on the scenes in ``root``
    (``phase_save``'s, after ``phase_eval``): ``cli.seg_h5`` trains one
    epoch (step 1 held against the plain versions, each step's launches
    checked) and segments ``raw``, then segments ``perfect`` from the saved
    checkpoint; the seg datasets written, every other dataset unchanged,
    the first frame's logits against the plain run; ``cli.eval_seg``
    scores both (finite mIoU). ``cli.det_h5`` with ``detector=learned``
    (one epoch, checked as the segmentation's) and then the geometric
    detector (no launch) on ``raw`` and ``perfect``; finite metrics. Then
    K1 max, K1 sum, K5 and K3 max at these shapes (:func:`_downstream_kernels`).
    Prints host and device ms per train step and per frame and the busy
    share. Returns the launches of the CLI runs."""
    import tempfile

    import torch

    from himo_tpu_torch.cli import det_h5, eval_seg, seg_h5
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.downstream import det_net, segmentation

    phase_start = time.perf_counter()
    # On the card the CLIs take their default device, the GPU.
    dev_kw = {} if device.type == "cuda" else {"device": device}
    frames = len(SceneFlowDataset(root))
    eval_frames = len(SceneFlowDataset(root, eval=True))
    total = dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    def expect(name, counts, parts):
        want = dict.fromkeys(counts, 0)
        for n, launches in parts:
            for k, v in launches.items():
                want[k] += n * v
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} != {want}")

    seg_rec = {"step_ms": []}
    with tempfile.TemporaryDirectory(prefix="himo_seg_ckpt_") as tmp:
        ckpt = str(Path(tmp) / "seg")
        walls, agree = {}, {}
        for mode in DOWNSTREAM_MODES:
            before = _scene_datasets(root)
            kw = dict(train=True, epochs=1) if mode == DOWNSTREAM_MODES[0] else {}
            probe = probed_steps(segmentation, "make_seg_step", "seg_h5 train",
                                 segmentation.seg_loss, SEG_STEP_LAUNCHES, seg_rec)
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            with probe:
                n = seg_h5.main(path_dataset=str(root), ckpt=ckpt, flow_mode=mode,
                                num_points=DOWNSTREAM_POINTS, **kw, **dev_kw, **SEG_OVERRIDES)
            torch.cuda.synchronize()
            walls[mode] = (time.perf_counter() - start) * 1e3
            launches = read_counts()
            steps = len(seg_rec["step_ms"]) if kw else 0
            expect(f"seg_h5 {mode}", launches,
                   [(steps, SEG_STEP_LAUNCHES), (n, SEG_FRAME_LAUNCHES)])
            if n != frames or (kw and steps != frames):
                raise AssertionError(f"seg_h5 {mode}: {n} frames, {steps} steps of {frames}")
            add(launches)
            _check_seg_written(root, before, f"seg_{mode}")
            agree[mode] = _check_seg_first_frame(device, root, ckpt, mode)
    snap = _snapshot_counts()
    seg_step_busy, seg_step_wall = _busy_calls(seg_rec["step"])
    seg_busy, seg_wall = _busy_calls(seg_rec["forward"])
    _restore_counts(snap)
    start = time.perf_counter()
    scores = eval_seg.main(data_dir=str(root), res_names=[f"seg_{m}" for m in DOWNSTREAM_MODES])
    eval_ms = (time.perf_counter() - start) * 1e3
    if not all(np.isfinite(r["miou"]) for r in scores.values()):
        raise AssertionError(f"eval_seg: {scores}")
    train_ms = seg_rec["step_ms"]
    cfg = segmentation.SegConfig(**SEG_OVERRIDES)
    log(f"[downstream] {smi}: seg_h5 SegNet, grid {cfg.pillar.grid_shape}, depths "
        f"{cfg.depths}, {cfg.dtype}, at "
        f"{DOWNSTREAM_POINTS:,} points: {len(train_ms)} train steps (one epoch), median "
        f"{np.median(train_ms[1:] or train_ms):.3f} ms a step wall synchronized (step 1 "
        f"{train_ms[0]:.3f}); traced: device busy {seg_step_busy:.3f} ms of {seg_step_wall:.3f}"
        f" ms a step, busy share {seg_step_busy / seg_step_wall:.4f}")
    log(f"[downstream] {smi}: seg_h5 inference: " + "; ".join(
        f"{m} {walls[m] / frames:.3f} host ms a frame through the CLI" for m in walls)
        + f" (the train run's includes its {len(train_ms)} steps); the forward alone (the "
        f"last train frame): device busy {seg_busy:.3f} ms of {seg_wall:.3f} ms, busy share "
        f"{seg_busy / seg_wall:.4f}")
    log(f"[downstream] seg_h5 first frame, kernels vs plain: " + "; ".join(
        f"{m} max |logit diff| {d:.3e}, argmax equal on the {s:.4f} of points with a top-2 "
        f"margin above {SEG_MARGIN}" for m, (d, s) in agree.items()))
    log(f"[downstream] {smi}: eval_seg mIoU " + ", ".join(
        f"{k} {v['miou']:.6f}" for k, v in scores.items())
        + f" ({eval_ms / eval_frames:.3f} host ms a frame; random weights, one epoch)")
    del seg_rec
    torch.cuda.empty_cache()

    det_rec = {"step_ms": []}
    reset_counts()
    start = time.perf_counter()
    with probed_steps(det_net, "make_det_step", "det_h5 train",
                      lambda m, *a: det_net.det_loss(m, *a)[0], DET_STEP_LAUNCHES, det_rec):
        learned = det_h5.main(data_dir=str(root), flow_modes=list(DOWNSTREAM_MODES),
                              detector="learned", epochs=1, num_points=DOWNSTREAM_POINTS,
                              voxel=DET_VOXEL, **dev_kw)
    torch.cuda.synchronize()
    det_wall = (time.perf_counter() - start) * 1e3
    launches = read_counts()
    steps = len(det_rec["step_ms"])
    expect("det_h5 learned", launches,
           [(steps, DET_STEP_LAUNCHES), (eval_frames * len(DOWNSTREAM_MODES), DET_FRAME_LAUNCHES)])
    if steps == 0 or not all(np.isfinite(v) for r in learned.values() for v in r.values()):
        raise AssertionError(f"det_h5 learned: {steps} steps, {learned}")
    add(launches)
    snap = _snapshot_counts()
    det_step_busy, det_step_wall = _busy_calls(det_rec["step"])
    det_busy, det_fwd_wall = _busy_calls(det_rec["forward"])
    _restore_counts(snap)

    reset_counts()
    start = time.perf_counter()
    geometric = det_h5.main(data_dir=str(root), flow_modes=list(DOWNSTREAM_MODES))
    geo_ms = (time.perf_counter() - start) * 1e3 / (eval_frames * len(DOWNSTREAM_MODES))
    launches = read_counts()
    expect("det_h5 geometric", launches, [])
    if not all(np.isfinite(v) for r in geometric.values() for v in r.values()):
        raise AssertionError(f"det_h5 geometric: {geometric}")
    det_ms = det_rec["step_ms"]
    log(f"[downstream] {smi}: det_h5 learned DetNet at voxel {DET_VOXEL} "
        f"({eval_frames} eval frames): {steps} train steps, median "
        f"{np.median(det_ms[1:] or det_ms):.3f} ms a step wall synchronized (step 1 "
        f"{det_ms[0]:.3f}); traced: device busy {det_step_busy:.3f} ms of {det_step_wall:.3f} "
        f"ms a step, busy share {det_step_busy / det_step_wall:.4f}; the forward alone: "
        f"device busy {det_busy:.3f} ms of {det_fwd_wall:.3f} ms, busy share "
        f"{det_busy / det_fwd_wall:.4f}; the whole CLI {det_wall:.3f} ms, "
        f"{det_wall / (steps + eval_frames * len(DOWNSTREAM_MODES)):.3f} a step or frame; "
        + "; ".join(
            f"{m} P {r['precision']:.3f} R {r['recall']:.3f} F1 {r['f1']:.3f}"
            for m, r in learned.items()))
    log(f"[downstream] {smi}: det_h5 geometric: {geo_ms:.3f} host ms a frame, no launch; "
        + "; ".join(f"{m} P {r['precision']:.3f} R {r['recall']:.3f} F1 {r['f1']:.3f} "
                    f"meanIoU {r['mean_iou']:.3f}" for m, r in geometric.items()))
    log(f"[downstream] launches {({k: v for k, v in total.items() if v})}")
    _downstream_kernels(device, root)
    log(f"[downstream] the phase took {time.perf_counter() - phase_start:.1f} s")
    return total


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
    corr = phase_correlation(device)
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
    torch.cuda.empty_cache()
    phase_native(smi)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="himo_inference_") as tmp:
        fleet_root, save_root = Path(tmp) / "av2_fleet", Path(tmp) / "av2_save"
        paths.append(phase_fleet(device, smi, fleet_root))
        torch.cuda.empty_cache()
        paths += phase_data_parallel(device, smi, fleet_root, Path(tmp))
        torch.cuda.empty_cache()
        paths.append(phase_save(device, smi, save_root))
        phase_eval(smi, save_root, fleet_root)
        # Last on the fleet's scenes: its write-back adds a dataset to them.
        phase_fleet_stages(device, smi, root, fleet_root)
        torch.cuda.empty_cache()
        reset_counts()
        phase_submit(smi, save_root, root)
        paths.append(read_counts())
        if any(paths[-1].values()):
            raise AssertionError(f"submit: a host path launched kernels: {paths[-1]}")
        paths.append(phase_viz(smi, save_root))
        torch.cuda.empty_cache()
        paths.append(phase_ingest(device, smi, Path(tmp) / "ingest"))
        torch.cuda.empty_cache()
        paths.append(phase_downstream(device, smi, save_root))
        torch.cuda.empty_cache()
        paths.append(phase_quality(device, smi, root, Path(tmp) / "quality"))
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
             source="himo_tpu_torch/csrc/sorted_scatter.cu",
             replaces="himo_tpu/ops/voxelize.py:63",
             launches=total["segment_rows_sum"], **segment[SEGMENT_SHAPES[1]]),
        dict(name="segment_rows_sum (nsfp)", route="cuda",
             source="himo_tpu_torch/csrc/sorted_scatter.cu",
             replaces="himo_tpu/ops/voxelize.py:63",
             launches=total["segment_rows_sum"], **segment[NSFP_SEGMENT[1:]]),
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
        *(dict(name=name, route="cuda", source="himo_tpu_torch/csrc/correlation.cu",
               replaces="none (himo_tpu/models/feedforward.py:223 is a lax.map)",
               launches=total[name], **row) for name, row in corr.items()),
    ]
    log(f"traces: {len(LEAD_LOST)}, each opened by {LEAD_FILLS} fills; fills that lost "
        f"their device event, trace by trace: {LEAD_LOST}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
