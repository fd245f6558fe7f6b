"""Run a flow estimator over a dataset and write results into the .h5 scenes
(port of ``himo_tpu/models/runner.py``).

This is the surface of the reference's OpenSceneFlow ``save.py`` CLI
(README.md:46-53): per-frame (N, 3) float32 TOTAL flow (ego motion included)
stored in the frame group under the method name, which ``cli.eval`` then
consumes as ``data[res_name]``.

Estimation happens in the ego-compensated frame: pc0 is first warped by the
pose flow into the pc1 frame, the estimator recovers the residual (object)
motion between static-aligned clouds, and the stored flow is
``pose_flow + residual``. Ground points are excluded from estimation (they
carry pure pose flow).

The host preparation is the reference's numpy; the clouds, masks and sweep
times go to the estimator as tensors on its device. Where the reference
appends each frame's flow to its scene file, the port buffers a scene's
flows and rewrites the file once (``data/schema.write_method_flows``),
and once more for a scene whose first pairs the scene-start repair
re-estimated.
"""

from __future__ import annotations

import inspect
import time
from typing import Dict, Optional

import numpy as np
import torch

from himo_tpu_torch import native
from himo_tpu_torch.core.transforms import relative_pose, rigid_flow, transform_points
from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.data.padding import bucket_size
from himo_tpu_torch.data.schema import write_method_flows
from himo_tpu_torch.models.feedforward import resolve_device
from himo_tpu_torch.models.registry import get_estimator
from himo_tpu_torch.utils.profiling import Timer


def _pad_cloud(xyz: np.ndarray, valid: np.ndarray, target: int):
    n = len(xyz)
    out = np.zeros((target, 3), dtype=np.float32)
    out[:n] = xyz[:, :3]
    v = np.zeros(target, dtype=bool)
    v[:n] = valid
    return out, v


def _upsample_flow(
    full_xyz: np.ndarray, sub_xyz: np.ndarray, sub_flow: np.ndarray
) -> np.ndarray:
    """Nearest-neighbor flow upsampling from a subsampled estimation cloud."""
    if native.available():
        _, idx = native.KDTree(sub_xyz).query(full_xyz)
    else:
        from scipy.spatial import cKDTree

        _, idx = cKDTree(sub_xyz).query(full_xyz, k=1)
    return sub_flow[idx]


def _split(generator: torch.Generator) -> torch.Generator:
    """A fresh generator seeded from ``generator``'s next draw: the port's
    ``jax.random.split``, so what one frame's estimator draws never shifts
    another frame's seed."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)


def estimate_scene_flow(
    data_dir: str,
    model: str = "fastnsf",
    output_key: Optional[str] = None,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    verbose: bool = True,
    max_estimation_points: Optional[int] = None,
    device: torch.device | str | None = None,
    **overrides,
) -> Dict[str, float]:
    """Estimate flow for every frame pair and write it back to the scenes.

    ``max_estimation_points`` caps the cloud size fed to the estimator
    (standard practice for the optimization-based models, whose per-iteration
    NN cost is quadratic): clouds are randomly subsampled for estimation and
    the flow is NN-upsampled back to every point. The estimator runs on
    ``device`` (default: the GPU; raises without CUDA).

    Returns throughput stats (frames, points, seconds, points_per_sec) and
    ``repaired``, the frame pairs the scene-start repair re-estimated.
    """
    dev = resolve_device(device)
    kwargs = dict(overrides)
    if checkpoint is not None:
        kwargs["checkpoint"] = checkpoint
    estimator = get_estimator(model, device=dev, **kwargs)
    output_key = output_key or model
    # Feed-forward ++ variants consume a third (history) sweep.
    with_history = getattr(estimator, "num_frames", 2) >= 3
    # Estimators that accept sweep times / scene identity get them: dt0/dt1
    # drive the de-smeared prior matcher, (scene_id, pose1) its per-scene
    # velocity-continuity tracker (frames arrive in scene order here).
    est_params = set(inspect.signature(estimator).parameters)
    aux_keys = {"dt0", "dt1", "scene_id", "pose1"} & est_params

    dataset = SceneFlowDataset(
        data_dir, with_pc1=True, with_history=with_history,
        next_keys=("lidar_dt",),
    )
    generator = torch.Generator().manual_seed(seed)
    timer = Timer()
    total_points = 0
    frames = 0
    start = time.perf_counter()

    early_pairs: Dict[str, list] = {}  # scene -> dataset indices of pairs 0-1
    pairs_in_scene: Dict[str, int] = {}
    flows: Dict[str, Dict[str, np.ndarray]] = {}  # scene -> timestamp -> flow, unwritten

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def process(i: int, gen: torch.Generator) -> int:
        """Estimate one frame pair into ``flows``; returns points estimated
        (0 if the frame has no successor)."""
        with timer("load"):
            data = dataset[i]
        # Scene-final frames have no successor to estimate against — skip
        # every one of them (matching the eval-index exclusion), not just the
        # dataset-final frame.
        if not data.get("has_next", True):
            return 0
        sid = data["scene_id"]
        if len(early_pairs.setdefault(sid, [])) < 2 and i not in early_pairs[sid]:
            early_pairs[sid].append(i)
        pairs_in_scene[sid] = pairs_in_scene.get(sid, 0) + 1
        xyz0 = data["pc0"][:, :3]
        xyz1 = data["pc1"][:, :3]
        rng_np = np.random.default_rng(seed + i)
        with timer("prep"):
            pflow = rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
            pc0_comp = xyz0 + pflow
            est0, est1 = pc0_comp, xyz1
            gm0, gm1 = np.asarray(data["gm0"], bool), np.asarray(data["gm1"], bool)
            dt0 = np.asarray(data["lidar_dt"], np.float32)
            dt1 = np.asarray(
                data.get("lidar_dt1", np.zeros(len(xyz1), np.float32)),
                np.float32,
            )
            sub_idx = None
            if max_estimation_points is not None:
                if len(est0) > max_estimation_points:
                    sub_idx = rng_np.choice(
                        len(est0), max_estimation_points, replace=False
                    )
                    est0, gm0, dt0 = est0[sub_idx], gm0[sub_idx], dt0[sub_idx]
                if len(est1) > max_estimation_points:
                    keep1 = rng_np.choice(
                        len(est1), max_estimation_points, replace=False
                    )
                    est1, gm1, dt1 = est1[keep1], gm1[keep1], dt1[keep1]
            target = bucket_size(max(len(est0), len(est1)))
            p0, v0 = _pad_cloud(est0, ~gm0, target)
            p1, v1 = _pad_cloud(est1, ~gm1, target)
            history = None
            if with_history:
                xyzp = data["pc_prev"][:, :3].astype(np.float32)
                rel = relative_pose(data["pose_prev"], data["pose1"])
                hist = transform_points(xyzp, rel).astype(np.float32)
                gmh = np.asarray(data["gm_prev"], bool)
                if len(hist) > target:  # fit the estimation bucket
                    keep = rng_np.choice(len(hist), target, replace=False)
                    hist, gmh = hist[keep], gmh[keep]
                history = tuple(on_device(a) for a in _pad_cloud(hist, ~gmh, target))
        with timer("estimate"):
            aux = {}
            if aux_keys:
                d0p = np.zeros(target, np.float32)
                d0p[: len(est0)] = dt0[: len(est0)]
                d1p = np.zeros(target, np.float32)
                d1p[: len(est1)] = dt1[: len(est1)]
                full_aux = {
                    "dt0": on_device(d0p),
                    "dt1": on_device(d1p),
                    "scene_id": sid,
                    # Host metadata for the per-scene tracker, as in the
                    # reference (float64).
                    "pose1": np.asarray(data["pose1"]),
                }
                aux = {k: full_aux[k] for k in aux_keys}
            args = [on_device(a) for a in (p0, p1, v0, v1)]
            if with_history:
                residual, _ = estimator(*args, gen, history=history, **aux)
            else:
                residual, _ = estimator(*args, gen, **aux)
            residual = residual.detach().cpu().numpy()[: len(est0)]
        if sub_idx is not None:
            with timer("upsample"):
                residual = _upsample_flow(pc0_comp, est0, residual)
        flows.setdefault(sid, {})[data["timestamp"]] = (pflow + residual).astype(np.float32)
        return len(xyz0)

    def write(sid: str) -> None:
        with timer("write"):
            write_method_flows(data_dir, sid, output_key, flows.pop(sid))

    for i in range(len(dataset)):
        pts = process(i, _split(generator))
        if pts:
            total_points += pts
            frames += 1
        # A scene's frames are contiguous in the index: write its flows
        # when the next frame belongs to another scene.
        sid = dataset.data_index[i][0]
        if sid in flows and (i + 1 == len(dataset) or dataset.data_index[i + 1][0] != sid):
            write(sid)

    # Scene-start repair (offline, like the label writers): each scene's
    # first TWO pairs were estimated before velocity-continuity tracks
    # confirm — the places a merged-cluster blend or convoy swap has
    # nothing to overrule it, and a slow mover's sub-tolerance motion has
    # no measured-track evidence against the null/snap demotions.
    # Re-estimate them with the scene's confirmed tracks rolled back under
    # constant velocity (models/icp_flow.ClusterTracker.backcast) when the
    # estimator exposes its per-scene trackers and the scene ran long
    # enough to confirm them.
    repaired = 0
    trackers = getattr(estimator, "trackers", None)
    if trackers:
        repair = [
            (sid, j, idx, pairs_in_scene.get(sid, 0))
            for sid, idxs in early_pairs.items()
            for j, idx in enumerate(idxs)
        ]
        for sid, j, idx, n_pairs in repair:
            tr = trackers.get(sid)
            if tr is None or n_pairs < 3:
                continue
            # Backcast from the scene-END tracker state (each repair's
            # process() call mutates trackers[sid], so swap the backcast in
            # and restore the preserved original in a finally — a raise
            # mid-repair must not leave the shared dict holding the
            # backcast copy).
            back = tr.backcast(n_frames=n_pairs - j)
            if not back.tracks:
                continue
            trackers[sid] = back
            try:
                process(idx, _split(generator))
            finally:
                trackers[sid] = tr
            repaired += 1
        for sid in list(flows):
            write(sid)

    elapsed = time.perf_counter() - start
    if verbose:
        timer.print_summary()
        print(
            f"{model}: {frames} frames, {total_points} points in {elapsed:.2f}s "
            f"({total_points / max(elapsed, 1e-9) / 1e6:.2f} M pts/s)"
        )
    return {
        "frames": frames,
        "points": total_points,
        "seconds": elapsed,
        "points_per_sec": total_points / max(elapsed, 1e-9),
        "repaired": repaired,
    }
