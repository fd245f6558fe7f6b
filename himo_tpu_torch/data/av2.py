"""Argoverse 2 sensor-dataset ingestion: raw logs -> .h5 scenes (port of
``himo_tpu/data/av2.py``, without pandas or h5py).

The standard AV2 sensor layout::

    {log_id}/
      city_SE3_egovehicle.feather      # timestamp_ns, qw..qz, tx_m..tz_m
      annotations.feather              # cuboids per sweep, ego frame
      sensors/lidar/{timestamp_ns}.feather  # x y z intensity laser_number offset_ns

Feathers are read by :mod:`himo_tpu_torch.io.arrow` (AV2's own float16 /
uint8 / uint32 lidar columns and the fixtures' float32 / int64 alike, to the
arrays pandas gives); scenes are written by :class:`data.schema.AppendScene`.

GT flow follows the track-transform identity: a point p (ego0) on track T
moves to ``inv(pose1) @ city_T1 @ inv(city_T0) @ pose0 @ p`` at t1; static
points get the pure ego-motion flow. Every numpy step is the reference's,
in float64 where it is, so the written datasets are bitwise its own; only
the box test (:func:`ops.points_in_boxes.points_in_boxes`) and the ground
mask (:func:`ops.ground.ground_mask`) run on ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from himo_tpu_torch.core.categories import CATEGORY_TO_INDEX, NAME_MAPPING
from himo_tpu_torch.core.transforms import relative_pose, transform_points
from himo_tpu_torch.data.schema import AppendScene, FrameData, write_frame
from himo_tpu_torch.io.arrow import read_feather
from himo_tpu_torch.models.feedforward import resolve_device
from himo_tpu_torch.ops.ground import ground_mask_host
from himo_tpu_torch.ops.points_in_boxes import points_in_boxes_host

BOX_EXPANSION = 0.2  # compute_av2_flow's default growth of each cuboid (m)


def quat_to_rotation(qw, qx, qy, qz) -> np.ndarray:
    """(…,) quaternion components -> (…, 3, 3) rotation matrices."""
    qw, qx, qy, qz = (np.asarray(v, np.float64) for v in (qw, qx, qy, qz))
    r = np.empty(qw.shape + (3, 3))
    r[..., 0, 0] = 1 - 2 * (qy**2 + qz**2)
    r[..., 0, 1] = 2 * (qx * qy - qw * qz)
    r[..., 0, 2] = 2 * (qx * qz + qw * qy)
    r[..., 1, 0] = 2 * (qx * qy + qw * qz)
    r[..., 1, 1] = 1 - 2 * (qx**2 + qz**2)
    r[..., 1, 2] = 2 * (qy * qz - qw * qx)
    r[..., 2, 0] = 2 * (qx * qz - qw * qy)
    r[..., 2, 1] = 2 * (qy * qz + qw * qx)
    r[..., 2, 2] = 1 - 2 * (qx**2 + qy**2)
    return r


def _se3(qw, qx, qy, qz, tx, ty, tz) -> np.ndarray:
    pose = np.eye(4)
    pose[:3, :3] = quat_to_rotation(qw, qx, qy, qz)
    pose[:3, 3] = [tx, ty, tz]
    return pose


def _rows(path) -> List[dict]:
    """A feather's rows as dicts of Python scalars, as pandas'
    ``itertuples`` yields them."""
    columns = {k: v.tolist() for k, v in read_feather(path).items()}
    return [dict(zip(columns, values)) for values in zip(*columns.values())]


def load_poses(log_dir) -> Dict[int, np.ndarray]:
    """timestamp_ns -> city_SE3_egovehicle 4x4."""
    return {
        int(r["timestamp_ns"]): _se3(
            r["qw"], r["qx"], r["qy"], r["qz"], r["tx_m"], r["ty_m"], r["tz_m"]
        )
        for r in _rows(Path(log_dir) / "city_SE3_egovehicle.feather")
    }


def load_annotations(log_dir) -> Dict[int, Dict[str, dict]]:
    """timestamp_ns -> {track_uuid: cuboid dict (ego frame)}."""
    path = Path(log_dir) / "annotations.feather"
    if not path.exists():
        return {}
    out: Dict[int, Dict[str, dict]] = {}
    for r in _rows(path):
        out.setdefault(int(r["timestamp_ns"]), {})[str(r["track_uuid"])] = {
            "pose": _se3(r["qw"], r["qx"], r["qy"], r["qz"], r["tx_m"], r["ty_m"], r["tz_m"]),
            "dims": np.array([r["length_m"], r["width_m"], r["height_m"]]),
            "category": str(r["category"]),
            "yaw": float(
                np.arctan2(
                    2 * (r["qw"] * r["qz"] + r["qx"] * r["qy"]),
                    1 - 2 * (r["qy"]**2 + r["qz"]**2),
                )
            ),
        }
    return out


def read_sweep(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """lidar feather -> ((N,4) xyzi, (N,) laser id, (N,) intra-sweep seconds);
    a missing column reads as zeros."""
    columns = read_feather(path)
    rows = len(next(iter(columns.values()))) if columns else 0

    def col(name, dtype):
        if name in columns:
            return np.asarray(columns[name], dtype=dtype)
        return np.zeros(rows, dtype=dtype)

    pc = np.stack(
        [col("x", np.float32), col("y", np.float32), col("z", np.float32),
         col("intensity", np.float32)],
        axis=1,
    )
    laser = col("laser_number", np.uint8)
    offset = col("offset_ns", np.float64) * 1e-9
    return pc, laser, offset.astype(np.float32)


def track_boxes(annos: Dict[str, dict], tracks: List[str],
                expansion: float = BOX_EXPANSION) -> np.ndarray:
    """(B, 7) float32 boxes of ``tracks`` (bottom-centre z, grown by
    ``expansion``), the boxes :func:`compute_av2_flow` tests."""
    boxes = np.zeros((len(tracks), 7), np.float32)
    for k, uuid in enumerate(tracks):
        a = annos[uuid]
        center = a["pose"][:3, 3]
        boxes[k] = [
            center[0],
            center[1],
            center[2] - a["dims"][2] / 2,
            a["dims"][0] + expansion,
            a["dims"][1] + expansion,
            a["dims"][2] + expansion,
            a["yaw"],
        ]
    return boxes


def compute_av2_flow(
    pc0: np.ndarray,
    pose0: np.ndarray,
    pose1: np.ndarray,
    annos0: Dict[str, dict],
    annos1: Dict[str, dict],
    track_index: Dict[str, int],
    expansion: float = BOX_EXPANSION,
    device=None,
) -> Dict[str, np.ndarray]:
    """GT flow for one frame pair via per-track rigid transforms; the box
    test runs on ``device`` (default: the GPU; raises without CUDA)."""
    n = len(pc0)
    ego1_T_ego0 = relative_pose(pose0, pose1)
    flow = (transform_points(pc0[:, :3], ego1_T_ego0) - pc0[:, :3]).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    classes = np.zeros(n, dtype=np.uint8)
    instance = np.zeros(n, dtype=np.uint32)

    tracks = list(annos0)
    if tracks:
        boxes = track_boxes(annos0, tracks, expansion)
        box_idx = points_in_boxes_host(pc0[:, :3].astype(np.float32), boxes,
                                       resolve_device(device))
        hit = box_idx >= 0
        for k, uuid in enumerate(tracks):
            mask = hit & (box_idx == k)
            if not mask.any():
                continue
            a0 = annos0[uuid]
            classes[mask] = CATEGORY_TO_INDEX.get(
                NAME_MAPPING.get(a0["category"], "NONE"), 0
            )
            instance[mask] = track_index[uuid]
            if uuid in annos1:
                # city_T = city_SE3_ego @ ego_SE3_box; point moves with the box.
                city_t0 = pose0 @ a0["pose"]
                city_t1 = pose1 @ annos1[uuid]["pose"]
                move = (
                    np.linalg.inv(pose1) @ city_t1 @ np.linalg.inv(city_t0) @ pose0
                )
                flow[mask] = (
                    transform_points(pc0[mask][:, :3], move) - pc0[mask][:, :3]
                ).astype(np.float32)
            else:
                valid[mask] = False  # track vanished: flow unknowable

    return {
        "flow": flow,
        "valid": valid,
        "classes": classes,
        "instance": instance,
        "ego_motion": ego1_T_ego0.astype(np.float32),
    }


def sweep_paths(log_dir) -> List[Path]:
    """A log's lidar sweeps in timestamp order."""
    return sorted(
        (Path(log_dir) / "sensors" / "lidar").glob("*.feather"),
        key=lambda p: int(p.stem),
    )


def process_log(
    log_dir,
    output_dir,
    scene_id: Optional[str] = None,
    with_ground: bool = True,
    device=None,
) -> Optional[str]:
    """Convert one AV2 log into ``{output_dir}/{scene_id}.h5``; the box test
    and the ground mask run on ``device`` (default: the GPU; raises
    without CUDA). Frames already in the file are kept as they are; a file
    with every frame is skipped."""
    device = resolve_device(device)
    log_dir = Path(log_dir)
    scene_id = scene_id or log_dir.name
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    sweeps = sweep_paths(log_dir)
    if not sweeps:
        print(f"{scene_id}: no lidar sweeps, skip.")
        return None
    poses = load_poses(log_dir)
    annotations = load_annotations(log_dir)
    track_index: Dict[str, int] = {}
    for annos in annotations.values():
        for uuid in annos:
            track_index.setdefault(uuid, len(track_index) + 1)

    h5_path = output_dir / f"{scene_id}.h5"
    with AppendScene(h5_path) as f:
        if len(f.keys()) == len(sweeps):
            print(f"{scene_id} already exists with all frames, skip.")
            return None
        for i, sweep in enumerate(sweeps):
            ts = int(sweep.stem)
            if str(ts) in f:
                continue
            pc, laser, dt = read_sweep(sweep)
            pose0 = poses[ts]
            gm = (
                ground_mask_host(pc[:, :3], device)
                if with_ground
                else np.zeros(len(pc), bool)
            )
            flow_fields = {}
            if i + 1 < len(sweeps):
                ts1 = int(sweeps[i + 1].stem)
                gt = compute_av2_flow(
                    pc,
                    pose0,
                    poses[ts1],
                    annotations.get(ts, {}),
                    annotations.get(ts1, {}),
                    track_index,
                    device=device,
                )
                flow_fields = dict(
                    flow=gt["flow"],
                    flow_is_valid=gt["valid"],
                    flow_category_indices=gt["classes"],
                    flow_instance_id=gt["instance"],
                    ego_motion=gt["ego_motion"],
                )
            write_frame(
                f,
                FrameData(
                    lidar=pc,
                    lidar_id=laser,
                    lidar_dt=dt,
                    pose=pose0,
                    timestamp=ts,
                    ground_mask=gm,
                    **flow_fields,
                ),
            )
    return str(h5_path)
