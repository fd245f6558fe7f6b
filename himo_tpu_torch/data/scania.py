"""Scania raw-superframe ingestion and GT scene-flow autolabeling (port of
``himo_tpu/data/scania.py``, without h5py or PyYAML).

The reference's raw->.h5 preprocessing (dataprocess/extract_sca.py):

- raw format: per-superframe attribute files ``{X,Y,Z,W,sensor,deltaT}.bin``
  (float32 / float32 intensity / int8 sensor id / int32 deltaT ns);
- poses: planar "smoothPosition" (yaw + xy) from the sequence JSON;
- GT flow: rigid pose flow plus per-box object velocity; boxes grown along
  heading by ``speed * 0.1 * 2 + BOUNDING_BOX_EXPANSION``, +0.4 m width,
  +expansion height; the point-in-box test runs on ``device``;
- infinite velocities (single-observation tracks) invalidate their points;
  instance ids shift +1 so background = 0; a box name outside
  ``NAME_MAPPING`` raises ``KeyError`` once a point falls in its box;
- the vehicle's extrinsics YAML is read by :mod:`himo_tpu_torch.io.yaml_lite`.

Every numpy step is the reference's, so the written datasets are bitwise
its own; the box test and the ground mask run on ``device``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from himo_tpu_torch.core.categories import (
    BOUNDING_BOX_EXPANSION,
    CATEGORY_TO_INDEX,
    NAME_MAPPING,
)
from himo_tpu_torch.core.transforms import pose_from_yaw_xy, relative_pose
from himo_tpu_torch.data.schema import AppendScene, FrameData, write_frame
from himo_tpu_torch.io import yaml_lite
from himo_tpu_torch.models.feedforward import resolve_device
from himo_tpu_torch.ops.ground import ground_mask_host
from himo_tpu_torch.ops.points_in_boxes import points_in_boxes_host

RAW_ATTRIBUTES = ("X", "Y", "Z", "W", "sensor", "deltaT")
SWEEP_DT = 0.1


def missing_attribute(prefix: str) -> Optional[str]:
    """First missing raw attribute file for a superframe, or None."""
    for attr in RAW_ATTRIBUTES:
        path = f"{prefix}_{attr}.bin"
        if not os.path.isfile(path):
            return path
    return None


def read_superframe(prefix: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw attribute files -> (points (N,4) xyzw, sensor_id (N,), dt (N,) s)."""
    dtypes = {"sensor": np.int8, "deltaT": np.int32}
    raw = {attr: np.fromfile(f"{prefix}_{attr}.bin", dtype=dtypes.get(attr, np.float32))
           for attr in RAW_ATTRIBUTES}
    points = np.stack([raw[a] for a in ("X", "Y", "Z", "W")], axis=1)
    dt = raw["deltaT"].astype(np.float64) * 1e-9  # ns -> s
    return points, raw["sensor"], dt.astype(np.float32)


def pose_from_superframe_meta(sequence_meta: Dict, frame_idx: int):
    """(pose 4x4, timestamp ns) from the sequence JSON smoothPosition."""
    sf = sequence_meta["superframes"][frame_idx]
    timestamp = int(sf["timestamp_epoch_ns"])
    sp = sf["smoothPosition"]
    pose = pose_from_yaw_xy(
        float(sp["smothYaw_rad"]), float(sp["smoothX_m"]), float(sp["smoothY_m"])
    )
    return pose, timestamp


def load_lidar_extrinsics(extrinsic_yaml: Dict) -> Dict[str, List[float]]:
    """{human-readable lidar name: [x, y, z]} from a vehicle extrinsics YAML."""
    out: Dict[str, List[float]] = {}
    for i in range(10):  # up to 10 LiDARs per vehicle
        key = f"lidarArray_arrayEl{i}"
        if key not in extrinsic_yaml.get("parameters", {}):
            continue
        entry = extrinsic_yaml["parameters"][key]
        pos = entry["nominalPosition"]
        out[entry["humanReadableReference"]] = [pos["x"], pos["y"], pos["z"]]
    return out


def grow_boxes(annos: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Annotation dict -> (boxes (B,7) bottom-center convention, speed (B,)).

    Boxes arrive center-positioned; z drops by h/2 to the bottom face, then
    the sweep-travel growth is applied (extract_sca.py:105-114).
    """
    loc = np.asarray(annos["location"], dtype=np.float64).reshape(-1, 3)
    dims = np.asarray(annos["dimensions"], dtype=np.float64).reshape(-1, 3)  # l, w, h
    heading = np.asarray(annos["heading"], dtype=np.float64).reshape(-1)
    speed = np.asarray(annos["speed"], dtype=np.float64).reshape(-1)

    boxes = np.concatenate([loc, dims, heading[:, None]], axis=1)
    boxes[:, 2] -= boxes[:, 5] / 2  # center -> bottom
    finite = np.isfinite(speed)
    boxes[finite, 3] += speed[finite] * SWEEP_DT * 2 + BOUNDING_BOX_EXPANSION
    boxes[:, 4] += 0.4
    boxes[:, 5] += BOUNDING_BOX_EXPANSION
    return boxes, speed


def compute_gt_flow(
    pc0: np.ndarray,
    pose0: np.ndarray,
    pose1: np.ndarray,
    annos: Dict,
    device=None,
) -> Dict[str, np.ndarray]:
    """Autolabel one frame: flow, validity, classes, instances, ego motion;
    the box test runs on ``device`` (default: the GPU; raises without CUDA)."""
    ego1_T_ego0 = relative_pose(pose0, pose1)
    xyz = pc0[:, :3].astype(np.float64)
    flow = (xyz @ ego1_T_ego0[:3, :3].T + ego1_T_ego0[:3, 3] - xyz).astype(np.float32)

    n = len(pc0)
    valid = np.ones(n, dtype=bool)
    classes = np.zeros(n, dtype=np.uint8)
    instance = np.zeros(n, dtype=np.int32)

    num_boxes = len(np.atleast_1d(annos.get("heading", [])))
    if num_boxes:
        boxes, _speed = grow_boxes(annos)
        vel2d = np.asarray(annos["velocity"], dtype=np.float64).reshape(-1, 2)
        box_idx = points_in_boxes_host(pc0[:, :3].astype(np.float32),
                                       boxes.astype(np.float32), resolve_device(device))
        hit = box_idx >= 0
        vel3d = np.concatenate([vel2d, np.zeros((num_boxes, 1))], axis=1)
        vel_per_pt = vel3d[box_idx[hit]]
        bad = ~np.isfinite(vel_per_pt).all(axis=1)
        valid[np.where(hit)[0][bad]] = False
        vel_per_pt[bad] = 0.0
        flow[hit] += (vel_per_pt * SWEEP_DT).astype(np.float32)

        # Each box's class index, looked up (and a KeyError raised) only for
        # the boxes that hold a point, as the reference's per-point lookup;
        # slot -1 is the background sentinel.
        names = list(annos["name"]) + ["none"]
        lut = np.zeros(len(names), dtype=np.uint8)
        for k in np.unique(box_idx):
            lut[k] = CATEGORY_TO_INDEX[NAME_MAPPING[str(names[k])]]
        classes = lut[box_idx]
        instance = box_idx.astype(np.int32)

    return {
        "flow": flow,
        "valid": valid,
        "classes": classes,
        "instance": (instance + 1).astype(np.uint32),  # background -1 -> 0
        "ego_motion": ego1_T_ego0.astype(np.float32),
    }


def list_superframes(scene_dir) -> List[str]:
    """Sorted superframe folder names of a raw scene directory."""
    return sorted(
        f for f in os.listdir(scene_dir) if f.startswith("superframe_")
    )


def _lidar_centers(sequence_meta: Dict, extrinsics: Dict, sensor_id: np.ndarray) -> np.ndarray:
    """(L, 4, 4) float32 extrinsics of the sensors present, in id order."""
    centers = []
    for sid in np.unique(sensor_id):
        name = sequence_meta.get("lidars", {}).get(f"lidar{sid - 1}", {}).get("name")
        xyz = extrinsics.get(name, [0.0, 0.0, 0.0])
        center = np.eye(4, dtype=np.float32)
        center[:3, 3] = xyz
        centers.append(center)
    return np.stack(centers) if centers else np.eye(4, dtype=np.float32)[None]


def process_scene(
    origin_data,
    output_dir,
    scene_id: str,
    scene_meta: List[Dict],
    device=None,
) -> Optional[str]:
    """Extract one raw scene into ``{output_dir}/{scene_id}.h5``; the box
    test and the ground mask run on ``device`` (default: the GPU; raises
    without CUDA).

    Returns the h5 path, or None if skipped (complete or missing data).
    Idempotent: a scene whose group count already matches is skipped. As
    the reference's h5py ``"a"`` mode, the file is created before any check
    (a scene without its sequence JSON leaves an empty one), and a scene
    that stops at a missing raw attribute keeps the frames written before.
    """
    device = resolve_device(device)
    origin_data = Path(origin_data)
    output_dir = Path(output_dir)
    scene_dir = origin_data / scene_id
    frames = list_superframes(scene_dir)
    h5_path = output_dir / f"{scene_id}.h5"

    with AppendScene(h5_path) as f:
        if len(f.keys()) == len(frames):
            print(f"{scene_id} already exists with all frames, skip.")
            return None

        seq_json = scene_dir / f"sequence_{int(scene_id.split('_')[1])}.json"
        if not seq_json.exists():
            print(f"{scene_id} has no meta file, skip.")
            return None
        sequence_meta = json.loads(seq_json.read_text())

        extrinsics = {}
        ext_file = sequence_meta.get("extrinsics_file")
        if not ext_file:
            # Per-vehicle convention of the reference (extract_sca.py:167):
            # assets/private/lidar_ext/{vehicle}-generated.yml next to the data.
            vehicle = sequence_meta.get("vehicle", "").lower()
            candidate = (
                origin_data / "assets" / "private" / "lidar_ext"
                / f"{vehicle}-generated.yml"
            )
            ext_file = str(candidate) if candidate.exists() else None
        if ext_file and os.path.exists(ext_file):
            extrinsics = load_lidar_extrinsics(yaml_lite.load(ext_file))

        for i, frame_name in enumerate(frames):
            prefix = str(scene_dir / frame_name / frame_name)
            if missing_attribute(prefix) is not None:
                print(f"{scene_id} missing raw data at {frame_name}, stop.")
                break
            # superframe_* names are 1-based; JSON index is 0-based.
            frame_idx = int(frame_name.split("_")[-1]) - 1
            pc, sensor_id, lidar_dt = read_superframe(prefix)
            pose, timestamp = pose_from_superframe_meta(sequence_meta, frame_idx)
            lidar_center = _lidar_centers(sequence_meta, extrinsics, sensor_id)
            gm = ground_mask_host(pc[:, :3].astype(np.float32), device)

            has_next = i + 1 < len(frames) and i < len(scene_meta)
            flow_fields = {}
            if has_next:
                next_name = frames[i + 1]
                next_prefix = str(scene_dir / next_name / next_name)
                if missing_attribute(next_prefix) is not None:
                    print(f"{scene_id} missing raw data at {next_name}, stop.")
                    break
                pose1, _ = pose_from_superframe_meta(
                    sequence_meta, int(next_name.split("_")[-1]) - 1
                )
                gt = compute_gt_flow(pc, pose, pose1, scene_meta[i]["annos"], device=device)
                flow_fields = dict(
                    flow=gt["flow"],
                    flow_is_valid=gt["valid"],
                    flow_category_indices=gt["classes"],
                    flow_instance_id=gt["instance"],
                    ego_motion=gt["ego_motion"],
                )

            frame = FrameData(
                lidar=pc.astype(np.float32),
                lidar_id=sensor_id.astype(np.uint8),
                lidar_dt=lidar_dt.astype(np.float32),
                pose=pose,
                timestamp=timestamp,
                lidar_center=lidar_center,
                ground_mask=gm,
                group_key=frame_name.split("_")[-1],
                **flow_fields,
            )
            write_frame(f, frame)
    return str(h5_path)
