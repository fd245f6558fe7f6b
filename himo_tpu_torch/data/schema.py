"""The .h5 scene format — the contract every layer shares (port of
``himo_tpu/data/schema.py`` on :mod:`himo_tpu_torch.data.h5`, no h5py).

One HDF5 file per scene; one group per frame, keyed by the frame timestamp
string. Datasets per group (reference schema: dataprocess/extract_sca.py:76-93,
tools/test/repack_h5_scania.py:23-36; see SURVEY.md §2.5):

| key                     | dtype    | shape   | meaning                          |
|-------------------------|----------|---------|----------------------------------|
| lidar                   | float32  | (N, 4)  | x, y, z, intensity               |
| lidar_id                | uint8    | (N,)    | sensor id (multi-LiDAR rigs)     |
| lidar_dt                | float32  | (N,)    | intra-sweep seconds from start   |
| lidar_center            | float32  | (L,4,4) | per-LiDAR extrinsic (4x4)        |
| pose                    | float64  | (4, 4)  | ego pose (world <- ego)          |
| timestamp               | int64    | ()      | frame timestamp                  |
| flow                    | float32  | (N, 3)  | GT flow incl. ego motion         |
| flow_is_valid           | bool     | (N,)    | GT flow validity                 |
| flow_category_indices   | uint8    | (N,)    | AV2 category index per point     |
| flow_instance_id        | uint32   | (N,)    | instance id (0 = background)     |
| ego_motion              | float32  | (4, 4)  | inv(pose1) @ pose0               |
| ground_mask             | bool     | (N,)    | ground classification            |
| anno_bbx                | float32  | opt.    | annotation boxes                 |
| {method}                | float32  | (N, 3)  | estimated flow per method        |
| seg_valid / seg_{m}     | int      | (N,)    | segmentation labels (downstream) |

Sidecar indices live next to the .h5 files: ``index_total.pkl`` — list of
``[scene_id, timestamp]`` — and optional subset ``index_eval.pkl``
(tools/pkl_extract.py:9-19).

A scene is written whole: open one writer (``h5.File(path, "w")``) and
call :func:`write_frame` for each frame. The writer does not append (the
reference adds datasets with h5py's ``"a"`` mode): :func:`rewrite_scene`
rewrites a scene file with datasets added, replaced or removed, and
:func:`write_method_flow` / :func:`write_method_flows` add a method's flow
through it, once per frame or once per scene. :class:`AppendScene` stands
in for the ``"a"`` mode that the ingestion writers open a scene with:
frames added to the groups already there.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

from himo_tpu_torch.data import h5

# Canonical dtypes for schema-defined keys (repack_h5_scania.py:23-36 is the
# reference dtype map; uint32 instance ids are kept — consumers cast as needed).
SCHEMA_DTYPES: Dict[str, np.dtype] = {
    "lidar": np.float32,
    "lidar_id": np.uint8,
    "lidar_dt": np.float32,
    "lidar_center": np.float32,
    "pose": np.float64,
    "flow": np.float32,
    "flow_is_valid": np.bool_,
    "flow_category_indices": np.uint8,
    "flow_instance_id": np.uint32,
    "ego_motion": np.float32,
    "ground_mask": np.bool_,
    "anno_bbx": np.float32,
}


@dataclasses.dataclass
class FrameData:
    """In-memory frame record matching one .h5 group."""

    lidar: np.ndarray  # (N, 4)
    lidar_id: np.ndarray  # (N,)
    lidar_dt: np.ndarray  # (N,)
    pose: np.ndarray  # (4, 4)
    timestamp: int
    lidar_center: Optional[np.ndarray] = None  # (L, 4, 4)
    flow: Optional[np.ndarray] = None  # (N, 3)
    flow_is_valid: Optional[np.ndarray] = None  # (N,)
    flow_category_indices: Optional[np.ndarray] = None  # (N,)
    flow_instance_id: Optional[np.ndarray] = None  # (N,)
    ego_motion: Optional[np.ndarray] = None  # (4, 4)
    ground_mask: Optional[np.ndarray] = None  # (N,)
    anno_bbx: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # h5 group key; defaults to str(timestamp). Scania scenes key groups by
    # superframe number while `timestamp` holds the epoch-ns capture time.
    group_key: Optional[str] = None

    @property
    def num_points(self) -> int:
        return len(self.lidar)


def write_frame(f: h5.FileWriter, frame: FrameData) -> None:
    """Write one frame as a group keyed by its timestamp string."""
    group = f.create_group(frame.group_key or str(frame.timestamp))
    group.create_dataset("lidar", data=frame.lidar.astype(np.float32))
    group.create_dataset("lidar_id", data=frame.lidar_id.astype(np.uint8))
    group.create_dataset("lidar_dt", data=frame.lidar_dt.astype(np.float32))
    group.create_dataset("pose", data=frame.pose.astype(np.float64))
    group.create_dataset("timestamp", data=frame.timestamp)
    if frame.lidar_center is not None:
        group.create_dataset("lidar_center", data=frame.lidar_center.astype(np.float32))
    if frame.flow is not None:
        group.create_dataset("flow", data=frame.flow.astype(np.float32))
        group.create_dataset("flow_is_valid", data=frame.flow_is_valid.astype(bool))
        group.create_dataset(
            "flow_category_indices", data=frame.flow_category_indices.astype(np.uint8)
        )
    if frame.flow_instance_id is not None:
        group.create_dataset(
            "flow_instance_id", data=frame.flow_instance_id.astype(np.uint32)
        )
    if frame.ego_motion is not None:
        group.create_dataset("ego_motion", data=frame.ego_motion.astype(np.float32))
    if frame.ground_mask is not None:
        group.create_dataset("ground_mask", data=frame.ground_mask.astype(bool))
    if frame.anno_bbx is not None:
        group.create_dataset("anno_bbx", data=frame.anno_bbx.astype(np.float32))
    for key, value in frame.extras.items():
        group.create_dataset(key, data=value)


def read_frame(f: h5.FileReader, timestamp, extra_keys=()) -> FrameData:
    """Read one frame group back into a FrameData record."""
    group = f[str(timestamp)]

    def get(key):
        return group[key][()] if key in group else None

    extras = {k: group[k][()] for k in extra_keys if k in group}
    return FrameData(
        lidar=group["lidar"][()],
        lidar_id=group["lidar_id"][()],
        lidar_dt=group["lidar_dt"][()],
        pose=group["pose"][()],
        timestamp=int(np.asarray(group["timestamp"][()]).item()),
        lidar_center=get("lidar_center"),
        flow=get("flow"),
        flow_is_valid=get("flow_is_valid"),
        flow_category_indices=get("flow_category_indices"),
        flow_instance_id=get("flow_instance_id"),
        ego_motion=get("ego_motion"),
        ground_mask=get("ground_mask"),
        anno_bbx=get("anno_bbx"),
        extras=extras,
    )


def _group_arrays(f: h5.FileReader, path: Path, key: str) -> Dict[str, np.ndarray]:
    """Every dataset of the frame group ``key`` of an open scene file."""
    out = {}
    for name in f[key].keys():
        member = f[key][name]
        if not isinstance(member, h5.Dataset):
            raise ValueError(f"{path}:{key}/{name}: nested groups are outside the scene format")
        out[name] = member[()]
    return out


def rewrite_scene(path, updates: Mapping[str, Mapping[str, Optional[np.ndarray]]]) -> None:
    """Rewrite one scene file whole with datasets added, replaced or
    removed: ``updates`` maps a frame group's key to ``{name: array}``, a
    ``None`` in place of an array removing the dataset. Every other dataset keeps its
    bytes, dtype and shape. The new file is written beside the old one
    (``<name>.tmp``), then moved over it, so a failed write leaves the old
    file as it was."""
    path = Path(path)
    with h5.File(path) as f:
        groups = {key: _group_arrays(f, path, key) for key in f.keys()}
    for key, arrays in updates.items():
        if key not in groups:
            raise KeyError(f"{path}: no frame group {key!r}")
        for name, arr in arrays.items():
            if arr is None:
                groups[key].pop(name, None)
            else:
                groups[key][name] = arr
    tmp = path.with_name(path.name + ".tmp")
    try:
        with h5.File(tmp, "w") as f:
            for key, arrays in groups.items():
                group = f.create_group(key)
                for name, arr in arrays.items():
                    group.create_dataset(name, data=arr)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


class AppendScene:
    """A scene file opened to add frame groups, as h5py's ``"a"`` mode opens
    it for the ingestion writers: ``keys()`` and ``in`` see the groups
    already there and those added, :func:`write_frame` adds one.

    The first group added starts ``<name>.tmp``, copies every existing
    group into it (each dataset's bytes, dtype and shape as they were),
    then takes the new groups; :meth:`close` moves it over the file, also
    when the ``with`` block raises, as h5py keeps what was written before
    an error. Nothing added: an existing file keeps its bytes, a missing
    one is created empty (h5py's ``"a"`` creates it on opening)."""

    def __init__(self, path):
        self.path = Path(path)
        self._old: list = []
        if self.path.exists():
            with h5.File(self.path) as f:
                self._old = f.keys()
        self._tmp = self.path.with_name(self.path.name + ".tmp")
        self._writer: Optional[h5.FileWriter] = None
        self._new: list = []

    def keys(self) -> list:
        return self._old + self._new

    def __contains__(self, key) -> bool:
        return str(key) in self.keys()

    def _open(self) -> h5.FileWriter:
        writer = h5.File(self._tmp, "w")
        try:
            if self._old:
                with h5.File(self.path) as f:
                    for key in self._old:
                        group = writer.create_group(key)
                        for name, arr in _group_arrays(f, self.path, key).items():
                            group.create_dataset(name, data=arr)
        except BaseException:
            writer.close()
            self._tmp.unlink(missing_ok=True)
            raise
        return writer

    def create_group(self, name: str) -> h5.WriteGroup:
        if self._writer is None:
            self._writer = self._open()
        group = self._writer.create_group(name)
        self._new.append(str(name))
        return group

    def close(self) -> None:
        if self._writer is None:
            if not self.path.exists():
                h5.File(self.path, "w").close()
            return
        writer, self._writer = self._writer, None
        try:
            writer.close()
            os.replace(self._tmp, self.path)
        finally:
            self._tmp.unlink(missing_ok=True)

    def __enter__(self) -> "AppendScene":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_method_flows(data_dir, scene_id: str, method: str,
                       flows: Mapping[object, np.ndarray]) -> None:
    """Add (or replace) a method's estimated flow in many frames of one
    scene with one rewrite of its file: ``flows`` maps a frame's timestamp
    (its group key) to its (N, 3) flow, stored as float32 under
    ``method``."""
    rewrite_scene(
        Path(data_dir) / f"{scene_id}.h5",
        {str(ts): {method: np.asarray(flow, dtype=np.float32)} for ts, flow in flows.items()},
    )


def write_method_flow(
    data_dir, scene_id: str, timestamp, method: str, flow: np.ndarray
) -> None:
    """Add (or replace) an estimated flow field under the method name.

    This is the write-back contract of the reference's ``save.py`` CLI
    (SURVEY.md §2.9): per-frame (N, 3) float32 flow stored in the frame
    group. Each call rewrites the scene file; writers of many frames of a
    scene call :func:`write_method_flows` once instead.
    """
    write_method_flows(data_dir, scene_id, method, {timestamp: flow})


def scene_ids(data_dir) -> list:
    """All scene ids (h5 file stems) in a data directory, sorted."""
    return sorted(p.stem for p in Path(data_dir).glob("*.h5"))
