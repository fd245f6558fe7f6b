"""The port's raw-log ingestion (``himo_tpu_torch/ops/points_in_boxes.py``,
``ops/ground.py``, ``io/yaml_lite.py``, ``data/av2.py``, ``data/scania.py``,
``cli/extract_av2.py``, ``cli/extract_scania.py``) against the JAX package
on the CPU, with ``device="cpu"``.

Both packages read the same raw files, written by the JAX tests' own
writers (``tests/test_av2_extract.py::_write_av2_log``,
``tests/test_extract.py::_write_raw_scene``). ``ground_mask`` is bitwise;
``points_in_boxes`` is exact on every point farther than ``FACE_TOL`` from
every face of the boxes it is tested against (``cos``/``sin`` may differ by
an ulp), and the fixtures have no point that near. Every scene file the
port writes is h5py-readable and equal, group for group and dataset for
dataset (dtype, shape, bytes), to the JAX package's, and so is
``index_total.pkl``: through resume, skip, stop, a missing sequence JSON
and an extrinsics YAML."""

import inspect
import pickle
import shutil
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from himo_tpu.cli import extract_av2 as jax_extract_av2
from himo_tpu.cli import extract_scania as jax_extract_scania
from himo_tpu.data import av2 as jax_av2
from himo_tpu.data import scania as jax_scania
from himo_tpu.ops.ground import ground_mask as jax_ground_mask
from himo_tpu.ops.points_in_boxes import points_in_boxes as jax_points_in_boxes
from himo_tpu_torch.cli import extract_av2, extract_scania
from himo_tpu_torch.data import av2, scania
from himo_tpu_torch.io import yaml_lite
from himo_tpu_torch.ops.ground import ground_mask
from himo_tpu_torch.ops.points_in_boxes import face_margin, points_in_boxes
from tests.test_av2_extract import _write_av2_log
from tests.test_extract import _write_raw_scene

FACE_TOL = 1e-4  # m: box ids are compared exactly beyond this distance from a face
SKIP_LINE = "already exists with all frames, skip."


def _tree(root: Path) -> dict:
    """Every file of an output directory: a scene as {group: {dataset:
    (dtype, shape, bytes)}} read by h5py, a pickle as its object."""
    out = {}
    for path in sorted(root.iterdir()):
        if path.suffix == ".h5":
            with h5py.File(path, "r") as f:
                out[path.name] = {
                    key: {name: (f[key][name].dtype.str, f[key][name].shape,
                                 np.asarray(f[key][name][()]).tobytes())
                          for name in f[key]}
                    for key in f}
        elif path.suffix == ".pkl":
            out[path.name] = pickle.loads(path.read_bytes())
        else:
            out[path.name] = path.read_bytes()
    return out


def _bytes(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


# ------------------------------------------------------------------ ops


def _boxes(rng, b, heading=True):
    boxes = np.concatenate([rng.uniform(-20, 20, (b, 2)), rng.uniform(-1.5, 0.5, (b, 1)),
                            rng.uniform(0.5, 6, (b, 3)),
                            rng.uniform(-np.pi, np.pi, (b, 1)) * heading], 1)
    return boxes.astype(np.float32)


def _box_case(case):
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.uniform(-25, 25, (3000, 2)), rng.uniform(-2, 4, (3000, 1))], 1)
    pts = pts.astype(np.float32)
    valid = None
    if case == "random":
        boxes = _boxes(rng, 24)
    elif case == "overlapping":  # nested and crossing boxes: the first wins
        boxes = _boxes(rng, 6)
        boxes = np.concatenate([boxes, boxes * [1, 1, 1, 1.5, 1.5, 1.2, 1],
                                boxes + [0.7, -0.4, 0, 0, 0, 0, 0.3]]).astype(np.float32)
    elif case == "valid":
        boxes = _boxes(rng, 24)
        valid = rng.random(24) < 0.5
    elif case == "empty":
        boxes = np.zeros((0, 7), np.float32)
    else:  # points exactly on faces: axis-aligned boxes, where cos and sin are exact
        boxes = _boxes(rng, 8, heading=False)
        c = boxes[rng.integers(0, 8, 3000)]
        sign = rng.choice([-1.0, 1.0], (3000, 2))
        pts = np.stack([c[:, 0] + sign[:, 0] * c[:, 3] * 0.5,
                        c[:, 1] + rng.uniform(-0.5, 0.5, 3000) * c[:, 4],
                        c[:, 2] + (sign[:, 1] > 0) * c[:, 5]], 1).astype(np.float32)
    return pts, boxes, valid


@pytest.mark.parametrize("case", ["random", "overlapping", "valid", "empty", "faces"])
def test_points_in_boxes_matches_jax(case):
    pts, boxes, valid = _box_case(case)
    if len(boxes):
        want = np.asarray(jax_points_in_boxes(pts, boxes, valid))
    else:  # JAX's argmax refuses an empty axis; its callers never pass no box
        with pytest.raises(ValueError, match="empty"):
            jax_points_in_boxes(pts, boxes, valid)
        want = np.full(len(pts), -1, np.int32)
    got = points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes),
                          None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    got = got.numpy()
    far = face_margin(pts, boxes, valid) > FACE_TOL
    if case == "faces":
        # Axis-aligned faces: both packages compute the same float32 values,
        # so even the points on a face agree; each is on one.
        assert not far.any()
        np.testing.assert_array_equal(got, want)
    else:
        print(f"{case}: {int((~far).sum())} points within {FACE_TOL} m of a face")
        assert (~far).sum() == 0
        np.testing.assert_array_equal(got[far], want[far])
    assert (got >= 0).any() == (len(boxes) > 0)
    if case == "overlapping":
        assert len(np.unique(got)) > 6  # later boxes win where earlier ones do not reach


def test_points_in_boxes_chunks_change_nothing(monkeypatch):
    from himo_tpu_torch.ops import points_in_boxes as pib

    pts, boxes, _ = _box_case("overlapping")
    whole = points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes))
    monkeypatch.setattr(pib, "_CHUNK_ELEMENTS", 7 * len(boxes) + 3)
    np.testing.assert_array_equal(
        points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes)).numpy(), whole.numpy())


def _ground_case(case):
    """The three clouds of ``tests/test_ground.py``, a ``valid`` mask, and
    NaN / inf / huge coordinates."""
    rng = np.random.default_rng(0)
    gx, gy = rng.uniform(-40, 40, 2000), rng.uniform(-40, 40, 2000)
    ground = np.stack([gx, gy, rng.normal(0.0, 0.04, 2000)], 1).astype(np.float32)
    obj = np.stack([rng.uniform(5, 9, 300), rng.uniform(-1, 1, 300),
                    rng.uniform(0.4, 2.0, 300)], 1).astype(np.float32)
    valid = None
    if case == "separates":
        pts = np.concatenate([ground, obj])
    elif case == "occluded":
        roof = np.stack([rng.uniform(20.0, 21.5, 50), rng.uniform(20.0, 21.5, 50),
                         np.full(50, 1.8)], 1).astype(np.float32)
        pts = np.concatenate([ground, roof])
    elif case == "out_of_grid":
        pts = np.array([[500.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    elif case == "valid":
        pts = np.concatenate([ground, obj])
        valid = rng.random(len(pts)) < 0.7
    else:
        pts = np.concatenate([ground, obj])
        pts[:6, 0] = [np.nan, np.inf, -np.inf, 3e38, -3e38, 51.2]
        pts[6:9, 1] = [np.nan, -51.2, 1e20]
    return pts, valid


@pytest.mark.parametrize("case", ["separates", "occluded", "out_of_grid", "valid", "extremes"])
def test_ground_mask_is_bitwise(case):
    pts, valid = _ground_case(case)
    want = np.asarray(jax_ground_mask(pts, valid))
    got = ground_mask(torch.from_numpy(pts),
                      None if valid is None else torch.from_numpy(valid)).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    if case == "separates":
        assert got[:2000].mean() > 0.9 and got[2000:].mean() < 0.1


# ------------------------------------------------------------------ feathers


def _to_av2_dtypes(lidar_dir: Path, drop=()):
    """Rewrite a log's sweeps (pandas) in AV2's own lidar dtypes."""
    dtypes = dict(x=np.float16, y=np.float16, z=np.float16, intensity=np.uint8,
                  laser_number=np.uint8, offset_ns=np.uint32)
    for path in sorted(lidar_dir.glob("*.feather")):
        df = pd.read_feather(path)
        df["intensity"] = df["intensity"] * 255
        df = df.astype(dtypes).drop(columns=list(drop))
        df.to_feather(path)


@pytest.fixture(scope="module")
def raw_av2(tmp_path_factory):
    """Three logs: the JAX fixture's dtypes, AV2's own dtypes (float16 /
    uint8 / uint32), and one whose car track vanishes at the last sweep."""
    root = tmp_path_factory.mktemp("raw") / "av2_raw"
    root.mkdir()
    _write_av2_log(root, "log_abc")
    _write_av2_log(root, "log_f16", seed=1)
    _to_av2_dtypes(root / "log_f16" / "sensors" / "lidar")
    log, _ = _write_av2_log(root, "log_vanish", num_frames=2, seed=2)
    df = pd.read_feather(log / "annotations.feather")
    df[df.timestamp_ns != df["timestamp_ns"].max()].to_feather(log / "annotations.feather")
    return root


@pytest.mark.parametrize("log", ["log_abc", "log_f16", "missing_column"])
def test_feather_readers_match_jax(raw_av2, log, tmp_path):
    if log == "missing_column":
        log_dir = tmp_path / "log"
        shutil.copytree(raw_av2 / "log_f16", log_dir)
        _to_av2_dtypes(log_dir / "sensors" / "lidar", drop=("intensity", "offset_ns"))
    else:
        log_dir = raw_av2 / log
    for sweep in av2.sweep_paths(log_dir):
        for got, want in zip(av2.read_sweep(sweep), jax_av2.read_sweep(sweep)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
    poses, want_poses = av2.load_poses(log_dir), jax_av2.load_poses(log_dir)
    assert list(poses) == list(want_poses)
    for ts in poses:
        assert poses[ts].tobytes() == want_poses[ts].tobytes()
    annos, want_annos = av2.load_annotations(log_dir), jax_av2.load_annotations(log_dir)
    assert list(annos) == list(want_annos)
    for ts, tracks in annos.items():
        assert list(tracks) == list(want_annos[ts])
        for uuid, a in tracks.items():
            w = want_annos[ts][uuid]
            assert a["pose"].tobytes() == w["pose"].tobytes()
            assert a["dims"].tobytes() == w["dims"].tobytes()
            assert (a["category"], a["yaw"]) == (w["category"], w["yaw"])


def test_compute_av2_flow_matches_jax(raw_av2):
    log_dir = raw_av2 / "log_vanish"
    poses, annos = jax_av2.load_poses(log_dir), jax_av2.load_annotations(log_dir)
    index = {"car-1": 1}
    ts0, ts1 = sorted(poses)
    pc, _, _ = jax_av2.read_sweep(av2.sweep_paths(log_dir)[0])
    for a1 in (annos.get(ts1, {}), annos[ts0]):  # the track vanished, then present
        want = jax_av2.compute_av2_flow(pc, poses[ts0], poses[ts1], annos[ts0], a1, index)
        got = av2.compute_av2_flow(pc, poses[ts0], poses[ts1], annos[ts0], a1, index,
                                   device="cpu")
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert (got["instance"] > 0).sum() >= 100


def _raw_scania(root: Path, inf_box=True, yaml_text=None):
    """``_write_raw_scene``'s batch_7, batch_8 (whose sequence JSON is
    missing: the writer names it sequence_7) and batch_9 (a raw attribute
    of its third superframe missing); a second box with infinite speed in
    every frame, and the vehicle's extrinsics YAML."""
    metadata = []
    for scene in ("batch_8", "batch_9", "batch_7"):
        pkl = _write_raw_scene(root, scene_id=scene)
        metadata += pickle.loads(pkl.read_bytes())
    (root / "batch_9" / "sequence_7.json").rename(root / "batch_9" / "sequence_9.json")
    (root / "batch_9" / "superframe_00003" / "superframe_00003_W.bin").unlink()
    if inf_box:
        for m in metadata:
            a = m["annos"]
            a["location"] = np.concatenate([a["location"], [[-10.0, -10.0, 1.0]]])
            a["dimensions"] = np.concatenate([a["dimensions"], [[6.0, 6.0, 2.5]]])
            a["heading"] = np.append(a["heading"], 0.3)
            a["speed"] = np.append(a["speed"], np.inf)
            a["velocity"] = np.concatenate([a["velocity"], [[np.inf, 0.0]]])
            a["name"] = [*a["name"], "pedestrian"]
    with open(root / "pseudo_infos.pkl", "wb") as f:
        pickle.dump(metadata, f)
    ext = root / "assets" / "private" / "lidar_ext"
    ext.mkdir(parents=True)
    (ext / "testtruck-generated.yml").write_text(yaml_text or _extrinsics_yaml())
    return root / "pseudo_infos.pkl"


def _extrinsics_yaml(lidars=("L0", "L1"), seed=3):
    """A vehicle's generated extrinsics file: nested mappings, quoted and
    plain scalars, flow lists, comments."""
    rng = np.random.default_rng(seed)
    lines = ["# generated by the calibration pipeline -- do not edit", "---",
             "vehicle: 'testtruck'", "version: 3", "parameters:"]
    for i, name in enumerate(lidars):
        x, y, z = np.round(rng.uniform(-3, 3, 3), 4)
        lines += [f"  lidarArray_arrayEl{i}:",
                  f"    humanReadableReference: \"{name}\"   # mount {i}",
                  "    nominalPosition:", f"      x: {x}", f"      y: {y}", f"      z: {int(z)}",
                  f"    nominalOrientation: [0.0, {np.round(rng.uniform(), 6)}, .5, -1.5e+0]",
                  "    enabled: yes", "    serial: 0x1F2A", "    notes: ~",
                  "    channels:", "    - 32", "    - {id: 1, name: upper}"]
    lines += ["  imuArray_arrayEl0:", "    nominalPosition: {x: 0.0, y: 0.0, z: 0.5}", "..."]
    return "\n".join(lines) + "\n"


def test_compute_gt_flow_matches_jax(tmp_path):
    pkl = _raw_scania(tmp_path)
    meta = [m for m in pickle.loads(pkl.read_bytes()) if m["sample_idx"] == "batch_7"]
    prefix = str(tmp_path / "batch_7" / "superframe_00001" / "superframe_00001")
    pc, _, _ = jax_scania.read_superframe(prefix)
    for got, want in zip(scania.read_superframe(prefix), jax_scania.read_superframe(prefix)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    pose0, pose1 = np.eye(4), np.eye(4)
    pose1[0, 3] = 5.0
    want = jax_scania.compute_gt_flow(pc, pose0, pose1, meta[0]["annos"])
    got = scania.compute_gt_flow(pc, pose0, pose1, meta[0]["annos"], device="cpu")
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert (~got["valid"]).sum() > 0 and set(np.unique(got["instance"])) == {0, 1, 2}
    bad = dict(meta[0]["annos"], name=["car", "no-such-class"])
    with pytest.raises(KeyError):
        jax_scania.compute_gt_flow(pc, pose0, pose1, bad)
    with pytest.raises(KeyError):
        scania.compute_gt_flow(pc, pose0, pose1, bad, device="cpu")


# ------------------------------------------------------------------ end to end


def test_extract_av2_matches_jax(raw_av2, tmp_path, capsys):
    """Three logs (both dtype sets, a vanished track), resumed from a
    partial h5py-written scene, then skipped; the index rebuilt alone."""
    jax_out, out = tmp_path / "jax_av2", tmp_path / "av2_h5"
    # A partial scene as the reference leaves it: written before its last sweep came.
    last = av2.sweep_paths(raw_av2 / "log_abc")[-1]
    hidden = tmp_path / last.name
    shutil.move(last, hidden)
    jax_av2.process_log(raw_av2 / "log_abc", jax_out, "log_abc")
    shutil.move(hidden, last)
    out.mkdir()
    shutil.copy(jax_out / "log_abc.h5", out / "log_abc.h5")
    with h5py.File(out / "log_abc.h5", "r") as f:
        assert len(f) == 2 and "flow" not in f[sorted(f)[-1]]

    jax_extract_av2.main(origin_data=str(raw_av2), output_dir=str(jax_out), nproc=1)
    extract_av2.main(origin_data=str(raw_av2), output_dir=str(out), nproc=1, device="cpu")
    assert capsys.readouterr().out.count("Using 1 processes for 3 AV2 logs.") == 2
    tree = _tree(out)
    assert tree == _tree(jax_out)
    assert sorted(tree) == ["index_total.pkl", "log_abc.h5", "log_f16.h5", "log_vanish.h5"]
    assert len(tree["index_total.pkl"]) == 3 + 3 + 2
    frames = tree["log_vanish.h5"]
    first = frames[sorted(frames)[0]]
    inst = np.frombuffer(first["flow_instance_id"][2], np.uint32)
    valid = np.frombuffer(first["flow_is_valid"][2], np.bool_)
    assert (inst > 0).sum() >= 100 and not valid[inst > 0].any() and valid[inst == 0].all()

    before = _bytes(out)
    extract_av2.main(origin_data=str(raw_av2), output_dir=str(out), nproc=1, device="cpu")
    assert capsys.readouterr().out.count(SKIP_LINE) == 3
    assert _bytes(out) == before
    (out / "index_total.pkl").unlink()
    extract_av2.main(output_dir=str(out), create_index_only=True)
    assert _bytes(out) == before


def test_extract_scania_matches_jax(tmp_path, capsys):
    """Three scenes: batch_7 (an inf-velocity box, lidar centres from the
    extrinsics YAML), batch_8 (no sequence JSON: an empty file), batch_9
    (a raw attribute missing: stops after its first frame); then the
    missing file restored and both resumed (which fails in both), batch_9
    extracted anew, then every scene skipped."""
    raw = tmp_path / "raw"
    raw.mkdir()
    pkl = _raw_scania(raw)
    jax_out, out = tmp_path / "jax_scania", tmp_path / "scania_h5"
    args = dict(origin_data=str(raw), metadata_pkl=str(pkl), nproc=1)
    jax_extract_scania.main(output_dir=str(jax_out), **args)
    extract_scania.main(output_dir=str(out), device="cpu", **args)
    printed = capsys.readouterr().out
    assert printed.count("batch_8 has no meta file, skip.") == 2
    assert printed.count("batch_9 missing raw data at superframe_00003, stop.") == 2
    tree = _tree(out)
    assert tree == _tree(jax_out)
    assert sorted(tree) == ["batch_7.h5", "batch_8.h5", "batch_9.h5", "index_total.pkl"]
    assert tree["batch_8.h5"] == {} and list(tree["batch_9.h5"]) == ["00001"]
    assert sorted(tree["batch_7.h5"]) == ["00001", "00002", "00003"]
    centers = tree["batch_7.h5"]["00001"]["lidar_center"]
    assert centers[:2] == ("<f4", (3, 4, 4))
    want_xyz = scania.load_lidar_extrinsics(yaml.safe_load(_extrinsics_yaml()))
    got_centers = np.frombuffer(centers[2], np.float32).reshape(3, 4, 4)
    np.testing.assert_array_equal(got_centers[:2, :3, 3],
                                  np.float32([want_xyz["L0"], want_xyz["L1"]]))
    np.testing.assert_array_equal(got_centers[2], np.eye(4, dtype=np.float32))
    first = tree["batch_7.h5"]["00001"]
    valid = np.frombuffer(first["flow_is_valid"][2], np.bool_)
    inst = np.frombuffer(first["flow_instance_id"][2], np.uint32)
    assert (inst == 2).any() and not valid[inst == 2].any() and valid[inst != 2].all()

    (raw / "batch_9" / "superframe_00003" / "superframe_00003_W.bin").write_bytes(
        (raw / "batch_9" / "superframe_00002" / "superframe_00002_W.bin").read_bytes())
    # The reference's Scania resume does not skip the frames a scene holds:
    # it fails creating the first one again, and the port fails alike.
    with pytest.raises(ValueError, match="already exists"):
        jax_extract_scania.main(output_dir=str(jax_out), **args)
    with pytest.raises(ValueError, match="already exists"):
        extract_scania.main(output_dir=str(out), device="cpu", **args)
    assert _tree(out) == _tree(jax_out)
    for root in (jax_out, out):
        (root / "batch_9.h5").unlink()
    jax_extract_scania.main(output_dir=str(jax_out), **args)
    extract_scania.main(output_dir=str(out), device="cpu", **args)
    tree = _tree(out)
    assert tree == _tree(jax_out) and sorted(tree["batch_9.h5"]) == ["00001", "00002", "00003"]
    assert capsys.readouterr().out.count(f"batch_7 {SKIP_LINE}") == 4

    before = _bytes(out)
    extract_scania.main(output_dir=str(out), device="cpu", **args)
    printed = capsys.readouterr().out
    assert all(f"batch_{k} {SKIP_LINE}" in printed for k in (7, 9))
    assert _bytes(out) == before
    (out / "index_total.pkl").unlink()
    extract_scania.main(output_dir=str(out), create_index_only=True)
    assert _bytes(out) == before


def test_empty_scene_file_opens_in_h5py(tmp_path):
    from himo_tpu_torch.data.schema import AppendScene

    with AppendScene(tmp_path / "s.h5"):
        pass
    with h5py.File(tmp_path / "s.h5", "r") as f:
        assert len(f.keys()) == 0


def test_main_signatures_are_the_references_plus_device():
    for port, ref in ((extract_av2.main, jax_extract_av2.main),
                      (extract_scania.main, jax_extract_scania.main)):
        params = list(inspect.signature(port).parameters.values())
        assert params[:-1] == list(inspect.signature(ref).parameters.values())
        assert params[-1].name == "device" and params[-1].default is None


def test_entry_points_raise_without_cuda(raw_av2, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_av2.main(origin_data=str(raw_av2), output_dir=str(tmp_path / "o"), nproc=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        av2.process_log(raw_av2 / "log_abc", tmp_path / "o")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scania.process_scene(tmp_path, tmp_path / "o", "batch_1", [])
    assert not (tmp_path / "o").exists()


# ------------------------------------------------------------------ YAML

EDGE_SCALARS = (
    "a: yes\nb: No\nc: on\nd: OFF\ne: ~\nf: null\ng:\nh: 0x1F\ni: 012\nj: 0b101\n"
    "k: 1_000\nl: 1:30\nm: 1.5\nn: -2.0e+3\no: .5\np: 1.\nq: -.Inf\nr: .NaN\ns: 1e3\n"
    "t: 08\nu: -.5\nv: \"tab\\tq\\\"\\u00e9\\x41\"\nw: it's\nx: a, b\ny: http://x.y/z\n"
    "z: 1.5:30.5\n1: int key\nyes: bool key\n'q k': 'it''s'\nd0: -0\ne0: 1.0e5\n"
)
STRUCTURES = (
    "- a\n- 'b'\n- [1, 2,]\n- {}\n- []\n- key: v\n  k2: v2\n-\n  - nested\n",
    "a:\n  - x\n  - y\nb:\n- 1\n- {c: [d, [e, f]], g: h}\nc: [1,\n    2, 3]  # wraps\nd: 1\nd: 2\n",
    "",
    "# only a comment\n",
)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("text", [_extrinsics_yaml(("L0", "L1", "L2", "L3", "L4"), 5),
                                  EDGE_SCALARS, *STRUCTURES],
                         ids=["extrinsics", "scalars", "sequences", "nesting", "empty",
                              "comment"])
def test_yaml_lite_reads_what_safe_load_reads(text, tmp_path):
    want = yaml.safe_load(text)
    assert _same(yaml_lite.safe_load(text), want)
    path = tmp_path / "x.yml"
    path.write_text(text)
    assert _same(yaml_lite.load(path), want)
    if text.startswith("# generated"):
        assert scania.load_lidar_extrinsics(yaml_lite.load(path)) == \
            jax_scania.load_lidar_extrinsics(want)


@pytest.mark.parametrize("text,line,what", [
    ("a: 1\nb: &x 2\nc: *x\n", 2, "anchor"),
    ("a: 1\nb: *x\n", 2, "alias"),
    ("a: !!str 1\n", 1, "tag"),
    ("a: 1\nb: |\n  text\n", 2, "block scalar"),
    ("a: >\n  text\n", 1, "block scalar"),
    ("a: 1\n---\nb: 2\n", 2, "second document"),
    ("a: 1\nb: 'x\n  y'\n", 2, "multi-line"),
    ("a: 1\n  b: 2\n", 2, "multi-line"),
    ("? a\n: b\n", 1, "complex key"),
    ("a: 2001-12-14\n", 1, "timestamp"),
    ("<<: {a: 1}\n", 1, "'<<'"),
    ("a: b: c\n", 1, "mapping value"),
    ("a:\n    b: 1\n  c: 2\n", 3, "indentation"),
])
def test_yaml_lite_refuses_naming_the_line(text, line, what):
    with pytest.raises(yaml_lite.YAMLSubsetError, match=f"<string>:{line}: .*{what}"):
        yaml_lite.safe_load(text)
