"""The port's HDF5 subset (``himo_tpu_torch.data.h5``) against h5py.

Files come from the JAX package's scene writer (``make_dataset``), from
h5py directly and from the port's writer. Every comparison is exact: the
same dtype, the same shape, the same Python type (h5py returns a numpy
scalar for a scalar dataset) and the same bytes."""

import struct

import h5py
import numpy as np
import pytest

from himo_tpu.data import schema as JS
from himo_tpu.data.synthetic import BoxObject as JBox
from himo_tpu.data.synthetic import make_dataset as j_make_dataset
from himo_tpu.data.synthetic import make_scene as j_make_scene
from himo_tpu_torch.data import h5
from himo_tpu_torch.data import schema as PS


def _same(a, b, where):
    assert type(a) is type(b), (where, type(a), type(b))
    assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
    assert np.shape(a) == np.shape(b), (where, np.shape(a), np.shape(b))
    assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), where


def _assert_reads_like_h5py(path):
    """Every group and dataset of ``path`` through the port's reader equals
    h5py's; returns the number of datasets compared."""
    count = 0
    with h5py.File(path, "r") as ref, h5.File(path) as got:
        def walk(rg, pg):
            nonlocal count
            assert list(rg.keys()) == pg.keys(), rg.name
            for key in rg:
                if isinstance(rg[key], h5py.Group):
                    assert isinstance(pg[key], h5.Group)
                    walk(rg[key], pg[key])
                else:
                    ds = pg[key]
                    assert ds.shape == rg[key].shape and ds.dtype == rg[key].dtype
                    _same(rg[key][()], ds[()], f"{rg.name}/{key}")
                    assert f"{rg.name}/{key}".lstrip("/") in got
                    count += 1

        walk(ref, got)
    return count


def _root_btree_level(path):
    with h5.File(path) as f:
        return f._read(f._btree + 5, 1)[0]


def _add_ssl_extras(path, seed):
    """The trainer's extras, added to every frame in h5py's append mode."""
    rng = np.random.default_rng(seed)
    with h5py.File(path, "a") as f:
        for key in f:
            n = f[key]["lidar"].shape[0]
            f[key].create_dataset("ssl_dynamic", data=rng.random(n) < 0.3)
            f[key].create_dataset("ssl_cluster", data=rng.integers(-1, 9, n).astype(np.int32))
            f[key].create_dataset("ssl_prior", data=rng.normal(size=(n, 3)).astype(np.float32))
            f[key].create_dataset("ssl_prior_valid", data=rng.random(n) < 0.1)


def test_reads_jax_scenes_bitwise(tmp_path):
    root = tmp_path / "av2"
    j_make_dataset(root, num_scenes=2, num_frames=4, seed=3, num_background=700,
                   method_flows={"perfect": 0.0, "noisy": 0.05})
    _add_ssl_extras(root / "scene_001.h5", 0)
    total = sum(_assert_reads_like_h5py(root / f"scene_00{i}.h5") for i in range(2))
    assert total == 2 * 4 * 14 + 4 * 4
    with h5.File(root / "scene_000.h5") as f:
        g = f[f.keys()[0]]
        assert g["timestamp"][()] == 1_700_000_000_000_000_000
        assert g["flow_is_valid"].dtype == np.bool_ and g["pose"].dtype == np.float64
        assert g["flow_instance_id"].dtype == np.uint32 and g["lidar_id"].dtype == np.uint8
        assert isinstance(g["timestamp"][()], np.int64)


def test_reads_a_300_frame_scene_with_a_two_level_btree(tmp_path):
    tiny = [JBox(center=np.array([10.0, 2.0, 1.0]), velocity=np.array([20.0, 0.0, 0.0]),
                 size=np.array([4.5, 2.0, 1.6]), points_per_frame=3)]
    path = j_make_scene(tmp_path, num_frames=300, num_background=5, objects=tiny, seed=1)
    assert _root_btree_level(path) >= 1
    assert _assert_reads_like_h5py(path) == 300 * 12
    with h5py.File(path, "r") as ref, h5.File(path) as got:
        # Names in strcmp order, never taken for time order.
        assert got.keys() == sorted(ref.keys(), key=str.encode)


def test_reads_files_h5py_changed_in_append_mode(tmp_path):
    path = tmp_path / "scene.h5"
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        for i in range(20):
            g = f.create_group(str(1_700_000_000_000_000_000 + i * 100_000_000))
            g.create_dataset("lidar", data=rng.normal(size=(7, 4)).astype(np.float32))
            g.create_dataset("empty", data=np.zeros((0, 3), np.float32))
    with h5py.File(path, "a") as f:
        keys = list(f)
        f[keys[3]].create_dataset("ssl_dynamic", data=rng.random(7) < 0.5)
        del f[keys[4]]["lidar"]  # freed, then re-created elsewhere, wider
        f[keys[4]].create_dataset("lidar", data=np.arange(60, dtype=np.float64).reshape(15, 4))
        for j in range(60):  # splits the root's symbol nodes, grows the heap
            f.create_group(f"000{j:03d}").create_dataset("v", data=np.arange(j, dtype=np.int16))
        ds = f[keys[5]]["lidar"]
        for j in range(40):  # attributes overflow the header: continuation
            ds.attrs[f"attribute_{j:02d}"] = np.arange(j + 1)
        f.attrs["note"] = "root attribute"
    with h5py.File(path, "r") as f:
        assert len(f[keys[5]]["lidar"].attrs) == 40
    assert _assert_reads_like_h5py(path) == 20 * 2 + 1 + 60


@pytest.mark.parametrize("layout", ["dtypes", "many_groups", "nested_and_empty"])
def test_h5py_reads_port_written_files_bitwise(tmp_path, layout):
    rng = np.random.default_rng(4)
    path = tmp_path / "port.h5"
    want = {}
    with h5.File(path, "w") as f:
        if layout == "dtypes":
            g = f.create_group("1700000000000000000")
            arrays = {
                "lidar": rng.normal(size=(33, 4)).astype(np.float32),
                "pose": rng.normal(size=(4, 4)),
                "timestamp": 1_700_000_000_000_000_000,
                "flow_is_valid": rng.random(33) < 0.5,
                "flow_instance_id": rng.integers(0, 2**32, 33, dtype=np.uint32),
                "lidar_id": rng.integers(0, 255, 33).astype(np.uint8),
                "ssl_cluster": rng.integers(-5, 9, 33).astype(np.int32),
                "int64": rng.integers(-2**62, 2**62, 5),
                "int8": np.array([-128, 0, 127], np.int8),
                "uint16": np.array([0, 65535], np.uint16),
                "half": rng.normal(size=6).astype(np.float16),
                "big_endian": np.arange(5, dtype=">f4"),
                "scalar_float": np.float32(2.5),
                "scalar_bool": np.bool_(True),
            }
            for k, v in arrays.items():
                g.create_dataset(k, data=v)
            want = {f"1700000000000000000/{k}": np.asarray(v) for k, v in arrays.items()}
        elif layout == "many_groups":
            for i in range(300):
                name = f"{i:06d}" if i % 5 == 0 else str(1_700_000_000_000_000_000 + i * 99)
                g = f.create_group(name)
                v = rng.normal(size=(i % 4 + 1, 3)).astype(np.float32)
                g.create_dataset("lidar", data=v)
                want[f"{name}/lidar"] = v
        else:
            f.create_group("empty_group")
            outer = f.create_group("outer")
            inner = outer.create_group("inner")
            inner.create_dataset("zero_length", data=np.zeros((0, 3), np.float32))
            outer.create_dataset("x", data=np.arange(4.0))
            want = {"outer/inner/zero_length": np.zeros((0, 3), np.float32),
                    "outer/x": np.arange(4.0)}
    if layout == "many_groups":
        assert _root_btree_level(path) >= 1
    with h5py.File(path, "r") as f:
        for key, value in want.items():
            got = f[key][()]
            assert got.dtype == value.dtype and got.shape == value.shape, key
            assert np.asarray(got).tobytes() == value.tobytes(), key
        if layout == "nested_and_empty":
            assert len(f["empty_group"]) == 0
            assert sorted(f["outer"]) == ["inner", "x"]
        if layout == "dtypes":
            assert isinstance(f["1700000000000000000/timestamp"][()], np.int64)
    _assert_reads_like_h5py(path)


def test_port_written_file_survives_h5py_append(tmp_path):
    path = tmp_path / "port.h5"
    with h5.File(path, "w") as f:
        for i in range(40):
            f.create_group(str(1_700_000_000_000_000_000 + i)).create_dataset(
                "lidar", data=np.full((3, 4), i, np.float32))
    with h5py.File(path, "a") as f:
        keys = list(f)
        f[keys[2]].create_dataset("flow", data=np.ones((3, 3), np.float32))
        del f[keys[3]]["lidar"]
        for j in range(50):
            f.create_group(f"x{j:03d}").create_dataset("v", data=np.arange(j))
    assert _assert_reads_like_h5py(path) == 40 - 1 + 1 + 50


def test_outside_the_subset_raises(tmp_path):
    path = tmp_path / "other.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=np.arange(100.0), chunks=(10,), compression="gzip")
        f.create_dataset("text", data=np.array([b"abc", b"de"]))
        f.create_dataset("ok", data=np.arange(3))
    with h5.File(path) as f:
        assert f["ok"][()].tolist() == [0, 1, 2]
        with pytest.raises(NotImplementedError, match="chunked"):
            f["chunked"]
        with pytest.raises(NotImplementedError, match="datatype class 3"):
            f["text"]
        with pytest.raises(KeyError):
            f["missing"]
        assert "missing" not in f and "ok/deeper" not in f
    (tmp_path / "plain.txt").write_text("not a scene file")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5.File(tmp_path / "plain.txt")
    with h5.File(tmp_path / "w.h5", "w") as f:
        f.create_group("a")
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("a")
        with pytest.raises(ValueError, match="invalid"):
            f.create_dataset("b/c", data=np.zeros(1))
        with pytest.raises(NotImplementedError):
            f.create_dataset("s", data=np.array(["x"]))


def test_superblock_and_root_entry_layout(tmp_path):
    """The port writes h5py's defaults: superblock 0, leaf K 4, internal K 16,
    the end-of-file address equal to the file's size."""
    path = tmp_path / "p.h5"
    with h5.File(path, "w") as f:
        f.create_group("g").create_dataset("x", data=np.arange(3))
    raw = path.read_bytes()
    assert raw[:8] == h5.SIGNATURE and raw[8] == 0
    assert struct.unpack_from("<HH", raw, 16) == (4, 16)
    assert struct.unpack_from("<Q", raw, 40)[0] == len(raw)
    assert struct.unpack_from("<I", raw, 72)[0] == 1  # root entry caches its symbol table


def test_schema_frames_round_trip_against_jax(tmp_path):
    rng = np.random.default_rng(5)
    n = 50
    frame = dict(
        lidar=rng.normal(size=(n, 4)).astype(np.float32),
        lidar_id=rng.integers(1, 4, n).astype(np.uint8),
        lidar_dt=rng.uniform(0, 0.1, n).astype(np.float32),
        pose=rng.normal(size=(4, 4)), timestamp=1_700_000_000_100_000_000,
        lidar_center=np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
        flow=rng.normal(size=(n, 3)).astype(np.float32),
        flow_is_valid=rng.random(n) < 0.9,
        flow_category_indices=rng.integers(0, 30, n).astype(np.uint8),
        flow_instance_id=rng.integers(0, 3, n).astype(np.uint32),
        ego_motion=np.eye(4, dtype=np.float32), ground_mask=rng.random(n) < 0.3,
        anno_bbx=rng.normal(size=(2, 7)).astype(np.float32),
    )
    extras = {"ssl_dynamic": rng.random(n) < 0.2, "seflowpp_best": frame["flow"] * 2}
    with h5.File(tmp_path / "p.h5", "w") as f:
        PS.write_frame(f, PS.FrameData(**frame, extras=dict(extras)))
        PS.write_frame(f, PS.FrameData(**{**frame, "timestamp": 7}, group_key="000007"))
    with h5py.File(tmp_path / "j.h5", "w") as f:
        JS.write_frame(f, JS.FrameData(**frame, extras=dict(extras)))
        JS.write_frame(f, JS.FrameData(**{**frame, "timestamp": 7}, group_key="000007"))
    with h5py.File(tmp_path / "j.h5", "r") as jf, h5.File(tmp_path / "p.h5") as pf:
        for key in ("1700000000100000000", "000007"):
            j = JS.read_frame(jf, key, extra_keys=tuple(extras))
            p = PS.read_frame(pf, key, extra_keys=tuple(extras))
            assert j.timestamp == p.timestamp and type(p.timestamp) is int
            for name in frame:
                if name != "timestamp":
                    _same(getattr(j, name), getattr(p, name), name)
            assert set(j.extras) == set(p.extras)
            for name in j.extras:
                _same(j.extras[name], p.extras[name], name)
    _assert_reads_like_h5py(tmp_path / "p.h5")
    assert PS.scene_ids(tmp_path) == ["j", "p"]
