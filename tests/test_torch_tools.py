"""The port's small data tools against the JAX package's, on the CPU:
``cli/repack_h5.py`` (which rewrites each changed scene whole where the
JAX package edits it in h5py's append mode), ``cli/pkl_extract.py``, and
``data/synthetic.make_benchmark_dataset`` with its adversarial scenes.
Scene files are compared as h5py reads them: the same groups and
datasets, dtypes and bytes; pickles byte for byte."""

import shutil

import h5py
import numpy as np
import pytest

from himo_tpu.cli.pkl_extract import main as j_pkl_extract
from himo_tpu.cli.repack_h5 import main as j_repack
from himo_tpu.data import synthetic as JSyn
from himo_tpu_torch.cli.pkl_extract import main as p_pkl_extract
from himo_tpu_torch.cli.repack_h5 import main as p_repack
from himo_tpu_torch.data import synthetic as PSyn


def _datasets(path) -> dict:
    with h5py.File(path, "r") as f:
        return {(g, d): np.asarray(f[g][d][()]) for g in f for d in f[g]}


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    """Two JAX-written scenes made legacy in h5py's append mode: each
    group's ``lidar_center`` replaced by (L, 3) ``SensorsCenter``, an
    ``old_key`` added; uint32 instance ids (the schema's) left to fix."""
    root = tmp_path_factory.mktemp("tools") / "av2_legacy"
    JSyn.make_dataset(root, num_scenes=2, num_frames=3, seed=4, num_background=300,
                      num_lidars=2, method_flows={"m": 0.0})
    rng = np.random.default_rng(0)
    with h5py.File(root / "scene_000.h5", "a") as f:
        for g in f.values():
            del g["lidar_center"]
            g.create_dataset("SensorsCenter", data=rng.normal(0, 1, (2, 3)).astype(np.float32))
            g.create_dataset("old_key", data=np.arange(5))
    with h5py.File(root / "scene_001.h5", "a") as f:
        first = list(f)[0]
        f[first].create_dataset("old_key", data=np.arange(3))
    return root


@pytest.mark.parametrize("drop_keys", [(), ("old_key", "ground_mask"), "old_key"])
def test_repack_h5_matches_jax(legacy, tmp_path, drop_keys, capsys):
    before = {p.name: _datasets(p) for p in legacy.glob("*.h5")}
    for side in ("jax", "port"):
        shutil.copytree(legacy, tmp_path / side)
        (tmp_path / side / "broken.h5").write_bytes(b"not an HDF5 file")
    capsys.readouterr()
    j_total = j_repack(data_dir=str(tmp_path / "jax"), drop_keys=drop_keys)
    j_out = capsys.readouterr().out
    p_total = p_repack(data_dir=str(tmp_path / "port"), drop_keys=drop_keys)
    p_out = capsys.readouterr().out
    assert p_total == j_total > 0
    strip = [line for line in p_out.splitlines() if not line.startswith("[ERROR]")]
    assert strip == [line for line in j_out.splitlines() if not line.startswith("[ERROR]")]
    assert "[ERROR] broken.h5: " in p_out and "[ERROR] broken.h5: " in j_out
    for name, original in before.items():
        got = _datasets(tmp_path / "port" / name)
        _assert_same(got, _datasets(tmp_path / "jax" / name))
        changed = {"SensorsCenter", "lidar_center", "flow_instance_id", "old_key",
                   "ground_mask"}
        for (g, d), value in original.items():
            if d not in changed:
                assert got[g, d].tobytes() == value.tobytes(), (name, g, d)
        for (g, d), value in got.items():
            assert d != "SensorsCenter"
            if d == "flow_instance_id":
                assert value.dtype == np.int64
            if d == "lidar_center":
                assert value.shape == (2, 4, 4) and value.dtype == np.float32
    # A second pass finds nothing left to change beyond the drops.
    again = p_repack(data_dir=str(tmp_path / "port"), drop_keys=drop_keys)
    assert again == j_repack(data_dir=str(tmp_path / "jax"), drop_keys=drop_keys) == 0


@pytest.mark.parametrize("kwargs", [{}, {"every_n": 2}, {"max_frames": 3},
                                    {"scene_ids": "scene_001"},
                                    {"scene_ids": ["scene_000"], "every_n": 2,
                                     "max_frames": 1}])
def test_pkl_extract_matches_jax(legacy, tmp_path, kwargs, capsys):
    out = {}
    for side, main in (("jax", j_pkl_extract), ("port", p_pkl_extract)):
        root = tmp_path / side
        root.mkdir()
        shutil.copy(legacy / "index_total.pkl", root)
        capsys.readouterr()
        subset = main(data_dir=str(root), **kwargs)
        out[side] = (subset, capsys.readouterr().out, (root / "index_eval.pkl").read_bytes())
    assert out["port"] == out["jax"] and out["port"][0]


def test_make_benchmark_dataset_matches_jax(tmp_path):
    kwargs = dict(num_scenes=2, adversarial_scenes=2, num_background=500, seed=5)
    JSyn.make_benchmark_dataset(tmp_path / "jax" / "av2", **kwargs)
    PSyn.make_benchmark_dataset(tmp_path / "port" / "av2", **kwargs)
    names = sorted(p.name for p in (tmp_path / "jax" / "av2").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "av2").iterdir())
    assert names == ["index_eval.pkl", "index_total.pkl", "scene_000.h5", "scene_001.h5",
                     "scene_adv_000.h5", "scene_adv_001.h5"]
    for name in names:
        j, p = tmp_path / "jax" / "av2" / name, tmp_path / "port" / "av2" / name
        if name.endswith(".pkl"):
            assert p.read_bytes() == j.read_bytes(), name
        else:
            _assert_same(_datasets(p), _datasets(j))
    assert PSyn.ADVERSARIAL_KINDS == JSyn.ADVERSARIAL_KINDS
    for kind in PSyn.ADVERSARIAL_KINDS:
        got = PSyn.adversarial_objects(np.random.default_rng(0), 4, kind, 100)
        want = JSyn.adversarial_objects(np.random.default_rng(0), 4, kind, 100)
        assert [o.category for o in got] == [o.category for o in want]
    with pytest.raises(KeyError, match="unknown adversarial kind"):
        PSyn.adversarial_objects(np.random.default_rng(0), 4, "teleport")
