"""The port's host data layer against the JAX package, on the CPU.

``make_dataset``, the reading indices, ``SceneFlowDataset``, ``padding``,
``categories`` and ``dataset_id``: for the same inputs the port must give
the same arrays bit for bit, the same dtypes and the same pickles. Scene
files come from JAX's writer (h5py), some changed afterwards in h5py's
append mode, one with leading-zero group keys."""

import pickle

import h5py
import numpy as np
import pytest

from himo_tpu.core import categories as JC
from himo_tpu.core import dataset_id as JID
from himo_tpu.data import dataset as JD
from himo_tpu.data import index as JI
from himo_tpu.data import padding as JP
from himo_tpu.data import schema as JS
from himo_tpu.data import synthetic as JSyn
from himo_tpu_torch.core import categories as PC
from himo_tpu_torch.core import dataset_id as PID
from himo_tpu_torch.data import dataset as PD
from himo_tpu_torch.data import h5
from himo_tpu_torch.data import index as PI
from himo_tpu_torch.data import padding as PP
from himo_tpu_torch.data import synthetic as PSyn


def _assert_same_item(j, p):
    assert set(j) == set(p)
    for key, want in j.items():
        got = p[key]
        assert type(got) is type(want), (key, type(got), type(want))
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert got.tobytes() == want.tobytes(), key
        else:
            assert got == want, key


def _assert_same_files(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert list(fa) == list(fb)
        for g in fa:
            assert list(fa[g]) == list(fb[g])
            for d in fa[g]:
                x, y = fa[g][d][()], fb[g][d][()]
                assert type(x) is type(y) and x.dtype == y.dtype, (g, d)
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), (g, d)


@pytest.mark.parametrize("kwargs", [
    dict(num_scenes=2, num_frames=4, seed=0, num_background=400,
         method_flows={"perfect": 0.0, "seflowpp_best": 0.04}),
    dict(num_scenes=3, num_frames=3, seed=11, num_background=250, ego_speed=5.0,
         num_lidars=2, method_flows=("perfect", "noisy"), method_noise=0.1),
])
def test_make_dataset_matches_jax(tmp_path, kwargs):
    JSyn.make_dataset(tmp_path / "j" / "av2", **kwargs)
    PSyn.make_dataset(tmp_path / "p" / "av2", **kwargs)
    scenes = sorted(p.name for p in (tmp_path / "j" / "av2").glob("*.h5"))
    assert scenes == sorted(p.name for p in (tmp_path / "p" / "av2").glob("*.h5"))
    for name in scenes:
        _assert_same_files(tmp_path / "j" / "av2" / name, tmp_path / "p" / "av2" / name)
    for name in ("index_total.pkl", "index_eval.pkl"):
        assert (tmp_path / "j" / "av2" / name).read_bytes() == \
            (tmp_path / "p" / "av2" / name).read_bytes(), name


@pytest.fixture(scope="module")
def jax_scenes(tmp_path_factory):
    """Two JAX-written scenes with the trainer's ``ssl_*`` extras added in
    h5py's append mode, and a third whose groups have leading-zero keys."""
    root = tmp_path_factory.mktemp("data") / "av2_items"
    JSyn.make_dataset(root, num_scenes=2, num_frames=5, seed=2, num_background=300,
                      method_flows={"seflowpp_best": 0.04})
    rng = np.random.default_rng(0)
    with h5py.File(root / "scene_001.h5", "a") as f:
        for key in f:
            inst = f[key]["flow_instance_id"][()]
            f[key].create_dataset("ssl_dynamic", data=inst > 0)
            f[key].create_dataset("ssl_cluster", data=inst.astype(np.int32) - 1)
            f[key].create_dataset("ssl_prior", data=rng.normal(size=(len(inst), 3)).astype(np.float32))
            f[key].create_dataset("ssl_prior_valid", data=rng.random(len(inst)) < 0.1)
    with h5py.File(root / "scene_002.h5", "w") as f:
        for i, frame_no in enumerate((98, 99, 100)):
            n = 40 + i
            JS.write_frame(f, JS.FrameData(
                lidar=rng.normal(size=(n, 4)).astype(np.float32),
                lidar_id=np.ones(n, np.uint8), lidar_dt=rng.uniform(0, 0.1, n).astype(np.float32),
                pose=np.eye(4) + rng.normal(0, 0.01, (4, 4)), timestamp=1_700_000_000 + i,
                ground_mask=rng.random(n) < 0.3, group_key=f"{frame_no:06d}"))
    JI.create_reading_index(root, save=True)
    JI.extract_eval_index(root, every_n=2)
    return root


def test_reading_indices_match_jax(jax_scenes, tmp_path):
    got = PI.create_reading_index(jax_scenes, save=False)
    want = JI.create_reading_index(jax_scenes, save=False)
    assert got == want
    assert ["scene_002", "000098"] in got  # leading zeros kept as strings
    PI.save_index(got, tmp_path, PI.INDEX_TOTAL)
    assert (tmp_path / PI.INDEX_TOTAL).read_bytes() == (jax_scenes / JI.INDEX_TOTAL).read_bytes()
    jdir = tmp_path / "j"
    jdir.mkdir()
    (jdir / JI.INDEX_TOTAL).write_bytes((jax_scenes / JI.INDEX_TOTAL).read_bytes())
    kw = dict(scene_ids=["scene_001", "scene_002"], every_n=2, max_frames=4)
    sub = PI.extract_eval_index(tmp_path, **kw)
    jsub = JI.extract_eval_index(jdir, **kw)
    assert sub == jsub == PI.load_index(tmp_path, PI.INDEX_EVAL)
    assert (tmp_path / PI.INDEX_EVAL).read_bytes() == (jdir / JI.INDEX_EVAL).read_bytes()
    with open(jax_scenes / JI.INDEX_EVAL, "rb") as f:
        assert PI.load_index(jax_scenes, PI.INDEX_EVAL) == pickle.load(f)


ITEM_CASES = {
    "plain": dict(),
    "eval_vis": dict(eval=True, vis_name="seflowpp_best"),
    "pc1_history_ssl": dict(with_pc1=True, with_history=True,
                            extra_keys=("ssl_dynamic", "ssl_cluster", "ssl_prior",
                                        "ssl_prior_valid"),
                            next_keys=("ssl_dynamic",)),
    "eval_pc1_history": dict(eval=True, with_pc1=True, with_history=True,
                             vis_name=["seflowpp_best", "missing"]),
}


@pytest.mark.parametrize("case", list(ITEM_CASES))
def test_dataset_items_match_jax(jax_scenes, case):
    kw = ITEM_CASES[case]
    jds, pds = JD.SceneFlowDataset(jax_scenes, **kw), PD.HDF5Dataset(jax_scenes, **kw)
    assert len(jds) == len(pds) > 0
    assert pds.scene_ids() == jds.scene_ids() == ["scene_000", "scene_001", "scene_002"]
    for i in range(len(jds)):
        _assert_same_item(jds[i], pds[i])
    if kw.get("next_keys"):
        assert any("ssl_dynamic1" in pds[i] for i in range(len(pds)))


def test_dataset_without_index_files_matches_jax(jax_scenes, tmp_path):
    for path in jax_scenes.glob("*.h5"):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    for kw in (dict(), dict(eval=True, with_pc1=True)):
        jds, pds = JD.SceneFlowDataset(tmp_path, **kw), PD.SceneFlowDataset(tmp_path, **kw)
        assert pds.data_index == jds.data_index
        assert len(jds) == len(pds)
        for i in range(len(jds)):
            _assert_same_item(jds[i], pds[i])
    assert not (tmp_path / "index_total.pkl").exists()


def test_padding_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 1000, 8192, 8193, 20000, 262144, 262145, 300000):
        assert PP.bucket_size(n) == JP.bucket_size(n)
        assert PP.bucket_size(n, (10, 2048)) == JP.bucket_size(n, (10, 2048))
    arrays = {"pc": rng.normal(size=(5000, 3)).astype(np.float32),
              "mask": rng.random(4000) < 0.5, "ids": np.arange(5000, dtype=np.uint32)}
    for n in (None, 5000, 9000):
        (jp, jv), (pp, pv) = JP.pad_to_bucket(arrays, n), PP.pad_to_bucket(arrays, n)
        assert jv.tobytes() == pv.tobytes() and set(jp) == set(pp)
        for key in jp:
            assert jp[key].dtype == pp[key].dtype and jp[key].tobytes() == pp[key].tobytes()
    for mod in (JP, PP):
        with pytest.raises(ValueError):
            mod.pad_to_bucket({})
        with pytest.raises(ValueError):
            mod.pad_to_bucket({"a": np.zeros(9000)}, n=10)
    assert PP.DEFAULT_BUCKETS == JP.DEFAULT_BUCKETS


def test_categories_and_dataset_id_match_jax(tmp_path):
    names = [n for n in dir(JC) if n.isupper()]
    assert names == [n for n in dir(PC) if n.isupper()]
    for name in names:
        assert getattr(PC, name) == getattr(JC, name), name
    for path in ("/data/av2/val", "/x/Scania_demo", "AV2"):
        assert PID.infer_dataset_name(path) == JID.infer_dataset_name(path)
    for mod in (JID, PID):
        with pytest.raises(ValueError):
            mod.infer_dataset_name("/data/kitti")
    zip_path = tmp_path / "sub.zip"
    zip_path.write_bytes(b"")
    assert PID.check_valid("/d/av2", "flow", str(zip_path))[1] is PID.EvalSource.ZIP
    assert PID.check_valid("/d/av2", "flow", None)[1].name == \
        JID.check_valid("/d/av2", "flow", None)[1].name == "FLOW"


def test_read_through_dataset_equals_what_the_port_wrote(tmp_path):
    """The port's writer -> the port's reader, through the dataset, with
    the scene's own in-memory arrays as the reference."""
    root = tmp_path / "av2"
    PSyn.make_dataset(root, num_scenes=1, num_frames=3, seed=6, num_background=200)
    with h5.File(root / "scene_000.h5") as f:
        frames = {k: {d: f[k][d][()] for d in f[k]} for k in f}
    with h5py.File(root / "scene_000.h5", "r") as f:
        for k, group in frames.items():
            for d, value in group.items():
                assert f[k][d][()].tobytes() == np.asarray(value).tobytes()
    pds = PD.SceneFlowDataset(root, with_pc1=True)
    item = pds[0]
    first = frames[sorted(frames)[0]]
    assert item["pc0"].tobytes() == first["lidar"].tobytes()
    assert item["pose1"].tobytes() == frames[sorted(frames)[1]]["pose"].tobytes()
    assert item["has_next"] and not pds[2]["has_next"]
