"""The port's SSL labels and host cluster prior
(``himo_tpu_torch/training/ssl_labels.py``, the host matcher in
``himo_tpu_torch/models/icp_flow.py``, ``models/nsfp.cluster_prior_flow``)
against the JAX package's, on the CPU.

Every comparison is bitwise (values and dtypes). The reference takes its
native KD-tree when the library is built; the card's host has none, so the
port queries scipy's ``cKDTree`` only. Each test therefore makes the
reference take ``cKDTree`` too, by patching ``himo_tpu.native.available``
to return False for the test's duration. Clouds are float32.

Scenes: the JAX package's ``make_dataset`` (moving boxes, ego motion,
three lidars, ground), the fast-object pair of ``tests/test_fast_objects.py``
and the adversarial worlds of ``tests/test_matcher_stress.py`` (a fast
object crossing another, emergency braking, an object leaving the view),
labelled through ``label_scene`` with its tracker and the backcast repair
of the first two pairs.
"""

import shutil

import h5py
import numpy as np
import pytest
import torch
from test_fast_objects import _fast_scene
from test_matcher_stress import World

import himo_tpu.native
from himo_tpu.data.dataset import SceneFlowDataset as JDataset
from himo_tpu.data.synthetic import make_dataset
from himo_tpu.models import icp_flow as JI
from himo_tpu.models import nsfp as JN
from himo_tpu.training import ssl_labels as JS
from himo_tpu_torch.data import h5
from himo_tpu_torch.models import icp_flow as PI
from himo_tpu_torch.models import nsfp as PN
from himo_tpu_torch.training import ssl_labels as PS

SSL_KEYS = ("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid")


@pytest.fixture(autouse=True)
def reference_on_ckdtree(monkeypatch):
    monkeypatch.setattr(himo_tpu.native, "available", lambda: False)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _same_results(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for name, a, b in zip(SSL_KEYS, g, w):
            _same(a, b, (k, name))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl") / "av2_ssl"
    make_dataset(root, num_scenes=2, num_frames=5, seed=42, num_background=1500)
    return root


def _frames(root):
    ds = JDataset(root, with_pc1=True, next_keys=("lidar_dt",))
    return [ds[i] for i in range(len(ds))]


def _world(kind):
    if kind == "crossing":
        w = World(seed=5)
        w.add_object((5.0, -5.0, 1.0), np.tile([20.0, 20.0, 0.0], (5, 1)), size=(4.5, 2.0, 1.6))
        w.add_object((17.0, 10.0, 1.2), np.tile([-20.0, -20.0, 0.0], (5, 1)),
                     size=(6.5, 2.4, 2.4))
        return w.frame_dicts(5)
    if kind == "braking":
        w = World(seed=6)
        w.add_object((5.0, 3.0, 1.0), np.array([[s, 0.0, 0.0] for s in
                                                (15.0, 13.5, 12.0, 10.5, 9.0)]))
        return w.frame_dicts(5)
    w = World(seed=1)
    w.add_object((8.0, 4.0, 1.0), np.tile([25.0, 0.0, 0.0], (4, 1)),
                 visible=[True, True, False, False])
    w.add_object((-6.0, -8.0, 1.0), np.tile([0.0, 12.0, 0.0], (4, 1)))
    return w.frame_dicts(4)


def test_dynamic_masks_clusters_and_bodies_match_reference(dataset_dir):
    n_clusters = 0
    for data in _frames(dataset_dir)[:6]:
        xyz0, xyz1 = data["pc0"][:, :3], data["pc1"][:, :3]
        comp = xyz0 + JS.rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
        _same(PS.nn_residual_distances(comp, xyz1), JS.nn_residual_distances(comp, xyz1))
        ng0, ng1 = ~data["gm0"], ~data["gm1"]
        want_dyn = JS.dynamic_mask_from_nn(comp[ng0], xyz1[ng1])
        _same(PS.dynamic_mask_from_nn(comp[ng0], xyz1[ng1]), want_dyn)
        dynamic = np.zeros(len(xyz0), bool)
        dynamic[ng0] = want_dyn
        for eps, min_samples in ((0.6, 8), (1.0, 5), (0.8, 3)):
            want = JS.cluster_dynamic_points(comp, dynamic, eps, min_samples)
            _same(PS.cluster_dynamic_points(comp, dynamic, eps, min_samples), want)
            _same(PS.complete_cluster_bodies(comp, want, ng0),
                  JS.complete_cluster_bodies(comp, want, ng0))
            n_clusters = max(n_clusters, int(want.max()))
    assert n_clusters >= 2


def test_cluster_ids_follow_the_reference_on_equal_sizes():
    # Two blobs of equal size: np.argsort(-counts) (not stable) decides
    # which becomes cluster 1, from the raw ids; the port keeps that call.
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.2, (40, 3)) + [5.0, 0, 0]
    b = rng.normal(0, 0.2, (40, 3)) + [-5.0, 0, 0]
    pts = np.concatenate([a, b, rng.uniform(-30, 30, (200, 3))]).astype(np.float32)
    dyn = np.zeros(len(pts), bool)
    dyn[:80] = True
    want = JS.cluster_dynamic_points(pts, dyn, 0.6, 8)
    _same(PS.cluster_dynamic_points(pts, dyn, 0.6, 8), want)
    assert set(np.unique(want[:80])) == {1, 2}


@pytest.mark.parametrize("with_prior", [False, True])
def test_label_frame_matches_reference(dataset_dir, with_prior):
    covered = 0
    for data in _frames(dataset_dir)[:4]:
        got = PS.label_frame(data, with_prior=with_prior)
        want = JS.label_frame(data, with_prior=with_prior)
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, k)
        if with_prior:
            covered += int(want[3].sum())
    assert not with_prior or covered > 0


def test_translation_priors_on_the_fast_pair_match_reference():
    rng = np.random.default_rng(0)
    p0, p1, v, _, n_static, n = _fast_scene(rng)
    labels0 = JS.cluster_dynamic_points(p0, np.r_[np.zeros(n_static, bool),
                                                  np.ones(n - n_static, bool),
                                                  np.zeros(len(p0) - n, bool)], 1.0, 5)
    dyn1 = np.zeros(len(p1), bool)
    dyn1[v] = JS.dynamic_mask_from_nn(p1[v], p0[v])
    got = PS.translation_priors(p0, labels0, p1, dyn1, eps=1.0, min_samples=5,
                                eligible0=v, eligible1=v)
    want = JS.translation_priors(p0, labels0, p1, dyn1, eps=1.0, min_samples=5,
                                 eligible0=v, eligible1=v)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert want[1][n_static:n].mean() > 0.5


@pytest.mark.parametrize("kind", ["crossing", "braking", "leaving"])
def test_label_scene_with_tracker_and_backcast_matches_reference(kind):
    frames = _world(kind)
    got = PS.label_scene(frames)
    want = JS.label_scene(frames)
    _same_results(got, want)
    assert any(w[3].any() for w in want)


def test_cluster_tracker_matches_reference():
    frames = _world("crossing")
    trackers = (PI.ClusterTracker(), JI.ClusterTracker())
    for data in frames[:-1]:
        for mod, tracker in zip((PS, JS), trackers):
            mod.label_frame(data, with_prior=True, tracker=tracker)
        got, want = (t.tracks for t in trackers)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                _same(a[key], b[key], key)
    for n_frames in (2, 3):
        back = [t.backcast(n_frames).tracks for t in trackers]
        for a, b in zip(*back):
            for key in a:
                _same(a[key], b[key], key)


def test_host_matcher_matches_reference():
    rng = np.random.default_rng(1)
    p0, p1, v, _, n_static, n = _fast_scene(rng, shift=(2.8, -0.6, 0.0))
    dyn0 = np.zeros(len(p0), bool)
    dyn0[v] = JS.dynamic_mask_from_nn(p0[v], p1[v])
    dyn1 = np.zeros(len(p1), bool)
    dyn1[v] = JS.dynamic_mask_from_nn(p1[v], p0[v])
    labels0 = JS.cluster_dynamic_points(p0, dyn0, 1.0, 5)
    labels1 = JS.cluster_dynamic_points(p1, dyn1, 1.0, 5)
    kw = dict(recover_dynamic1=dyn1, return_splits=True)
    got = PI.match_cluster_translations(p0, labels0, p1, labels1, 32, 6.0, **kw)
    want = JI.match_cluster_translations(p0, labels0, p1, labels1, 32, 6.0, **kw)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    blob = p0[n_static:n]
    delta = np.asarray(want[0][0])
    assert PI.motion_beats_null(blob, p0, p1, delta) == JI.motion_beats_null(blob, p0, p1, delta)
    _same(PI._refine_translation(blob, p1[n_static:n], delta),
          JI._refine_translation(blob, p1[n_static:n], delta))
    splits_got = PI.recover_split_translations(blob, p1[dyn1], 6.0)
    splits_want = JI.recover_split_translations(blob, p1[dyn1], 6.0)
    assert len(splits_got) == len(splits_want)
    for (dg, mg), (dw, mw) in zip(splits_got, splits_want):
        _same(dg, dw)
        _same(mg, mw)


@pytest.mark.parametrize("with_tracker", [False, True])
def test_cluster_prior_flow_matches_reference(with_tracker):
    frames = _world("crossing")
    trackers = (PI.ClusterTracker(), JI.ClusterTracker()) if with_tracker else (None, None)
    covered = 0
    for data in frames[:-1]:
        v0 = np.ones(len(data["pc0"]), bool)
        v1 = np.ones(len(data["pc1"]), bool)
        kw = dict(dt0=data["lidar_dt"], dt1=data["lidar_dt1"])
        if with_tracker:
            kw["pose1"] = data["pose1"]
        got = PN.cluster_prior_flow(torch.from_numpy(data["pc0"]), torch.from_numpy(data["pc1"]),
                                    torch.from_numpy(v0), torch.from_numpy(v1),
                                    PN.NSFPConfig(), tracker=trackers[0], **kw)
        want = JN.cluster_prior_flow(data["pc0"], data["pc1"], v0, v1, JN.NSFPConfig(),
                                     tracker=trackers[1], **kw)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        _same(got.numpy(), np.asarray(want))
        covered += int((np.abs(np.asarray(want)) > 0).any(1).sum())
    assert covered > 0


def _read_all(path, reader):
    with reader(path, "r") as f:
        return {key: {name: f[key][name][()] for name in f[key].keys()} for key in f.keys()}


@pytest.mark.parametrize("method", ["nn", "dufo"])
def test_writers_write_what_the_reference_writes(dataset_dir, tmp_path, method):
    ref_dir, port_dir = tmp_path / "ref_av2", tmp_path / "port_av2"
    shutil.copytree(dataset_dir, ref_dir)
    shutil.copytree(dataset_dir, port_dir)
    if method == "nn":
        n_ref = JS.write_ssl_labels(ref_dir, verbose=False)
        n_port = PS.write_ssl_labels(port_dir, verbose=False)
    else:
        n_ref = JS.write_ssl_labels_dufo(ref_dir, verbose=False)
        n_port = PS.write_ssl_labels_dufo(port_dir, verbose=False)
    assert n_ref == n_port == 10
    for scene in sorted(p.name for p in dataset_dir.glob("*.h5")):
        before = _read_all(dataset_dir / scene, h5py.File)
        want = _read_all(ref_dir / scene, h5py.File)
        got = _read_all(port_dir / scene, h5py.File)
        got_port_reader = _read_all(port_dir / scene, lambda p, m: h5.File(p))
        assert got.keys() == want.keys() == before.keys()
        for key in want:
            assert set(got[key]) == set(want[key]) == set(before[key]) | set(SSL_KEYS)
            for name in want[key]:
                _same(got[key][name], want[key][name], (scene, key, name))
                _same(got_port_reader[key][name], want[key][name], (scene, key, name))
        assert any(want[key]["ssl_dynamic"].any() for key in want)
