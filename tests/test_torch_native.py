"""The port's native host library (``himo_tpu_torch/native.py`` over its
copy of the C++ source) against the JAX package's (``himo_tpu/native.py``
over ``native/``), on the CPU, and the native branch of the host code that
asks for it.

Both libraries are built here (the JAX package's with ``make``, the port's
with ``g++`` into ``himo_tpu_torch/_build/``) from the same code with the
same flags, so every result is held bitwise: KD-tree distances (float32)
and indices, Chamfer distances, packed batches, read attributes. Inputs
are float32 from seeded numpy."""

import subprocess

import numpy as np
import pytest

import himo_tpu.native as JN
import himo_tpu_torch.native as PN


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not JN.available():
        pytest.skip("the JAX package's native library does not build here")
    assert PN.available()


def _cloud(rng, n, scale=20.0):
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_tree,k", [(3000, 1), (3000, 4), (3, 4), (1, 1)])
def test_kdtree_query_matches_reference(n_tree, k):
    """k = 1 gives (n,) arrays, k > 1 (n, k) sorted; a tree smaller than k
    leaves inf / -1 in the unfilled slots."""
    rng = np.random.default_rng(n_tree + k)
    tree, queries = _cloud(rng, n_tree), _cloud(rng, 5000, 25.0)
    got = PN.KDTree(tree).query(queries, k=k)
    want = JN.KDTree(tree).query(queries, k=k)
    for g, w in zip(got, want):
        _same(g, w)
    d, idx = got
    assert d.shape == ((5000,) if k == 1 else (5000, k))
    if n_tree < k:
        assert np.isinf(d[:, n_tree:]).all() and (idx[:, n_tree:] == -1).all()
    # The nearest is the nearest (float32 distances, so up to a tie).
    brute = np.sqrt(((queries[:, None, :] - tree[None]) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(d if k == 1 else d[:, 0], brute, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sizes", [(2000, 2500), (1, 700), (40, 40)])
def test_chamfer_matches_reference(sizes):
    rng = np.random.default_rng(sum(sizes))
    a, b = _cloud(rng, sizes[0]), _cloud(rng, sizes[1]) + np.float32(0.5)
    got, want = PN.chamfer(a, b), JN.chamfer(a, b)
    assert isinstance(got, float) and got == want


def test_pack_frames_matches_reference_and_numpy():
    """Frames shorter and longer than the target, with 3 and 1 columns."""
    rng = np.random.default_rng(0)
    for cols in (3, 1):
        frames = [rng.normal(size=(n, cols)).astype(np.float32) for n in (100, 1024, 1500, 0)]
        got = PN.pack_frames(frames, 1024)
        want = JN.pack_frames(frames, 1024)
        for g, w in zip(got, want):
            _same(g, w)
        batch, valid = got
        padded = np.zeros((4, 1024, cols), np.float32)
        for b, f in enumerate(frames):
            padded[b, : min(len(f), 1024)] = f[:1024]
            assert valid[b].sum() == min(len(f), 1024)
        _same(batch, padded)
    with pytest.raises(ValueError):
        PN.pack_frames([np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32)], 8)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int8"])
def test_read_attr_matches_reference(tmp_path, dtype):
    rng = np.random.default_rng(1)
    values = (rng.normal(size=1001) * 100).astype(dtype)
    path = tmp_path / f"attr.{dtype}"
    values.tofile(path)
    got, want = PN.read_attr(path, dtype), JN.read_attr(path, dtype)
    _same(got, want)
    np.testing.assert_array_equal(got, values)


def test_preload_files_counts_the_bytes(tmp_path):
    paths = []
    for n in (10, 3 * 2**20 + 7):
        path = tmp_path / f"f{n}.bin"
        path.write_bytes(b"x" * n)
        paths.append(path)
    total = sum(p.stat().st_size for p in paths)
    assert PN.preload_files(paths + [tmp_path / "missing.h5"]) == total
    assert PN.preload_files(paths) == JN.preload_files(paths)


def test_build_tracks_source_and_refuses_a_broken_one(tmp_path, monkeypatch):
    """The library's name follows its source; a source that does not
    compile raises with the compiler's output; without a compiler the
    library is unavailable (and its consumers take scipy)."""
    cxx = PN.compiler()
    lib = PN.build(cxx)
    assert lib.parent == PN.BUILD_DIR and lib.name.startswith("himo_native-")
    assert PN.build(cxx) == lib
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(PN, "SOURCE", broken)
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path / "_build")
    assert PN._library_path(cxx) != lib.with_name(lib.name)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        PN.build(cxx)
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "compiler", lambda: None)
    assert not PN.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        PN.KDTree(np.zeros((4, 3), np.float32))


def test_library_exports_what_the_binding_declares():
    """The C entry points the binding declares are the ones the library
    exports."""
    lib = PN.build(PN.compiler())
    out = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    exported = {line.split()[-1] for line in out.splitlines() if " T " in line}
    for name in ("himo_kd_build", "himo_kd_free", "himo_kd_query", "himo_kd_query_k",
                 "himo_chamfer", "himo_read_attr", "himo_preload_files", "himo_pack_frames",
                 "himo_lz4_frame_decode"):
        assert name in exported


def test_label_frame_native_branch_matches_reference(tmp_path):
    """``ssl_labels.label_frame`` with both native trees in use (the NN
    residuals and the own-cloud 6-NN of the dynamic masks), bitwise."""
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.data.synthetic import make_dataset
    from himo_tpu.training import ssl_labels as JS
    from himo_tpu_torch.training import ssl_labels as PS

    root = tmp_path / "av2_native"
    make_dataset(root, num_scenes=1, num_frames=3, seed=42, num_background=1500)
    ds = SceneFlowDataset(root, with_pc1=True, next_keys=("lidar_dt",))
    covered = 0
    for i in range(2):
        data = ds[i]
        got = PS.label_frame(data, with_prior=True)
        want = JS.label_frame(data, with_prior=True)
        for g, w in zip(got, want):
            _same(g, w)
        covered += int(want[0].sum())
    assert covered > 0


def test_matcher_native_branch_matches_reference():
    """``icp_flow``'s matcher with both native trees in its NN queries, on
    the fast-object pair, bitwise."""
    from test_fast_objects import _fast_scene

    from himo_tpu.models import icp_flow as JI
    from himo_tpu.training import ssl_labels as JS
    from himo_tpu_torch.models import icp_flow as PI

    p0, p1, v, _, n_static, n = _fast_scene(np.random.default_rng(1), shift=(2.8, -0.6, 0.0))
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
    _same(PI._refine_translation(blob, p1[n_static:n], delta),
          JI._refine_translation(blob, p1[n_static:n], delta))
