"""The port's clustering (``himo_tpu_torch/training/clustering.py``) against
sklearn 1.9, which the JAX package's label pipeline calls.

- ``hdbscan``: equal to ``HDBSCAN(min_cluster_size=m,
  cluster_selection_method="eom", allow_single_cluster=...).fit_predict``
  bit for bit, the label numbering included, on float32 clouds (both sides
  cast to float64): gaussian blobs of several densities, quarter-metre
  grid points (equal distances everywhere, so every tie rule of Prim's
  tree and of the sorts is exercised), duplicated points, one lone
  cluster (where eom finds nothing without ``allow_single_cluster``),
  uniform noise, and a cloud of exactly ``min_samples`` points.
- ``connected_components``: the same partition as ``DBSCAN(eps,
  min_samples=1)`` (the numbering is scipy's; only the partition is used).
"""

import numpy as np
import pytest
from sklearn.cluster import DBSCAN, HDBSCAN

from himo_tpu_torch.training import clustering


def _blobs(seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, (5, 3))
    return np.concatenate([
        c + rng.normal(0, rng.uniform(0.2, 1.5), (rng.integers(10, 200), 3))
        for c in centers
    ]).astype(np.float32)


def _grid(seed, n=400):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-3, 3, (n, 3)) * 4) / 4).astype(np.float32)


CLOUDS = {
    "blobs0": lambda: _blobs(0),
    "blobs1": lambda: _blobs(1),
    "blobs2": lambda: _blobs(2),
    "grid": lambda: _grid(9),
    "grid_repeats": lambda: np.concatenate([_grid(9)[:100], _grid(9)[:100], _grid(9)[50:200]]),
    "duplicates": lambda: np.repeat(
        np.random.default_rng(3).normal(0, 1, (40, 3)).astype(np.float32), 3, axis=0),
    "lone_cluster": lambda: np.random.default_rng(4).normal(0, 0.5, (60, 3)).astype(np.float32),
    "noise": lambda: np.random.default_rng(5).uniform(-50, 50, (30, 3)).astype(np.float32),
    "n_equals_min_samples": lambda: np.random.default_rng(6).normal(0, 1, (8, 3)).astype(np.float32),
}


def _sklearn(points, min_cluster_size, allow_single_cluster):
    return HDBSCAN(min_cluster_size=min_cluster_size, cluster_selection_method="eom",
                   allow_single_cluster=allow_single_cluster, copy=True).fit_predict(points)


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_hdbscan_equals_sklearn_bitwise(name):
    points = CLOUDS[name]()
    found = set()
    for min_cluster_size in (2, 5, 8):
        for single in (False, True):
            want = _sklearn(points, min_cluster_size, single)
            got = clustering.hdbscan(points, min_cluster_size, allow_single_cluster=single)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} m={min_cluster_size} "
                                                             f"single={single}")
            found.add(int(want.max()))
    if name == "lone_cluster":
        # eom alone finds nothing; the retry with allow_single_cluster does.
        assert _sklearn(points, 8, False).max() == -1 and _sklearn(points, 8, True).max() == 0
    if name.startswith("blobs"):
        assert max(found) >= 2


def test_hdbscan_refuses_what_sklearn_refuses():
    points = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError):
        clustering.hdbscan(points, 5)
    with pytest.raises(ValueError):
        clustering.hdbscan(points[:1], 2)


def test_prim_tree_takes_the_first_node_at_the_lowest_reachability():
    # Four points on a line at unit spacing, min_samples 2: every mutual
    # reachability is 1 along the line, so each step is a tie that the first
    # node not yet in the tree wins, and the sources are the first nodes to
    # reach each one.
    points = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float64)
    core = clustering.core_distances(points, 2)
    mst = clustering.prim_mst(points, core)
    assert mst["current_node"].tolist() == [0, 1, 2]
    assert mst["next_node"].tolist() == [1, 2, 3]
    np.testing.assert_array_equal(mst["distance"], [1.0, 1.0, 1.0])


@pytest.mark.parametrize("name", ["blobs0", "grid", "duplicates", "noise"])
@pytest.mark.parametrize("eps", [0.25, 0.7, 2.0])
def test_connected_components_partition_equals_dbscan(name, eps):
    points = CLOUDS[name]()
    got = clustering.connected_components(points, eps)
    want = DBSCAN(eps=eps, min_samples=1).fit_predict(points)
    pairs = set(zip(got.tolist(), want.tolist()))
    assert len(pairs) == len(set(got.tolist())) == len(set(want.tolist()))
