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
- ``dbscan``: equal to ``DBSCAN(eps, min_samples).fit_predict`` bit for
  bit, numbering included, at several ``eps`` and ``min_samples`` on the
  clouds above (``min_samples=1`` is the label pipeline's fragment merge) (on the quarter-metre grids many pairs sit at exactly
  ``eps``), on border points in reach of two clusters, and on the
  detector's own setting (``eps`` 0.9, 15 samples) over a frame-sized
  cloud.
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


@pytest.mark.parametrize("min_samples", [1, 2, 4, 15])
@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_dbscan_equals_sklearn_bitwise(name, min_samples):
    points = CLOUDS[name]()
    found = -1
    for eps in (0.25, 0.5, 0.7, 0.9, 2.0):
        want = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(points)
        got = clustering.dbscan(points, eps, min_samples)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} eps={eps}")
        found = max(found, int(want.max()))
    # No vacuous case: at min_samples 1 every point is core and every cloud
    # splits; the clouds with density structure keep several clusters up to
    # 4 samples.
    if min_samples == 1 or (min_samples <= 4 and name.startswith(("blobs", "grid", "dup"))):
        assert found >= 1


def test_dbscan_border_point_takes_the_first_cluster():
    # Two 3-point cores on a line at unit spacing, a border point between
    # them in reach of one core point of each: it joins the cluster of the
    # lower-index core point (numbered first), whichever side comes first in
    # the array; with min_samples 4 nothing is core.
    left = [[0, 0, 0], [1, 0, 0], [2, 0, 0]]
    right = [[6, 0, 0], [5, 0, 0], [4, 0, 0]]
    border = [[3, 0, 0]]
    for rows in (left + right + border, right + left + border, border + left + right):
        points = np.array(rows, np.float32)
        want = DBSCAN(eps=1.0, min_samples=3).fit_predict(points)
        got = clustering.dbscan(points, 1.0, 3)
        np.testing.assert_array_equal(got, want)
        b = rows.index(border[0])
        first = min(rows.index(left[2]), rows.index(right[2]))
        assert got[b] == got[first]
    assert (clustering.dbscan(np.array(left + right, np.float32), 1.0, 4) == -1).all()


def test_dbscan_at_the_detectors_setting():
    rng = np.random.default_rng(8)
    centers = rng.uniform(-40, 40, (30, 3))
    points = np.concatenate([
        c + rng.normal(0, [1.5, 0.8, 0.5], (int(rng.integers(5, 300)), 3)) for c in centers
    ] + [rng.uniform(-50, 50, (3000, 3))]).astype(np.float32)
    points = np.concatenate([points, points[:200]])  # duplicates
    want = DBSCAN(eps=0.9, min_samples=15).fit_predict(points)
    np.testing.assert_array_equal(clustering.dbscan(points, 0.9, 15), want)
    assert want.max() >= 10
