"""Host clustering without sklearn: HDBSCAN and single-linkage components.

The JAX package's label pipeline (``himo_tpu/training/ssl_labels.py``)
clusters dynamic points with ``sklearn.cluster.HDBSCAN`` and merges surface
fragments with ``DBSCAN(min_samples=1)``. The card's host has no sklearn, so
this module computes the same results in numpy and scipy:

- :func:`hdbscan` returns the labels of sklearn 1.9's
  ``HDBSCAN(min_cluster_size=m, cluster_selection_method="eom",
  allow_single_cluster=...).fit_predict`` for euclidean float64 points, the
  label numbering included. It follows sklearn's own steps in order:
  ``min_samples = min_cluster_size``; the core distance is the distance to
  the ``min_samples``-th neighbour, the point itself included
  (``hdbscan.py:338-350``); Prim's minimum spanning tree over the mutual
  reachability, from node 0, with the tie rules of ``_linkage.pyx:111-225``
  (an update only where strictly smaller, then the first minimum over the
  nodes not yet in the tree); ``np.argsort`` of the edge weights with
  numpy's default kind (``hdbscan.py:165``); union-find single linkage
  (``_linkage.pyx:226-290``); the condensed tree, its stabilities, the
  excess-of-mass selection and the labelling (``_tree.pyx``).
- :func:`connected_components` returns the partition that
  ``DBSCAN(eps, min_samples=1).fit_predict`` gives: components of the
  graph of pairs at distance ``<= eps``.

Prim's loop is O(n^2), as sklearn's is; the dynamic points of one frame
number in the thousands.
"""

from __future__ import annotations

import numpy as np

# sklearn's structured dtypes (``_linkage.pyx`` MST_edge_dtype, ``_tree.pyx``
# HIERARCHY_dtype and CONDENSED_dtype): the same field layout keeps
# ``np.argsort`` on the same strided view as sklearn's.
MST_EDGE_DTYPE = np.dtype([
    ("current_node", np.int64),
    ("next_node", np.int64),
    ("distance", np.float64),
])
HIERARCHY_DTYPE = np.dtype([
    ("left_node", np.intp),
    ("right_node", np.intp),
    ("value", np.float64),
    ("cluster_size", np.intp),
])
CONDENSED_DTYPE = np.dtype([
    ("parent", np.intp),
    ("child", np.intp),
    ("value", np.float64),
    ("cluster_size", np.intp),
])
NOISE = -1


def core_distances(points: np.ndarray, min_samples: int) -> np.ndarray:
    """Distance of each point to its ``min_samples``-th nearest neighbour,
    the point itself counted (sklearn's KD-tree ``kneighbors`` on the fit
    data): ``sqrt`` of the squared difference summed over the coordinates in
    order, as both sklearn's and scipy's trees compute it."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=min_samples)
    d = np.asarray(d, np.float64)
    return np.ascontiguousarray(d if d.ndim == 1 else d[:, -1])


def _pair_distances(points: np.ndarray, i: int) -> np.ndarray:
    """Euclidean distance of every point to point ``i``, summed in the
    order of ``sklearn.metrics.DistanceMetric``'s euclidean ``dist``."""
    diff = points - points[i]
    rdist = diff[:, 0] * diff[:, 0]
    for k in range(1, points.shape[1]):
        rdist = rdist + diff[:, k] * diff[:, k]
    return np.sqrt(rdist)


def prim_mst(points: np.ndarray, core: np.ndarray) -> np.ndarray:
    """sklearn's ``mst_from_data_matrix``: Prim's tree over the mutual
    reachability ``max(core_i, core_j, d_ij)``, grown from node 0. Each step
    lowers a node's reachability (and its source) only where the new value
    is strictly smaller, then takes the first node not yet in the tree at
    the lowest reachability; the edge is (its source, it, that value)."""
    n = len(points)
    mst = np.empty(n - 1, dtype=MST_EDGE_DTYPE)
    in_tree = np.zeros(n, bool)
    min_reach = np.full(n, np.inf)
    sources = np.ones(n, np.int64)
    current = 0
    for i in range(n - 1):
        in_tree[current] = True
        mrd = np.maximum(np.maximum(core[current], core), _pair_distances(points, current))
        lower = (mrd < min_reach) & ~in_tree
        min_reach[lower] = mrd[lower]
        sources[lower] = current
        candidates = np.where(in_tree, np.inf, min_reach)
        new = int(np.argmin(candidates))
        mst[i] = (sources[new], new, min_reach[new])
        current = new
    return mst


def single_linkage(mst: np.ndarray) -> np.ndarray:
    """sklearn's ``_process_mst``: the edges sorted by ``np.argsort`` of
    their weights, then merged by union-find (``make_single_linkage``)."""
    mst = mst[np.argsort(mst["distance"])]
    n = len(mst) + 1
    parent = np.full(2 * n - 1, -1, dtype=np.intp)
    size = np.concatenate([np.ones(n, np.intp), np.zeros(n - 1, np.intp)])
    out = np.zeros(n - 1, dtype=HIERARCHY_DTYPE)

    def find(x):
        root = x
        while parent[root] != -1:
            root = parent[root]
        while x != root and parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    next_label = n
    for i, (a, b, distance) in enumerate(zip(mst["current_node"].tolist(),
                                             mst["next_node"].tolist(),
                                             mst["distance"].tolist())):
        left, right = find(a), find(b)
        out[i] = (left, right, distance, size[left] + size[right])
        parent[left] = parent[right] = next_label
        size[next_label] = size[left] + size[right]
        next_label += 1
    return out


def _bfs_from_hierarchy(left: list, right: list, root: int, n: int) -> list:
    """``_tree.pyx``'s ``bfs_from_hierarchy``: the nodes under ``root``,
    level by level, left before right."""
    queue, result = [root], []
    while queue:
        result.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            queue = [c for node in queue for c in (left[node], right[node])]
    return result


def condense_tree(hierarchy: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """``_tree.pyx``'s ``_condense_tree``: the single-linkage tree pruned of
    splits smaller than ``min_cluster_size``, one row per (parent, child,
    lambda = 1 / distance, child size)."""
    root = 2 * len(hierarchy)
    n = len(hierarchy) + 1
    left = hierarchy["left_node"].tolist()
    right = hierarchy["right_node"].tolist()
    value = hierarchy["value"].tolist()
    size = hierarchy["cluster_size"].tolist()
    next_label = n + 1
    node_list = _bfs_from_hierarchy(left, right, root, n)
    relabel = np.empty(root + 1, dtype=np.intp)
    relabel[root] = n
    result = []
    ignore = np.zeros(len(node_list), dtype=bool)

    def fall_out(parent, sub, lam):
        for sub_node in _bfs_from_hierarchy(left, right, sub, n):
            if sub_node < n:
                result.append((parent, sub_node, lam, 1))
            ignore[sub_node] = True

    for node in node_list:
        if ignore[node] or node < n:
            continue
        lo, hi, distance = left[node - n], right[node - n], value[node - n]
        lam = 1.0 / distance if distance > 0.0 else np.inf
        lo_count = size[lo - n] if lo >= n else 1
        hi_count = size[hi - n] if hi >= n else 1
        if lo_count >= min_cluster_size and hi_count >= min_cluster_size:
            relabel[lo] = next_label
            next_label += 1
            result.append((relabel[node], relabel[lo], lam, lo_count))
            relabel[hi] = next_label
            next_label += 1
            result.append((relabel[node], relabel[hi], lam, hi_count))
        elif lo_count < min_cluster_size and hi_count < min_cluster_size:
            fall_out(relabel[node], lo, lam)
            fall_out(relabel[node], hi, lam)
        elif lo_count < min_cluster_size:
            relabel[hi] = relabel[node]
            fall_out(relabel[node], lo, lam)
        else:
            relabel[lo] = relabel[node]
            fall_out(relabel[node], hi, lam)
    return np.array(result, dtype=CONDENSED_DTYPE)


def compute_stability(condensed: np.ndarray) -> dict:
    """``_tree.pyx``'s ``_compute_stability``: per cluster node, the sum over
    its rows of ``(lambda - its birth lambda) * size``, accumulated in row
    order."""
    parents = condensed["parent"]
    largest_child = int(condensed["child"].max())
    smallest = int(parents.min())
    num_clusters = int(parents.max()) - smallest + 1
    largest_child = max(largest_child, smallest)
    births = np.full(largest_child + 1, np.nan)
    births[condensed["child"]] = condensed["value"]
    births[smallest] = 0.0
    result = [0.0] * num_clusters
    births_l = births.tolist()
    for parent, lam, size in zip(parents.tolist(), condensed["value"].tolist(),
                                 condensed["cluster_size"].tolist()):
        result[parent - smallest] += (lam - births_l[parent]) * size
    return {i + smallest: result[i] for i in range(num_clusters)}


def _bfs_from_cluster_tree(tree: np.ndarray, root: int) -> list:
    result = []
    queue = np.array([root], dtype=np.intp)
    children, parents = tree["child"], tree["parent"]
    while len(queue) > 0:
        result.extend(queue.tolist())
        queue = children[np.isin(parents, queue)]
    return result


class _TreeUnionFind:
    """``_tree.pyx``'s ``TreeUnionFind``: union by rank, the parent's root
    kept on equal ranks; ``find`` compresses the path."""

    def __init__(self, size: int):
        self.parent = list(range(size))
        self.rank = [0] * size

    def union(self, x: int, y: int) -> None:
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1

    def find(self, x: int) -> int:
        path = []
        while self.parent[x] != x:
            path.append(x)
            x = self.parent[x]
        for p in path:
            self.parent[p] = x
        return x


def _do_labelling(condensed, clusters: set, label_map: dict,
                  allow_single_cluster: bool) -> np.ndarray:
    """``_tree.pyx``'s ``_do_labelling`` at ``cluster_selection_epsilon=0``."""
    child_array = condensed["child"]
    parent_array = condensed["parent"]
    lambda_array = condensed["value"]
    root_cluster = int(parent_array.min())
    result = np.empty(root_cluster, dtype=np.intp)
    uf = _TreeUnionFind(int(parent_array.max()) + 1)
    for child, parent in zip(child_array.tolist(), parent_array.tolist()):
        if child not in clusters:
            uf.union(parent, child)
    threshold = None
    for n in range(root_cluster):
        cluster = uf.find(n)
        label = NOISE
        if cluster != root_cluster:
            label = label_map[cluster]
        elif len(clusters) == 1 and allow_single_cluster:
            if threshold is None:
                threshold = lambda_array[parent_array == cluster].max()
            if lambda_array[child_array == n] >= threshold:
                label = label_map[cluster]
        result[n] = label
    return result


def get_clusters(condensed: np.ndarray, stability: dict,
                 allow_single_cluster: bool = False) -> np.ndarray:
    """``_tree.pyx``'s ``_get_clusters`` for the excess-of-mass selection
    without ``max_cluster_size`` or ``cluster_selection_epsilon``; returns
    the labels (``-1`` = noise), clusters numbered in node order."""
    node_list = sorted(stability.keys(), reverse=True)
    if not allow_single_cluster:
        node_list = node_list[:-1]
    tree = condensed[condensed["cluster_size"] > 1]
    is_cluster = {cluster: True for cluster in node_list}
    sizes = dict(zip(tree["child"].tolist(), tree["cluster_size"].tolist()))
    if allow_single_cluster:
        sizes[node_list[-1]] = np.sum(tree[tree["parent"] == node_list[-1]]["cluster_size"])
    n_samples = int(np.max(condensed[condensed["cluster_size"] == 1]["child"])) + 1
    max_cluster_size = n_samples + 1
    for node in node_list:
        children = tree["child"][tree["parent"] == node]
        subtree = np.sum([stability[child] for child in children.tolist()])
        if subtree > stability[node] or sizes[node] > max_cluster_size:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            for sub in _bfs_from_cluster_tree(tree, node):
                if sub != node:
                    is_cluster[sub] = False
    clusters = {c for c in is_cluster if is_cluster[c]}
    label_map = {c: n for n, c in enumerate(sorted(clusters))}
    return _do_labelling(condensed, clusters, label_map, allow_single_cluster)


def hdbscan(points: np.ndarray, min_cluster_size: int,
            allow_single_cluster: bool = False) -> np.ndarray:
    """sklearn 1.9's ``HDBSCAN(min_cluster_size=min_cluster_size,
    cluster_selection_method="eom", allow_single_cluster=...)
    .fit_predict(points)`` for finite euclidean points (cast to float64):
    labels ``0..k-1`` numbered as sklearn numbers them, ``-1`` noise."""
    x = np.ascontiguousarray(points, dtype=np.float64)
    if len(x) == 1:
        raise ValueError("n_samples=1 while HDBSCAN requires more than one sample")
    if min_cluster_size > len(x):
        raise ValueError(f"min_samples ({min_cluster_size}) must be at most the "
                         f"number of samples in X ({len(x)})")
    mst = prim_mst(x, core_distances(x, min_cluster_size))
    condensed = condense_tree(single_linkage(mst), min_cluster_size)
    labels = get_clusters(condensed, compute_stability(condensed), allow_single_cluster)
    return labels.astype(np.int64)


def connected_components(points: np.ndarray, eps: float) -> np.ndarray:
    """Components of the graph joining points at float64 distance ``<=
    eps``: the partition of ``DBSCAN(eps=eps, min_samples=1)``, numbered by
    ``scipy.sparse.csgraph``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as components
    from scipy.spatial import cKDTree

    x = np.asarray(points, np.float64)
    pairs = cKDTree(x).query_pairs(eps, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
                       shape=(len(x), len(x)))
    return components(graph, directed=False)[1].astype(np.int64)
