"""Seeded traffic for the benchmark's cells, in numpy.

``lidar_frame``, ``lidar_like_cloud`` and ``train_batch`` are frozen
copies of the generators of ``himo_tpu_torch/data/synthetic.py`` (the
harness takes nothing but the system under test from the program), with
the number of object clusters as a parameter. ``make_item`` reads a
cell's traffic file and builds one item of it; every seed gets the same
sizes, so the work per item is fixed and only the scene differs.
"""

from __future__ import annotations

import numpy as np

SWEEP_S = 0.1  # 10 Hz sensors


def lidar_frame(rng: np.random.Generator, n: int, objects: int = 16):
    """One LiDAR-like frame of ``n`` points: a ground disc with a
    sqrt-uniform radius, annulus structure with vertical extent, and
    ``objects`` dense clusters (10 % of the points). Returns the (n, 3)
    float32 points and each point's cluster (-1 for ground and structure)."""
    n_ground = int(n * 0.45)
    n_struct = int(n * 0.45)
    n_obj = n - n_ground - n_struct
    r = 50.0 * np.sqrt(rng.uniform(0.004, 1.0, n_ground))
    a = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(a), r * np.sin(a), rng.normal(-1.6, 0.05, n_ground)], 1)
    r = 50.0 * np.sqrt(rng.uniform(0.01, 1.0, n_struct))
    a = rng.uniform(0, 2 * np.pi, n_struct)
    struct = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-1.5, 2.5, n_struct)], 1)
    centers = rng.uniform(-45, 45, size=(objects, 3))
    centers[:, 2] = rng.uniform(-1.0, 0.5, objects)
    idx = rng.integers(0, objects, n_obj)
    obj = centers[idx] + rng.normal(0, [1.8, 0.9, 0.6], (n_obj, 3))
    points = np.concatenate([ground, struct, obj]).astype(np.float32)
    return points, np.concatenate([np.full(n - n_obj, -1), idx]).astype(np.int32)


def lidar_like_cloud(rng: np.random.Generator, batch: int, n: int) -> np.ndarray:
    """(batch, n, 3) float32 clouds of :func:`lidar_frame`."""
    return np.stack([lidar_frame(rng, n)[0] for _ in range(batch)])


def object_steps(rng: np.random.Generator, objects: int, speed_mps, period_s: float):
    """(objects, 3) float32 displacements over ``period_s``: each cluster
    moves at a speed uniform in ``speed_mps`` = (low, high) in its own
    random horizontal direction."""
    speed = rng.uniform(speed_mps[0], speed_mps[1], objects)
    heading = rng.uniform(0, 2 * np.pi, objects)
    step = speed[:, None] * period_s * np.stack(
        [np.cos(heading), np.sin(heading), np.zeros_like(heading)], 1)
    return step.astype(np.float32)


def train_batch(rng: np.random.Generator, batch: int, num_points: int,
                loss_points: int) -> dict:
    """An SSL train batch: three :func:`lidar_like_cloud` sweeps with every
    point valid, 2 % SSL-dynamic points on both sides, cluster ids in
    [0, 8), translation priors on 2 % of the points, and uniform chamfer
    samples of ``loss_points`` rows."""
    b, n, k = batch, num_points, loss_points
    return {
        "pc0": lidar_like_cloud(rng, b, n), "pc1": lidar_like_cloud(rng, b, n),
        "pc_hist": lidar_like_cloud(rng, b, n),
        "valid0": np.ones((b, n), bool), "valid1": np.ones((b, n), bool),
        "valid_hist": np.ones((b, n), bool),
        "dynamic0": rng.random((b, n)) < 0.02,
        "dynamic1": rng.random((b, n)) < 0.02,
        "cluster0": rng.integers(0, 8, (b, n)).astype(np.int32),
        "prior0": rng.normal(0, 0.1, (b, n, 3)).astype(np.float32),
        "prior_valid0": rng.random((b, n)) < 0.02,
        "loss_idx0": rng.integers(0, n, (b, k)).astype(np.int32),
        "loss_idx1": rng.integers(0, n, (b, k)).astype(np.int32),
    }


def sweep_triplet(rng: np.random.Generator, n: int, objects: int, speed_mps,
                  valid_fraction: float):
    """Three sweeps of one scene for the feed-forward net: pc0 a shuffled
    :func:`lidar_frame`, pc1 one sweep later and the history sweep one
    sweep earlier, each object cluster moved at its own speed; the first
    ``valid_fraction`` of the (shuffled) points valid; ``dt0`` each point's
    time to the sweep's end, uniform in [0, 0.1) s."""
    pc0, obj = lidar_frame(rng, n, objects)
    order = rng.permutation(n)
    pc0, obj = pc0[order], obj[order]
    step = object_steps(rng, objects, speed_mps, SWEEP_S)
    move = np.where((obj >= 0)[:, None], step[np.maximum(obj, 0)], 0.0).astype(np.float32)
    valid = np.arange(n) < int(n * valid_fraction)
    dt0 = rng.uniform(0.0, SWEEP_S, n).astype(np.float32)
    return pc0, pc0 + move, pc0 - move, valid, dt0


def make_item(traffic: dict, rng: np.random.Generator) -> dict:
    """One item of a cell's traffic (numpy arrays), from its traffic file's
    parameters: ``infer`` a batch of sweep triplets, ``train`` one SSL
    train batch."""
    kind = traffic["kind"]
    n, objects = traffic["points"], traffic.get("objects", 16)
    if kind == "infer":
        frames = [sweep_triplet(rng, n, objects, traffic["speed_mps"],
                                traffic["valid_fraction"]) for _ in range(traffic["batch"])]
        keys = ("pc0", "pc1", "pc_hist", "valid", "dt0")
        return {k: np.stack([f[i] for f in frames]) for i, k in enumerate(keys)}
    if kind == "train":
        return train_batch(rng, traffic["batch"], n, traffic["loss_points"])
    raise ValueError(f"unknown traffic kind {kind!r}")
