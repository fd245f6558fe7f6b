"""LiDAR-like synthetic clouds and train batches for benchmark-shaped runs.

``lidar_like_cloud`` is the generator ``bench.py`` uses for the JAX headline,
copied so that the port and ``chip_smoke.py`` need neither ``bench.py`` nor
JAX; for the same numpy generator state it returns identical arrays.
``train_batch`` builds the batch ``scripts/chip_train_ab.py`` times the JAX
train step on.
"""

from __future__ import annotations

import numpy as np


def lidar_like_cloud(rng: np.random.Generator, batch: int, n: int) -> np.ndarray:
    """(batch, n, 3) float32 clouds: a ground disc with sqrt-uniform radius
    (denser near the sensor), annulus structure with vertical extent, and 16
    dense object clusters per frame."""
    out = np.empty((batch, n, 3), np.float32)
    for b in range(batch):
        n_ground = int(n * 0.45)
        n_struct = int(n * 0.45)
        n_obj = n - n_ground - n_struct
        r = 50.0 * np.sqrt(rng.uniform(0.004, 1.0, n_ground))
        a = rng.uniform(0, 2 * np.pi, n_ground)
        ground = np.stack(
            [r * np.cos(a), r * np.sin(a), rng.normal(-1.6, 0.05, n_ground)], 1
        )
        r = 50.0 * np.sqrt(rng.uniform(0.01, 1.0, n_struct))
        a = rng.uniform(0, 2 * np.pi, n_struct)
        struct = np.stack(
            [r * np.cos(a), r * np.sin(a), rng.uniform(-1.5, 2.5, n_struct)], 1
        )
        centers = rng.uniform(-45, 45, size=(16, 3))
        centers[:, 2] = rng.uniform(-1.0, 0.5, 16)
        idx = rng.integers(0, 16, n_obj)
        obj = centers[idx] + rng.normal(0, [1.8, 0.9, 0.6], (n_obj, 3))
        out[b] = np.concatenate([ground, struct, obj]).astype(np.float32)
    return out


def train_batch(
    rng: np.random.Generator, batch: int, num_points: int, loss_points: int,
    with_gt: bool = False,
) -> dict:
    """The SSL train batch of ``scripts/chip_train_ab.py`` as numpy arrays:
    three ``lidar_like_cloud`` sweeps with every point valid, 2 % SSL-dynamic
    points on both sides, cluster ids in [0, 8), translation priors on 2 %
    of the points, and uniform chamfer samples of ``loss_points`` rows.
    ``with_gt`` adds a ground-truth residual flow and its mask for the
    validation step."""
    b, n, k = batch, num_points, loss_points
    out = {
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
    if with_gt:
        out["gt_flow"] = rng.normal(0, 0.1, (b, n, 3)).astype(np.float32)
        out["gt_valid"] = rng.random((b, n)) < 0.9
    return out
