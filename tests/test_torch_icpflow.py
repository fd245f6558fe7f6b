"""The port's ICP-Flow (``himo_tpu_torch/models/icp_flow.py``) against the
JAX package's on the CPU.

The JAX side runs with x64 off (``with jax.enable_x64(False)``):
``tests/conftest.py`` turns x64 on, and ``icp_register_clusters``' scan carry then fails
in the reference (its own ``tests/test_icpflow.py`` fails for that reason).
Both sides take scipy's KD-tree for the host clustering (both packages'
native trees are switched off for the test). Clouds are float32.

Tolerances: ``weighted_kabsch`` rotation and translation within 1e-5;
``icp_register_clusters`` and ``icpflow_estimate`` flow within 1e-4 m. The
two sides run the same float32 arithmetic, but the 3x3 SVDs come from
different LAPACK builds and the plain nearest-neighbour search rounds the
``|q|^2 + |r|^2 - 2 q.r`` form in another order; twelve iterations carry
those last-bit differences into the transforms. The host clustering and
matching before the registration are bitwise (``test_torch_ssl_labels``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import himo_tpu.native
import himo_tpu_torch.native
from himo_tpu.data.synthetic import _sample_box_points
from himo_tpu.models import icp_flow as JI
from himo_tpu_torch.models import icp_flow as PI
from himo_tpu_torch.models.registry import get_estimator

ATOL_KABSCH = 1e-5
ATOL_FLOW = 1e-4


@pytest.fixture(autouse=True)
def reference_on_ckdtree(monkeypatch):
    monkeypatch.setattr(himo_tpu.native, "available", lambda: False)
    monkeypatch.setattr(himo_tpu_torch.native, "available", lambda: False)


def _box_pair(seed, n_box=150, size=(4.5, 2.0, 1.6), shift=(1.2, -0.4, 0.0), yaw=0.0,
              n_static=500):
    rng = np.random.default_rng(seed)
    static = rng.uniform(-12, 0, size=(n_static, 3)).astype(np.float32)
    box = _sample_box_points(rng, n_box, np.array(size))
    blob0 = (box + [6, 3, 1]).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    centre = blob0.mean(0)
    blob1 = ((blob0 - centre) @ rot.T + centre + np.asarray(shift, np.float32)).astype(np.float32)
    pc0 = np.concatenate([static, blob0])
    pc1 = np.concatenate([static, blob1])
    return pc0, pc1, np.ones(len(pc0), bool), n_static


def test_weighted_kabsch_matches_jax():
    rng = np.random.default_rng(0)
    c, k = 6, 50
    src = rng.normal(size=(c, k, 3)).astype(np.float32)
    dst = np.empty_like(src)
    for i in range(c):
        a = rng.uniform(-0.5, 0.5)
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        dst[i] = src[i] @ rot.T + rng.normal(size=3) + rng.normal(0, 0.01, (k, 3))
    w = (rng.uniform(size=(c, k)) > 0.3).astype(np.float32)
    w[4] = 0.0  # degenerate: identity
    w[5, 2:] = 0.0  # two correspondences: identity
    rot, t = PI.weighted_kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    with jax.enable_x64(False):
        jrot, jt = jax.vmap(JI.weighted_kabsch)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=ATOL_KABSCH)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=ATOL_KABSCH)
    np.testing.assert_array_equal(rot[4].numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t[5].numpy(), np.zeros(3, np.float32))


def test_icp_register_clusters_matches_jax():
    rng = np.random.default_rng(1)
    config = JI.ICPFlowConfig(max_clusters=4, cluster_capacity=128)
    pconfig = PI.ICPFlowConfig(max_clusters=4, cluster_capacity=128)
    clusters = np.zeros((4, 128, 3), np.float32)
    valid = np.zeros((4, 128), bool)
    pc1 = [rng.uniform(-20, 20, (300, 3))]
    for i, n in enumerate((128, 90, 40)):
        box = _sample_box_points(rng, n, np.array([4.0, 2.0, 1.5])) + rng.uniform(-15, 15, 3)
        clusters[i, :n] = box
        valid[i, :n] = True
        pc1.append(box + [1.0 + i, -0.5, 0.0])
    pc1 = np.concatenate(pc1).astype(np.float32)
    valid1 = rng.uniform(size=len(pc1)) > 0.05
    init_t = np.zeros((4, 3), np.float32)
    init_t[2] = (2.5, -0.5, 0.0)
    flow, rot, t = PI.icp_register_clusters(
        torch.from_numpy(clusters), torch.from_numpy(valid), torch.from_numpy(pc1),
        torch.from_numpy(valid1), pconfig, torch.from_numpy(init_t))
    with jax.enable_x64(False):
        jflow, jrot, jt = JI.icp_register_clusters(
            jnp.asarray(clusters), jnp.asarray(valid), jnp.asarray(pc1), jnp.asarray(valid1),
            config, jnp.asarray(init_t))
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=ATOL_FLOW)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=ATOL_FLOW)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=ATOL_FLOW)
    assert (flow.numpy()[~valid] == 0).all()
    np.testing.assert_allclose(np.asarray(jflow)[2, :40].mean(0), [3.0, -0.5, 0.0], atol=0.05)


@pytest.mark.parametrize("case", ["moving_box", "fast_box", "overflow", "turning", "static"])
def test_icpflow_estimate_matches_jax(case):
    cfg = dict(max_clusters=8, cluster_capacity=256, icp_iters=12, dbscan_eps=1.2)
    if case == "moving_box":
        pc0, pc1, valid, n_static = _box_pair(0)
    elif case == "fast_box":
        pc0, pc1, valid, n_static = _box_pair(2, shift=(3.4, 0.4, 0.0))
    elif case == "overflow":
        pc0, pc1, valid, n_static = _box_pair(3, n_box=600, size=(6.5, 2.4, 2.4),
                                              shift=(1.1, -0.5, 0.0), n_static=400)
    elif case == "turning":
        pc0, pc1, valid, n_static = _box_pair(4, shift=(1.5, 0.3, 0.0), yaw=0.08)
    else:
        pc0 = np.random.default_rng(5).uniform(-10, 10, (300, 3)).astype(np.float32)
        pc1, valid, n_static = pc0, np.ones(300, bool), 300
    flow, loss = PI.icpflow_estimate(pc0, pc1, valid, valid, PI.ICPFlowConfig(**cfg),
                                     device="cpu")
    with jax.enable_x64(False):
        jflow, jloss = JI.icpflow_estimate(pc0, pc1, valid, valid, JI.ICPFlowConfig(**cfg))
    assert isinstance(flow, torch.Tensor) and flow.dtype == torch.float32
    assert loss == jloss == 0.0
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=ATOL_FLOW)
    covered = np.linalg.norm(np.asarray(jflow)[n_static:], axis=1) > 1e-6
    if case == "static":
        assert not covered.any()
    else:
        assert covered.mean() > 0.5
    if case == "overflow":
        assert covered.sum() > cfg["cluster_capacity"] + 40


def test_icpflow_registry_estimator_keeps_a_tracker_per_scene():
    pc0, pc1, valid, n_static = _box_pair(6, shift=(2.0, 0.0, 0.0))
    cfg = dict(max_clusters=8, cluster_capacity=256, dbscan_eps=1.2)
    est = get_estimator("icpflow", device="cpu", **cfg)
    with jax.enable_x64(False):
        jest = JI.make_icpflow(**cfg)
        pose = np.eye(4)
        for _ in range(2):
            flow, loss = est(torch.from_numpy(pc0), torch.from_numpy(pc1), torch.from_numpy(valid),
                             torch.from_numpy(valid), scene_id="s0", pose1=torch.from_numpy(pose))
            jflow, _ = jest(pc0, pc1, valid, valid, scene_id="s0", pose1=pose)
            np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=ATOL_FLOW)
    assert float(loss) == 0.0 and flow.shape == (len(pc0), 3)
    assert set(est.trackers) == {"s0"}
    got, want = est.trackers["s0"].tracks, jest.trackers["s0"].tracks
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["hits"] == b["hits"]
        np.testing.assert_array_equal(a["pos_w"], b["pos_w"])


def test_new_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc0, pc1, valid, _ = _box_pair(7, shift=(2.0, 0.0, 0.0))
    for name in ("icpflow", "nsfp", "fastnsf"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_estimator(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PI.icpflow_estimate(pc0, pc1, valid, valid, PI.ICPFlowConfig(max_clusters=8))
    flow, _ = PI.icpflow_estimate(pc0, pc1, valid, valid, PI.ICPFlowConfig(max_clusters=8),
                                  device="cpu")
    assert flow.device.type == "cpu"
