"""The two prior presets, ``seflowpp_trust`` and ``seflowpp_prior``, in the
port against the JAX package on the CPU.

Configuration: the presets at 64x64 (x/y range +-12.8 m, 0.4 m pillars),
UNet depths (16, 32), ``RefineConfig(num_query=256, num_ref=512)``, 512
points per sweep (the slice test's toy size). Weights are the JAX model's
own initialisation (with a zero prior, as the reference's ``init_params``
does), converted by ``flax_to_torch``, whose PFN first layer is 10 inputs
wide here; for ``seflowpp_trust`` two head biases are set on both sides
(dynamic logit -1.2, gate +0.1), as in the slice test.

The reference runs op by op (``model.apply`` outside ``jax.jit``). On
these scenes, a box among background clutter, XLA's fused program of the
same forward differs from the op-by-op run by up to 0.93 in the dynamic
logits (measured; on the slice test's scene the two agree within 3e-6);
the port agrees with the op-by-op run within 4e-6.

- The forward with a given prior (a fast box's true delta on part of the
  box, zero elsewhere): flow, gate logits and the dynamic logits within
  1e-4, the slot ids equal (the slice test's tolerance); on ``seflowpp_trust``
  the flow equals the prior on every covered valid point once the refine
  head is off (the trust override), in both packages.
- The registry estimators, which compute the host cluster prior per frame
  (``cluster_prior_flow``, bitwise equal to the reference's, both on
  scipy's KD-tree) on a scene whose box moves 2.5 m: the prior equal to
  the reference's, the flow within 1e-4 of the reference model's on it.
- The train step's loss terms with ``prior_feat`` (the stored prior fed to
  the PFN where it is valid): every term within 1e-5 relative of JAX's
  ``_frame_flow_and_loss`` per frame (float32 reductions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import himo_tpu.native
import himo_tpu_torch.native
from himo_tpu.data.synthetic import _sample_box_points
from himo_tpu.models import feedforward as JF
from himo_tpu.models import icp_flow as JI
from himo_tpu.models import nsfp as JN
from himo_tpu.training import trainer as JT
from himo_tpu_torch.data.synthetic import lidar_like_cloud
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.models.registry import get_estimator
from himo_tpu_torch.training import trainer as PT
from himo_tpu_torch.utils.convert import flax_to_torch

OVERRIDES = {
    "pillar.voxel_size": (0.4, 0.4),
    "pillar.x_range": (-12.8, 12.8),
    "pillar.y_range": (-12.8, 12.8),
    "depths": (16, 32),
    "refine.num_query": 256,
    "refine.num_ref": 512,
}
N = 512
B = 2
BOX = 120
SHIFT = np.array([2.5, 0.6, 0.0], np.float32)
ATOL = 1e-4
PRESETS = ("seflowpp_trust", "seflowpp_prior")


@pytest.fixture(autouse=True)
def reference_on_ckdtree(monkeypatch):
    monkeypatch.setattr(himo_tpu.native, "available", lambda: False)
    monkeypatch.setattr(himo_tpu_torch.native, "available", lambda: False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(name):
    jm, jcfg = JF.make_model(name, **OVERRIDES)
    zeros = tuple(jnp.zeros((N, 3), jnp.float32) for _ in range(3))
    ones = tuple(jnp.ones((N,), bool) for _ in range(3))
    params = jax.jit(lambda k: jm.init(k, zeros, ones, zeros[0]))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    if jcfg.instance_head:
        params["params"]["UNet_0"]["Conv_0"]["bias"][64] = -1.2  # dynamic logit
        params["params"]["DeFlowGRUDecoder_0"]["Dense_3"]["bias"][3] = 0.1  # gate
    model, cfg = PF.make_model(name, device="cpu", **OVERRIDES)
    model.load_state_dict(flax_to_torch(params, cfg))
    return jm, params, model.eval()


def _scene(seed=0):
    """Background clouds with a box moved by SHIFT between the sweeps (the
    box's last BOX points of each cloud), sweep times, and a prior: the
    box's delta on its first 60 points, zero elsewhere."""
    rng = np.random.default_rng(seed)
    bg = lidar_like_cloud(rng, B, N - BOX) * np.float32(0.25)
    box = np.stack([_sample_box_points(rng, BOX, np.array([4.0, 2.0, 1.5])) + [4.0, 3.0, 1.0]
                    for _ in range(B)]).astype(np.float32)
    pc0 = np.concatenate([bg, box], 1)
    pc1 = np.concatenate([bg + rng.normal(0, 0.01, bg.shape).astype(np.float32),
                          box + SHIFT], 1)
    pch = np.concatenate([bg + rng.normal(0, 0.01, bg.shape).astype(np.float32),
                          box - SHIFT], 1)
    valid = np.arange(N)[None].repeat(B, 0) < N - 8
    dt0 = rng.uniform(0, 0.1, (B, N)).astype(np.float32)
    prior = np.zeros((B, N, 3), np.float32)
    prior[:, N - BOX:N - BOX + 60] = SHIFT
    return pc0, pc1, pch, valid, dt0, prior


@pytest.mark.parametrize("name", PRESETS)
def test_prior_forward_matches_jax(name):
    jm, params, model = _params(name)
    assert model.pfn.dense0.in_features == 10
    pc0, pc1, pch, valid, dt0, prior = _scene()
    with torch.inference_mode():
        flow, aux = model((_t(pc0), _t(pc1), _t(pch)), (_t(valid),) * 3, _t(prior),
                          with_aux=True, dts=(_t(dt0), _t(dt0)))
        trusted = model((_t(pc0), _t(pc1), _t(pch)), (_t(valid),) * 3, _t(prior), refine=False)

    def apply(p, s, v, pr, d, r):
        return jm.apply(p, s, v, pr, with_aux=True, dts=(d, d), refine=r)

    covered = (np.abs(prior) > 1e-6).any(-1) & valid
    for b in range(B):
        sweeps = (jnp.asarray(pc0[b]), jnp.asarray(pc1[b]), jnp.asarray(pch[b]))
        valids = (jnp.asarray(valid[b]),) * 3
        jflow, jaux = apply(params, sweeps, valids, jnp.asarray(prior[b]),
                            jnp.asarray(dt0[b]), None)
        np.testing.assert_allclose(flow[b].numpy(), np.asarray(jflow), atol=ATOL)
        for key in jaux:
            if key == "slot":
                np.testing.assert_array_equal(aux[key][b].numpy(), np.asarray(jaux[key]))
            else:
                np.testing.assert_allclose(aux[key][b].numpy(), np.asarray(jaux[key]),
                                           atol=ATOL, err_msg=key)
        jtrusted, _ = apply(params, sweeps, valids, jnp.asarray(prior[b]),
                            jnp.asarray(dt0[b]), False)
        np.testing.assert_allclose(trusted[b].numpy(), np.asarray(jtrusted), atol=ATOL)
        if name == "seflowpp_trust":
            np.testing.assert_array_equal(trusted[b].numpy()[covered[b]], prior[b][covered[b]])
            np.testing.assert_array_equal(np.asarray(jtrusted)[covered[b]],
                                          prior[b][covered[b]])
    # The prior reaches the network: without it the flow differs.
    with torch.inference_mode():
        cold = model((_t(pc0), _t(pc1), _t(pch)), (_t(valid),) * 3, with_aux=True,
                     dts=(_t(dt0), _t(dt0)))[0]
    assert (cold - flow).abs().max() > 1e-3


@pytest.mark.parametrize("name", PRESETS)
def test_registry_estimator_computes_the_prior_like_jax(name):
    jm, params, model = _params(name)
    pc0, pc1, pch, valid, dt0, _ = _scene(1)
    est = get_estimator(name, params=model.state_dict(), device="cpu", **OVERRIDES)
    b = 0
    pose = np.eye(4)
    flow, zero = est(_t(pc0[b]), _t(pc1[b]), _t(valid[b]), _t(valid[b]),
                     history=(_t(pch[b]), _t(valid[b])), dt0=_t(dt0[b]), dt1=_t(dt0[b]),
                     scene_id="s0", pose1=_t(pose))
    # The reference estimator's prior: cluster_prior_flow at its keyword
    # defaults with a fresh tracker for the scene's first frame.
    tracker = JI.ClusterTracker()
    prior = np.asarray(JN.cluster_prior_flow(pc0[b], pc1[b], valid[b], valid[b], dt0=dt0[b],
                                             dt1=dt0[b], tracker=tracker, pose1=pose))
    assert (np.abs(prior[N - BOX:]).sum(-1) > 0).mean() > 0.5
    port_prior = PF.frame_priors(_t(pc0[b:b + 1]), _t(pc1[b:b + 1]), _t(valid[b:b + 1]),
                                 _t(valid[b:b + 1]), _t(dt0[b:b + 1]), _t(dt0[b:b + 1]))
    np.testing.assert_array_equal(port_prior[0].numpy(), prior)
    ref = jm.apply(params, (jnp.asarray(pc0[b]), jnp.asarray(pc1[b]), jnp.asarray(pch[b])),
                   (jnp.asarray(valid[b]),) * 3, jnp.asarray(prior),
                   dts=(jnp.asarray(dt0[b]), jnp.asarray(dt0[b])))
    assert flow.shape == (N, 3) and float(zero) == 0.0
    np.testing.assert_allclose(flow.numpy(), np.asarray(ref), atol=ATOL)
    assert set(est.trackers) == {"s0"}
    got, want = est.trackers["s0"].tracks, tracker.tracks
    assert len(got) == len(want) > 0
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a["delta_w"], w["delta_w"])


@pytest.mark.parametrize("name", PRESETS)
def test_train_step_feeds_the_stored_prior_like_jax(name):
    jm, params, model = _params(name)
    model.train()
    pc0, pc1, pch, valid, _, prior = _scene(2)
    rng = np.random.default_rng(3)
    k = 128
    batch = dict(
        pc0=pc0, pc1=pc1, pc_hist=pch, valid0=valid, valid1=valid.copy(),
        valid_hist=valid.copy(),
        dynamic0=rng.random((B, N)) < 0.2, dynamic1=rng.random((B, N)) < 0.2,
        cluster0=rng.integers(0, 8, (B, N)).astype(np.int32),
        prior0=prior + rng.normal(0, 0.05, prior.shape).astype(np.float32),
        prior_valid0=(np.abs(prior) > 0).any(-1) & (rng.random((B, N)) < 0.8),
        loss_idx0=rng.integers(0, N, (B, k)).astype(np.int32),
        loss_idx1=rng.integers(0, N, (B, k)).astype(np.int32),
    )
    cfg = dict(batch_size=B, num_points=N, loss_points=k)
    tb = {key: _t(v) for key, v in batch.items()}
    flow, losses = PT._frame_flow_and_loss(model, PT.TrainConfig(**cfg), tb)
    jcfg = JT.TrainConfig(**cfg)
    for b in range(B):
        frame = {key: jnp.asarray(v[b]) for key, v in batch.items()}
        _, jlosses = JT._frame_flow_and_loss(jm, jcfg, params, frame)
        assert set(jlosses) == set(losses)
        for key, value in jlosses.items():
            np.testing.assert_allclose(float(losses[key][b]), float(value), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    if name == "seflowpp_trust":
        # The stored prior is emitted on its valid points: nothing to learn.
        valid_prior = batch["prior_valid0"] & batch["valid0"]
        np.testing.assert_array_equal(flow.detach().numpy()[valid_prior],
                                      batch["prior0"][valid_prior])
    else:
        assert float(losses["prior_flow_loss"].max()) > 0
