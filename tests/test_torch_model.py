"""Port parity for the feed-forward network's building blocks, against flax
on the CPU, with the traps a plain PyTorch layer would get wrong:

- a stride-2 3x3 'SAME' conv pads (0, 1) on even sizes, not (1, 1);
- flax's GroupNorm on an un-batched (H, W, C) image keeps per-row
  statistics, with epsilon 1e-6 and float32 statistics;
- flax's GRUCell biases map to ``bias_ih = (b_ir, b_iz, b_in)`` and
  ``bias_hh = (0, 0, b_hn)``;
- the correlation volume zero-pads its borders (no wrap-around).

Weights are flax's, randomised (biases and norm scales too, so the mapping
of every tensor is exercised) and converted with ``flax_to_torch``'s
helpers. Tolerance 1e-5 (float32 on both sides; convolutions and matmuls
sum in another order)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from himo_tpu.models import feedforward as JF
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.utils import convert

ATOL = 1e-5


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, size=a.shape).astype(np.float32), tree
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.moveaxis(np.asarray(a), -1, -3))


def _nhwc(t):
    return t.movedim(-3, -1).detach().numpy()


@pytest.mark.parametrize("shape", [(8, 10), (7, 9)])
def test_convblock_stride2_same_padding(shape):
    h, w = shape
    x = np.random.default_rng(0).normal(size=(h, w, 6)).astype(np.float32)
    block = JF.ConvBlock(16, jnp.float32, stride=2)
    params = _randomize(block.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = np.asarray(block.apply(params, jnp.asarray(x)))
    sd = {}
    p = params["params"]
    convert._conv(sd, "conv0", p["Conv_0"])
    convert._conv(sd, "conv1", p["Conv_1"])
    convert._norm(sd, "norm0", p["GroupNorm_0"])
    convert._norm(sd, "norm1", p["GroupNorm_1"])
    port = PF.ConvBlock(6, 16, torch.float32, stride=2)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)[None])[0])
        assert got.shape == ref.shape == (-(-h // 2), -(-w // 2), 16)
        np.testing.assert_allclose(got, ref, atol=ATOL)
        if h % 2 == 0:
            # The symmetric padding a plain Conv2d(padding=1) would use differs.
            sym = F.conv2d(_nchw(x)[None], port.conv0.weight, port.conv0.bias,
                           stride=2, padding=1)
            asym = PF._conv_same(port.conv0, _nchw(x)[None], 2, torch.float32)
            assert not torch.allclose(sym, asym, atol=1e-3)


def test_groupnorm_per_row_stats_and_eps():
    rng = np.random.default_rng(2)
    # Rows with very different scales, and a near-constant row where the
    # epsilon dominates the variance.
    x = rng.normal(size=(6, 10, 16)).astype(np.float32)
    x *= np.array([1e-3, 0.1, 1.0, 10.0, 1.0, 1.0], np.float32)[:, None, None]
    norm = fnn.GroupNorm(num_groups=8)
    params = _randomize(norm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    ref = np.asarray(norm.apply(params, jnp.asarray(x)))
    port = PF.GroupNorm(8, 16)
    port.weight.data = _t(params["params"]["scale"])
    port.bias.data = _t(params["params"]["bias"])
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)[None], torch.float32)[0])
        np.testing.assert_allclose(got, ref, atol=ATOL)
        # torch's own GroupNorm (per-image stats, eps 1e-5) is another function.
        plain = F.group_norm(_nchw(x)[None], 8, port.weight, port.bias, eps=1e-5)
        assert not np.allclose(_nhwc(plain[0]), ref, atol=1e-2)


def test_gru_decoder_mapping():
    rng = np.random.default_rng(4)
    pillar = rng.normal(size=(50, 64)).astype(np.float32)
    point = rng.normal(size=(50, 32)).astype(np.float32)
    dec = JF.DeFlowGRUDecoder(64, 4, jnp.float32, gate=True)
    params = _randomize(
        dec.init(jax.random.PRNGKey(0), jnp.asarray(pillar), jnp.asarray(point)), 5
    )
    rflow, rgate = (np.asarray(a) for a in dec.apply(
        params, jnp.asarray(pillar), jnp.asarray(point)))
    p = params["params"]
    sd = {}
    for i, name in enumerate(("pillar_in", "point_in", "hidden", "out")):
        convert._dense(sd, name, p[f"Dense_{i}"])
    convert._gru(sd, "gru", p["GRUCell_0"])
    assert torch.equal(sd["gru.bias_hh"][:128], torch.zeros(128))
    port = PF.DeFlowGRUDecoder(64, 32, 64, 4, torch.float32, gate=True)
    port.load_state_dict(sd)
    with torch.no_grad():
        flow, gate = port(_t(pillar), _t(point))
    np.testing.assert_allclose(flow.numpy(), rflow, atol=ATOL)
    np.testing.assert_allclose(gate.numpy(), rgate, atol=ATOL)


def test_bev_correlation_pools_and_upsample():
    rng = np.random.default_rng(6)
    f0 = rng.normal(size=(12, 16, 8)).astype(np.float32)
    f1 = rng.normal(size=(12, 16, 8)).astype(np.float32)
    ref = np.asarray(JF._bev_correlation(jnp.asarray(f0), jnp.asarray(f1), 2))
    got = _nhwc(PF._bev_correlation(_nchw(f0)[None], _nchw(f1)[None], 2)[0])
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # Borders read zero: with all-ones images the (dy, dx) = (-2, -2) channel
    # (k = 0) is 1 inside and 0 on the first two rows / columns; no wrap.
    ones = torch.ones(1, 8, 12, 16)
    corner = PF._bev_correlation(ones, ones, 2)[0, 0]
    assert (corner[:2] == 0).all() and (corner[:, :2] == 0).all()
    assert (corner[2:, 2:] == 1).all()
    np.testing.assert_allclose(
        _nhwc(PF._avg_pool(_nchw(f0)[None], 4)[0]),
        np.asarray(JF._avg_pool(jnp.asarray(f0), 4)), atol=ATOL,
    )
    img = rng.normal(size=(3, 4, 2)).astype(np.float32)
    up = np.asarray(JF._upsample_nearest(jnp.asarray(img), 6, 12))
    np.testing.assert_array_equal(
        _nhwc(PF._upsample_nearest(_nchw(img), 6, 12)), up
    )


def test_init_params_follows_flax_initialisers():
    model, _ = PF.make_model("seflowpp", device="cpu", depths=(16, 32))
    sd = PF.init_params(model, torch.Generator().manual_seed(0))
    again = PF.init_params(
        PF.make_model("seflowpp", device="cpu", depths=(16, 32))[0], torch.Generator().manual_seed(0)
    )
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    w = sd["unet.down.0.conv0.weight"]  # fan_in = 96 * 9
    std = np.sqrt(1.0 / (96 * 9))
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    hh = sd["decoder.gru.weight_hh"]
    for blk in hh.chunk(3, dim=0):
        torch.testing.assert_close(blk @ blk.T, torch.eye(64), atol=1e-5, rtol=0)
    assert all(float(sd[k].abs().max()) == 0 for k in sd if k.endswith("bias") or "bias_" in k)
    assert torch.equal(sd["unet.down.0.norm0.weight"], torch.ones(16))


def test_config_dataclasses_copy_the_reference():
    import dataclasses

    from himo_tpu.ops import refine as JR
    from himo_tpu.ops import voxelize as JV
    from himo_tpu_torch.ops import refine as PR
    from himo_tpu_torch.ops import voxelize as PV

    for jcls, pcls in ((JV.PillarConfig, PV.PillarConfig),
                       (JR.RefineConfig, PR.RefineConfig),
                       (JF.FlowNetConfig, PF.FlowNetConfig)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        pf = [(f.name, f.default) for f in dataclasses.fields(pcls)]
        assert [n for n, _ in jf] == [n for n, _ in pf]
        for (name, jd), (_, pd) in zip(jf, pf):
            if dataclasses.is_dataclass(jd):
                assert dataclasses.asdict(jd) == dataclasses.asdict(pd), name
            else:
                assert jd == pd, name
    assert PV.PillarConfig().grid_shape == JV.PillarConfig().grid_shape == (512, 512)


def test_make_model_presets_and_unported_options():
    for name in ("fastflow3d", "deflow", "deflowpp", "seflow", "seflowpp",
                 "seflowpp_noprior"):
        model, cfg = PF.make_model(name, device="cpu", depths=(16,))
        assert cfg.depths == (16,) and isinstance(model, PF.SceneFlowNet)
    for name in ("seflowpp_trust", "seflowpp_prior"):
        # The prior presets are ported: 3 more PFN inputs (the prior).
        model, cfg = PF.make_model(name, device="cpu", depths=(16,))
        assert cfg.prior_feat and model.pfn.dense0.in_features == 10
    model, cfg = PF.make_model("seflowpp", device="cpu", depths=(16,), pooling="mean_sorted")
    assert cfg.pooling == "mean_sorted" and isinstance(model, PF.SceneFlowNet)
    with pytest.raises(KeyError):
        PF.make_model("nope")


TOY = {
    "pillar.voxel_size": (0.4, 0.4),
    "pillar.x_range": (-12.8, 12.8),
    "pillar.y_range": (-12.8, 12.8),
    "depths": (16, 32),
}


@pytest.mark.parametrize("preset", ["fastflow3d", "seflowpp_noprior"])
def test_pointwise_presets_match_jax(preset):
    """Whole networks without the instance/refine heads, flax weights
    converted with ``flax_to_torch``: gate logits within 1e-4, flow within
    1e-4 on every point whose gate decision cannot differ — its logit is
    more than 1e-3 from the cut, or bitwise equal on both sides (points
    outside the grid have all-zero decoder inputs and read exactly 0)."""
    jm, jcfg = JF.make_model(preset, **TOY)
    n = 400
    k = jcfg.num_frames
    zeros = tuple(jnp.zeros((n, 3), jnp.float32) for _ in range(k))
    ones = tuple(jnp.ones((n,), bool) for _ in range(k))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), zeros, ones)
    rng = np.random.default_rng(7)
    clouds = [rng.uniform(-13, 13, size=(n, 3)).astype(np.float32) for _ in range(k)]
    for c in clouds:
        c[:, 2] = rng.uniform(-3.5, 3.5, n)
    valid = rng.uniform(size=n) > 0.08
    sweeps = tuple(jnp.asarray(c) for c in clouds)
    if jcfg.gate_head:
        rflow, rgate = jm.apply(params, sweeps, (jnp.asarray(valid),) * k, with_gate=True)
    else:
        rflow, rgate = jm.apply(params, sweeps, (jnp.asarray(valid),) * k), None
    model, cfg = PF.make_model(preset, device="cpu", **TOY)
    model.load_state_dict(convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, params), cfg))
    with torch.inference_mode():
        out = model(tuple(_t(c)[None] for c in clouds), (_t(valid)[None],) * k,
                    with_gate=jcfg.gate_head)
    flow = out[0][0].numpy() if jcfg.gate_head else out[0].numpy()
    keep = np.ones(n, bool)
    if rgate is not None:
        gate = out[1][0].numpy()
        np.testing.assert_allclose(gate, np.asarray(rgate), atol=1e-4)
        rgate = np.asarray(rgate)
        keep = (np.abs(rgate) > 1e-3) | (gate == rgate)
        assert keep.mean() > 0.99 and (np.abs(rgate) > 1e-3).mean() > 0.5
    np.testing.assert_allclose(flow[keep], np.asarray(rflow)[keep], atol=1e-4)


def test_bfloat16_forward_runs_with_fp32_outputs():
    model, _ = PF.make_model("seflowpp", device="cpu", dtype="bfloat16", **TOY,
                             **{"refine.num_query": 64, "refine.num_ref": 128})
    PF.init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    pcs = [_t(rng.uniform(-12, 12, size=(2, 300, 3)).astype(np.float32)) for _ in range(3)]
    valid = torch.ones(2, 300, dtype=torch.bool)
    dt0 = _t(rng.uniform(0, 0.1, size=(2, 300)).astype(np.float32))
    flow, comp_dis, refined = PF.frame(model, pcs[0], pcs[1], pcs[2], valid, dt0)
    assert flow.dtype == comp_dis.dtype == refined.dtype == torch.float32
    assert flow.shape == refined.shape == (2, 300, 3)
    assert torch.isfinite(refined).all()
    torch.testing.assert_close(refined, pcs[0] + flow * (dt0 / 0.1)[..., None])
    # Parameters stay float32 under the bf16 compute policy.
    assert all(p.dtype == torch.float32 for p in model.parameters())
