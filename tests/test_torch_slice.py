"""The whole slice — ``seflowpp`` inference + de-skew — in the port against
the JAX package on the CPU.

Configuration: the ``seflowpp`` preset at 64x64 (x/y range +-12.8 m, 0.4 m
pillars), UNet depths (16, 32), ``RefineConfig(num_query=256,
num_ref=512)``, 512 points per sweep, two frames batched in the port and
run one by one through JAX. Weights are the JAX model's own initialisation
(``init_params``' call, under ``jit``) converted by ``flax_to_torch``; two
head biases are then set on both sides (dynamic logit -1.2, gate +0.1) so
that random weights open some gates and form several components, and the
refine head verifies real slot translations — the scene's second sweep is
the first shifted by (0.6, -0.2, 0) m.

Tolerances: gate logits and ``dyn_logit`` within 1e-4. Discrete outcomes
(gate, coarse occupancy, slot) must agree exactly wherever the deciding
value lies more than 1e-3 from its threshold. Where a decision within that
margin does differ, the points downstream of it (the point and its slot
for a gate, every member of the frame for an occupancy cell) are left
out, and they must be fewer than 1%; slots are compared exactly on the
rest. ``flow``, ``comp_dis`` and ``refined`` within 1e-4 on the
remaining points; a refine-confidence flip would move a whole slot by far
more than that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.core.compensation import flow_to_comp_dis, refine_points
from himo_tpu.models import feedforward as JF
from himo_tpu.models.registry import get_estimator as jax_get_estimator
from himo_tpu_torch.data.synthetic import lidar_like_cloud
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.models.registry import available_estimators, get_estimator
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
SHIFT = np.array([0.6, -0.2, 0.0], np.float32)
MARGIN = 1e-3
ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_setup():
    jm, jcfg = JF.make_model("seflowpp", **OVERRIDES)
    sweeps = tuple(jnp.zeros((N, 3)) for _ in range(3))
    valids = tuple(jnp.ones((N,), bool) for _ in range(3))
    params = jax.jit(lambda k: jm.init(k, sweeps, valids, None))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["UNet_0"]["Conv_0"]["bias"][64] = -1.2  # dynamic logit
    params["params"]["DeFlowGRUDecoder_0"]["Dense_3"]["bias"][3] = 0.1  # gate
    rng = np.random.default_rng(0)
    pc0 = lidar_like_cloud(rng, B, N) * np.float32(0.25)
    pc1 = pc0 + SHIFT + rng.normal(0, 0.02, pc0.shape).astype(np.float32)
    pch = pc0 - SHIFT
    valid = np.arange(N)[None].repeat(B, 0) < int(N * 0.92)
    dt0 = rng.uniform(0, 0.1, (B, N)).astype(np.float32)
    apply = jax.jit(
        lambda p, s, v, d: jm.apply(p, s, v, with_aux=True, dts=(d, d))
    )
    ref = []
    for b in range(B):
        flow, aux = apply(
            params, (jnp.asarray(pc0[b]), jnp.asarray(pc1[b]), jnp.asarray(pch[b])),
            (jnp.asarray(valid[b]),) * 3, jnp.asarray(dt0[b]),
        )
        comp = flow_to_comp_dis(flow, jnp.asarray(dt0[b]))
        ref.append(dict(
            flow=np.asarray(flow), comp_dis=np.asarray(comp),
            refined=np.asarray(refine_points(jnp.asarray(pc0[b]), comp)),
            **{k: np.asarray(v) for k, v in aux.items()},
        ))
    model, cfg = PF.make_model("seflowpp", device="cpu", **OVERRIDES)
    model.load_state_dict(flax_to_torch(params, cfg))
    return dict(params=params, model=model, pc0=pc0, pc1=pc1, pch=pch,
                valid=valid, dt0=dt0, ref=ref)


def _coarse_occupancy(dyn_logit, stride=2):
    h, w = dyn_logit.shape
    return dyn_logit.reshape(h // stride, stride, w // stride, stride).max((1, 3))


def test_slice_matches_jax(slice_setup):
    s = slice_setup
    t = torch.from_numpy
    with torch.inference_mode():
        flow, aux = s["model"](
            (t(s["pc0"]), t(s["pc1"]), t(s["pch"])), (t(s["valid"]),) * 3,
            with_aux=True, dts=(t(s["dt0"]), t(s["dt0"])),
        )
        _, comp_dis, refined = PF.frame(
            s["model"], t(s["pc0"]), t(s["pc1"]), t(s["pch"]), t(s["valid"]),
            t(s["dt0"]),
        )
    excluded = 0
    for b, ref in enumerate(s["ref"]):
        gate, dyn = aux["gate_logit"][b].numpy(), aux["dyn_logit"][b].numpy()
        np.testing.assert_allclose(gate, ref["gate_logit"], atol=ATOL)
        np.testing.assert_allclose(dyn, ref["dyn_logit"], atol=ATOL)

        # A decision may differ only where the reference's deciding value
        # is within MARGIN of its threshold; where one does, everything
        # downstream of it is left out.
        slot, rslot = aux["slot"][b].numpy(), ref["slot"]
        out = np.zeros(N, bool)
        occ, rocc = _coarse_occupancy(dyn), _coarse_occupancy(ref["dyn_logit"])
        flip = (occ > 0) != (rocc > 0)
        assert not flip[np.abs(rocc) > MARGIN].any()
        if flip.any():
            out |= (slot >= 0) | (rslot >= 0)
        flip = (gate > 0) != (ref["gate_logit"] > 0)
        assert not flip[np.abs(ref["gate_logit"]) > MARGIN].any()
        for sl in np.unique(rslot[flip]):
            if sl >= 0:
                out |= rslot == sl
        out |= flip
        keep = ~out
        excluded += out.sum()
        np.testing.assert_array_equal(slot[keep], rslot[keep])
        for name, got in (("flow", flow), ("comp_dis", comp_dis), ("refined", refined)):
            np.testing.assert_allclose(
                got[b].numpy()[keep], ref[name][keep], atol=ATOL, err_msg=name
            )
        # The scene exercises the heads: open gates, several slots, and
        # slot translations the refine head verified as the true shift.
        assert (gate > 0).mean() > 0.05 and np.unique(rslot[rslot >= 0]).size >= 2
        assert (np.abs(ref["flow"] - SHIFT).max(1) < 0.05).mean() > 0.2
    assert excluded < 0.01 * B * N
    assert flow.shape == comp_dis.shape == refined.shape == (B, N, 3)
    assert torch.isfinite(refined).all()


def test_registry_estimator_matches_jax(slice_setup, tmp_path):
    s = slice_setup
    assert "seflowpp" in available_estimators()
    state = s["model"].state_dict()
    ckpt = tmp_path / "seflowpp.pt"
    torch.save(state, ckpt)
    jest = jax_get_estimator("seflowpp", params=s["params"], **OVERRIDES)
    for est in (
        get_estimator("seflowpp", params=state, device="cpu", **OVERRIDES),
        get_estimator("seflowpp", checkpoint=str(ckpt), device="cpu", **OVERRIDES),
    ):
        assert est.num_frames == 3
        b = 1
        args = [torch.from_numpy(s[k][b]) for k in ("pc0", "pc1", "valid", "valid")]
        flow, zero = est(
            *args, history=(torch.from_numpy(s["pch"][b]), args[2]),
            dt0=torch.from_numpy(s["dt0"][b]), dt1=torch.from_numpy(s["dt0"][b]),
        )
        ref, _ = jest(
            *(jnp.asarray(s[k][b]) for k in ("pc0", "pc1", "valid", "valid")),
            history=(jnp.asarray(s["pch"][b]), jnp.asarray(s["valid"][b])),
            dt0=s["dt0"][b], dt1=s["dt0"][b],
        )
        assert flow.shape == (N, 3) and float(zero) == 0.0
        np.testing.assert_allclose(flow.numpy(), np.asarray(ref), atol=ATOL)
    with pytest.raises(ValueError):
        get_estimator("seflowpp", device="cpu", **OVERRIDES)
