"""Port parity for the per-slot refinement (ops/refine.py) against the JAX
package on the CPU, on constructed rolling-shutter moving-box scenes.

Tolerances: per-slot translations within 1e-4 m (the NN passes agree
exactly, the per-slot sums are fp32 one-hot matmuls summed in another
order); ``conf`` and ``snapped`` exact; masks and selections exact; the
whole refine head within 1e-4 m plus the reference's own measured
sensitivity to a one-ulp nudge of its input (see that test). Two scenes
run as one batch of two frames, so the batched port is checked against
the per-frame reference."""

import jax.numpy as jnp
import numpy as np
import torch

from himo_tpu.ops import refine as JR
from himo_tpu_torch.ops import refine as PR

SWEEP_DT = 0.1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _box_points(rng, n, center, size=(4.5, 2.0, 1.6)):
    """Surface-sampled box shell (the synthetic generator's object model)."""
    size = np.asarray(size)
    pts = rng.uniform(-0.5, 0.5, size=(n, 3)) * size
    ax = rng.integers(0, 3, size=n)
    sign = rng.choice([-1.0, 1.0], size=n)
    pts[np.arange(n), ax] = 0.5 * size[ax] * sign
    return (center + pts).astype(np.float32)


def _two_cluster_scene(rng, v0, v1, n_obj=300, n_bg=2000):
    """pc0/pc1 with two rigid movers (m/s), rolling-shutter smeared
    (pos = base + local + v*dt), plus static background. Returns
    (p0, dt0, p1, dt1, slot)."""
    c0 = np.array([8.0, 3.0, 1.0])
    c1 = np.array([-6.0, -5.0, 1.0])
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    dt0 = rng.uniform(0.0, SWEEP_DT, size=2 * n_obj + n_bg).astype(np.float32)
    dt1 = rng.uniform(0.0, SWEEP_DT, size=2 * n_obj + n_bg).astype(np.float32)
    o0a = _box_points(rng, n_obj, c0) + v0 * dt0[:n_obj, None]
    o0b = _box_points(rng, n_obj, c1) + v1 * dt0[n_obj : 2 * n_obj, None]
    o1a = _box_points(rng, n_obj, c0) + v0 * SWEEP_DT + v0 * dt1[:n_obj, None]
    o1b = (
        _box_points(rng, n_obj, c1) + v1 * SWEEP_DT + v1 * dt1[n_obj : 2 * n_obj, None]
    )
    bg0 = rng.uniform(-30, 30, size=(n_bg, 3))
    bg1 = rng.uniform(-30, 30, size=(n_bg, 3))
    p0 = np.concatenate([o0a, o0b, bg0]).astype(np.float32)
    p1 = np.concatenate([o1a, o1b, bg1]).astype(np.float32)
    slot = np.full(len(p0), -1, np.int32)
    slot[:n_obj] = 0
    slot[n_obj : 2 * n_obj] = 1
    return p0, dt0, p1, dt1, slot


def test_select_topk_matches_jax():
    rng = np.random.default_rng(0)
    mask = rng.uniform(size=(2, 300)) > 0.6
    idx, valid = PR.select_topk(_t(mask), 150)
    for b in range(2):
        ji, jv = JR.select_topk(jnp.asarray(mask[b]), 150)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))


def test_dilated_dynamic_mask_matches_jax():
    rng = np.random.default_rng(1)
    h = w = 64
    logit = rng.normal(-4.0, 1.0, size=(2, h, w)).astype(np.float32)
    logit[0, 30:34, 30:34] = 1.0
    pids = rng.integers(0, h * w, size=(2, 500)).astype(np.int32)
    pids[:, ::50] = h * w  # trash ids
    in_range = pids < h * w
    got = PR.dilated_dynamic_mask(_t(logit), _t(pids), _t(in_range), 24, 4)
    for b in range(2):
        ref = JR.dilated_dynamic_mask(
            jnp.asarray(logit[b]), jnp.asarray(pids[b]), jnp.asarray(in_range[b]), 24, 4
        )
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
    assert got[0].any() and not got[0].all()


def _slot_scenes():
    """Frame 0: two movers from seeds off by ~0.8 m. Frame 1: a static box
    whose seed claims motion (must snap to exact zero) beside a mover."""
    n_obj, max_slots = 300, 8
    frames = []
    for seed, v0, v1, s0, s1 in (
        (0, [24.0, 6.0, 0.0], [-11.0, 15.0, 0.0], [0.7, -0.4, 0.0], [-0.5, 0.6, 0.0]),
        (1, [0.0, 0.0, 0.0], [20.0, 0.0, 0.0], [0.45, -0.2, 0.0], [0.0, 0.0, 0.0]),
    ):
        rng = np.random.default_rng(seed)
        p0, dt0, p1, dt1, slot = _two_cluster_scene(rng, v0, v1, n_obj=n_obj)
        seeds = np.zeros((max_slots, 3), np.float32)
        seeds[0] = np.asarray(v0) * SWEEP_DT + s0
        seeds[1] = np.asarray(v1) * SWEEP_DT + s1
        ok = np.zeros(max_slots, bool)
        ok[:2] = True
        k = 2 * n_obj
        frames.append(
            dict(q=p0[:k], qslot=slot[:k], qvalid=np.ones(k, bool), seed=seeds,
                 seed_ok=ok, r=p1[:k], rvalid=np.ones(k, bool),
                 qdt=dt0[:k], rdt=dt1[:k])
        )
    return frames, max_slots


def test_refine_slot_translations_matches_jax():
    frames, max_slots = _slot_scenes()
    keys = ("q", "qslot", "qvalid", "seed", "seed_ok", "r", "rvalid")
    batch = {k: _t(np.stack([f[k] for f in frames])) for k in (*keys, "qdt", "rdt")}
    delta, conf, snapped = PR.refine_slot_translations(
        *(batch[k] for k in keys), max_slots, qdt=batch["qdt"], rdt=batch["rdt"]
    )
    for b, f in enumerate(frames):
        jd, jc, js = JR.refine_slot_translations(
            *(jnp.asarray(f[k]) for k in keys), max_slots,
            qdt=jnp.asarray(f["qdt"]), rdt=jnp.asarray(f["rdt"]),
        )
        np.testing.assert_allclose(delta[b].numpy(), np.asarray(jd), atol=1e-4)
        np.testing.assert_array_equal(conf[b].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(snapped[b].numpy(), np.asarray(js))
    # The scenes exercise both outcomes: verified movers and a static snap.
    assert conf[0, :2].all() and not snapped[0, :2].any()
    assert snapped[1, 0] and (delta[1, 0] == 0).all() and not snapped[1, 1]
    np.testing.assert_allclose(delta[0, 0].numpy(), [2.4, 0.6, 0.0], atol=0.1)


def test_refine_flow_matches_jax():
    """Whole refine head on two frames. The reference is chaotic at the
    1e-3..1e-2 m level on these scenes: nudging ``p0`` by one float32 ulp
    moves JAX's own output by that much (near-tied NN pairs flip and the
    Aitken steps amplify the change). So each frame's tolerance is 1e-4
    plus twice that measured self-sensitivity; non-member points must be
    untouched exactly."""
    cfg_j = JR.RefineConfig(num_query=1024, num_ref=2048)
    cfg_p = PR.RefineConfig(num_query=1024, num_ref=2048)
    inputs = []
    for seed, v in ((3, [18.0, -9.0, 0.0]), (4, [-12.0, 4.0, 0.0])):
        rng = np.random.default_rng(seed)
        v = np.asarray(v)
        p0, dt0, p1, dt1, slot = _two_cluster_scene(rng, v, v, n_obj=256, n_bg=1024)
        n = len(p0)
        base = np.zeros((n, 3), np.float32)
        base[slot >= 0] = v * SWEEP_DT + np.array([0.5, 0.3, 0.0])
        logit = np.full((32, 32), 1.0, np.float32)
        logit[:4] = -1.0
        pids = rng.integers(0, 32 * 32, size=n).astype(np.int32)
        inputs.append(dict(
            flow=base, p0=p0, slot=slot, valid0=np.ones(n, bool),
            w0=np.ones(n, np.float32), p1=p1, valid1=np.ones(n, bool),
            logit=logit, pids=pids, in_range=np.ones(n, bool), dt0=dt0, dt1=dt1,
            v=v,
        ))
    keys = ("flow", "p0", "slot", "valid0", "w0", "p1", "valid1", "logit",
            "pids", "in_range")
    batch = {k: _t(np.stack([f[k] for f in inputs])) for k in (*keys, "dt0", "dt1")}
    out = PR.refine_flow(
        *(batch[k] for k in keys), 8, cfg_p, dt0=batch["dt0"], dt1=batch["dt1"]
    )

    def jax_refine(f, p0):
        args = [jnp.asarray(f[k]) for k in keys]
        args[1] = jnp.asarray(p0)
        return np.asarray(JR.refine_flow(
            *args, 8, cfg_j, dt0=jnp.asarray(f["dt0"]), dt1=jnp.asarray(f["dt1"])
        ))

    for b, f in enumerate(inputs):
        ref = jax_refine(f, f["p0"])
        nudged = jax_refine(f, np.nextafter(f["p0"], np.float32(np.inf)))
        tol = 1e-4 + 2.0 * np.abs(nudged - ref).max()
        assert tol < 0.05
        np.testing.assert_allclose(out[b].numpy(), ref, atol=tol)
        member = f["slot"] >= 0
        # Confident slots replaced the coarse seed with the measured motion.
        np.testing.assert_allclose(
            out[b].numpy()[member], np.broadcast_to(f["v"] * SWEEP_DT, (member.sum(), 3)),
            atol=0.12,
        )
        np.testing.assert_array_equal(out[b].numpy()[~member], f["flow"][~member])
