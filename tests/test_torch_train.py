"""The SSL train step in the port against the JAX package on the CPU.

Inputs come from seeded numpy as float32 / int32 / bool: the test session
enables JAX x64, and float64 inputs would change the JAX side. Where a JAX
function reaches a Pallas kernel it runs as the JAX tests run it, through
the interpreter (``HIMO_PALLAS_INTERPRET=1``, with the VMEM budgets shrunk
so that the 512x512 sorted-table path runs on a small grid) or through its
plain CPU reference (``_fused_xla`` for the fused NN kernel).

Tolerances, each with its reason:

- ``fused_masked_nn`` values and indices: exact (the port's CPU version
  computes the reference's ``|q|^2 + |r|^2 - 2 q.r`` in float32, and the
  lowest index wins ties in both); its VJP within 1e-5 (the same
  products, summed by another scatter).
- ``take_rows`` / ``segment_rows_sum`` / ``gather_pillars`` gradients
  within 1e-5 (scatter-adds in another order); ``scatter_max``'s gradient
  exact (a selection, no arithmetic).
- Loss terms within 1e-5 relative and their gradients within 1e-5
  (float32 reductions in another order).
- Schedule: the same numbers within 1e-6 relative (optax evaluates it in
  float32; the port in Python floats). Clip + Adam:
  parameters within 1e-6 of the learning rate plus 2e-7 relative (about
  two float32 ulps of the parameter).
- The whole step (toy ``seflowpp``, fp32, three steps): every metric
  within 1e-5 relative; slots equal first, because they are discrete
  decisions; before each step, every parameter's gradient of the
  frame-mean loss against ``jax.grad`` of the same loss at the same
  parameters within rtol 1e-4 plus 1e-4 of the tensor's largest component
  (float32 sums in another order; measured about 2e-6); the parameters
  after each step within 0.1 of that step's learning rate, and all but
  0.1 % of them within 1e-3 of it. Adam divides each gradient component
  by its own running RMS, so a component near Adam's eps (1e-8), where
  the two frameworks' rounding differs in relative terms, moves by a
  visible fraction of the learning rate. The first update has lr 0, so
  step 2 runs at step 1's parameters; step 3 is the first at moved ones.
- The gradient-norm jump on the 512x512 grid: the global gradient norm
  of each of three steps within 1e-3 relative of JAX's (the jump passes
  a 1/sqrt(eps)-sized gain through a GroupNorm, which magnifies rounding;
  measured about 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from himo_tpu.models import feedforward as JF
from himo_tpu.ops import nn as JNN
from himo_tpu.ops import voxelize as JV
from himo_tpu.training import losses as JL
from himo_tpu.training import trainer as JT
from himo_tpu_torch.data.synthetic import lidar_like_cloud, train_batch
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.ops import nn as PNN
from himo_tpu_torch.ops import voxelize as PV
from himo_tpu_torch.training import losses as PL
from himo_tpu_torch.training import trainer as PT
from himo_tpu_torch.utils.convert import flax_to_torch

GRID = dict(x_range=(-6.4, 6.4), y_range=(-5.0, 5.0), voxel_size=(0.2, 0.2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pen(mask):
    return np.where(mask, 0.0, 1e14).astype(np.float32)


def _fused_case(seed, n=300, m=257):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
    r = (rng.normal(size=(m, 3)) * 5).astype(np.float32)
    r[200:210] = r[:10]  # exact duplicate references
    q[:5] = r[:5]  # queries on them: the lowest index must win
    q[250:255] = q[:5]  # duplicate queries: ties of the column side
    v0 = rng.uniform(size=n) > 0.1
    v1 = rng.uniform(size=m) > 0.1
    v0[:5] = v0[250:255] = True
    v1[:10] = v1[200:210] = True
    d0 = rng.uniform(size=n) > 0.6
    d1 = rng.uniform(size=m) > 0.6
    return q, r, [_pen(v0), _pen(v0 & d0), _pen(v1), _pen(v1 & d1)], rng


def test_fused_masked_nn_values_indices_and_vjp():
    q, r, pens, rng = _fused_case(0)
    jout = JNN._fused_dispatch(jnp.asarray(q), jnp.asarray(r),
                               *map(jnp.asarray, pens), track_idx=True)
    pout = PNN._fused_dispatch(_t(q)[None], _t(r)[None],
                               *(_t(p)[None] for p in pens), track_idx=True)
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(j))
    assert (pout[4][0, :5].numpy() == np.arange(5)).all()  # lowest index
    assert (pout[6][0, :5].numpy() == np.arange(5)).all()  # columns too
    # Min-only: the same distances as the tracking variant.
    dists = PNN.fused_masked_nn(_t(q)[None], _t(r)[None], *(_t(p)[None] for p in pens))
    for a, b in zip(dists, pout[:4]):
        assert torch.equal(a, b)

    gs = [rng.normal(size=s).astype(np.float32) for s in (300, 300, 257, 257)]
    _, vjp = jax.vjp(
        lambda a, b: JNN.fused_masked_nn(a, b, *map(jnp.asarray, pens)),
        jnp.asarray(q), jnp.asarray(r),
    )
    jq, jr = vjp(tuple(map(jnp.asarray, gs)))
    tq = _t(q)[None].requires_grad_()
    tr = _t(r)[None].requires_grad_()
    outs = PNN.fused_masked_nn(tq, tr, *(_t(p)[None] for p in pens))
    sum((o[0] * _t(g)).sum() for o, g in zip(outs, gs)).backward()
    np.testing.assert_allclose(tq.grad[0].numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tr.grad[0].numpy(), np.asarray(jr), atol=1e-5)


def test_fused_nn_batched_equals_per_frame():
    cases = [_fused_case(s) for s in (1, 2)]
    q = _t(np.stack([c[0] for c in cases]))
    r = _t(np.stack([c[1] for c in cases]))
    pens = [_t(np.stack([c[2][k] for c in cases])) for k in range(4)]
    both = PNN.fused_nn_idx(q, r, *pens)
    for b in range(2):
        one = PNN.fused_nn_idx(q[b : b + 1], r[b : b + 1], *(p[b : b + 1] for p in pens))
        for x, y in zip(both, one):
            assert torch.equal(x[b], y[0])


def test_take_rows_and_segment_rows_sum_with_duplicates(monkeypatch):
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")  # JAX: the K3 kernel
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    idx = rng.integers(0, 400, 250).astype(np.int32)
    idx[:40] = 7  # duplicates pile onto one row
    g = rng.normal(size=(250, 3)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: JNN.take_rows(a, jnp.asarray(idx)), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = _t(x)[None].requires_grad_()
    y = PNN.take_rows(tx, _t(idx)[None])
    (y * _t(g)[None]).sum().backward()
    np.testing.assert_array_equal(y[0].detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad[0].numpy(), np.asarray(jdx), atol=1e-5)

    seg = PNN.segment_rows_sum(_t(g)[None], _t(idx)[None], 400)
    ref = JNN.segment_rows_sum(jnp.asarray(g), jnp.asarray(idx), 400)
    np.testing.assert_allclose(seg[0].numpy(), np.asarray(ref), atol=1e-5)
    # Ids outside [0, num_segments) are dropped, as jax.ops.segment_sum does.
    bad = idx.copy()
    bad[:10] = 400
    got = PNN.segment_rows_sum(_t(g)[None], _t(bad)[None], 400)[0].numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(g), jnp.asarray(bad), 400))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture()
def interpreted_sorted_path(monkeypatch):
    """The JAX 512x512 path (sorted-table Pallas kernels) on a 50 x 64
    grid, through the interpreter."""
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JV, "_VMEM_BUDGET_BYTES", 96 * 1024)
    monkeypatch.setattr(JV, "_BAND_BUDGET_BYTES", 256 * 1024)
    assert not JV._pallas_fits(50 * 64, 32)


def _grid_cloud(rng, n):
    pts = rng.uniform(-7.0, 7.0, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3.5, 3.5, n)
    return pts, rng.uniform(size=n) > 0.08


def test_scatter_max_gradient_gives_ties_the_whole_cotangent(interpreted_sorted_path):
    rng = np.random.default_rng(4)
    pts, valid = _grid_cloud(rng, 1500)
    feats = rng.normal(size=(1500, 32)).astype(np.float32)
    # An exact tie: two in-range points in one pillar with equal features.
    inside = np.flatnonzero(valid & (np.abs(pts[:, 0]) < 6) & (np.abs(pts[:, 1]) < 4.8)
                            & (np.abs(pts[:, 2]) < 2.9))
    a, b = inside[:2]
    pts[b] = pts[a]
    feats[b] = feats[a] = np.abs(feats[a]) + 10.0
    cot = rng.normal(size=(50, 64, 32)).astype(np.float32)
    jgrid = JV.voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), JV.PillarConfig(**GRID))
    jgrad = np.asarray(jax.grad(
        lambda f: jnp.sum(JV.scatter_max(f, jgrid) * jnp.asarray(cot))
    )(jnp.asarray(feats)))
    pgrid = PV.voxelize_pillars(_t(pts)[None], _t(valid)[None], PV.PillarConfig(**GRID))
    tf = _t(feats)[None].requires_grad_()
    (PV.scatter_max(tf, pgrid) * _t(cot)[None]).sum().backward()
    got = tf.grad[0].numpy()
    np.testing.assert_array_equal(got, jgrad)
    pid = int(pgrid.pillar_ids[0, a])
    want = cot.reshape(-1, 32)[pid]
    np.testing.assert_array_equal(got[a], want)  # each tied winner: all of it
    np.testing.assert_array_equal(got[b], want)
    assert (got[~pgrid.in_range[0].numpy()] == 0).all()


def test_gather_pillars_gradient_is_the_sum_scatter(interpreted_sorted_path):
    rng = np.random.default_rng(5)
    pts, valid = _grid_cloud(rng, 1500)
    image = rng.normal(size=(50, 64, 65)).astype(np.float32)
    cot = rng.normal(size=(1500, 65)).astype(np.float32)
    jgrid = JV.voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), JV.PillarConfig(**GRID))
    jgrad = jax.grad(
        lambda im: jnp.sum(JV.gather_pillars(im, jgrid) * jnp.asarray(cot))
    )(jnp.asarray(image))
    pgrid = PV.voxelize_pillars(_t(pts)[None], _t(valid)[None], PV.PillarConfig(**GRID))
    ti = _t(image)[None].requires_grad_()
    (PV.gather_pillars(ti, pgrid) * _t(cot)[None]).sum().backward()
    np.testing.assert_allclose(ti.grad[0].numpy(), np.asarray(jgrad), atol=1e-5)
    # bf16 images: gathered exactly, the (bf16) cotangent summed in fp32 and
    # cast back once, so the result is the fp32 sum of the same cotangent,
    # rounded.
    cot_b = _t(cot)[None].to(torch.bfloat16)
    tb = _t(image)[None].to(torch.bfloat16).requires_grad_()
    out = PV.gather_pillars(tb, pgrid)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), PV.gather_pillars(_t(image)[None], pgrid).to(
        torch.bfloat16).float())
    (out * cot_b).sum().backward()
    assert tb.grad.dtype == torch.bfloat16
    ti.grad = None
    (PV.gather_pillars(ti, pgrid) * cot_b.float()).sum().backward()
    assert torch.equal(tb.grad, ti.grad.to(torch.bfloat16))


def _loss_batch(seed, n=600, m=500, k=128):
    rng = np.random.default_rng(seed)
    pc0 = (rng.normal(size=(2, n, 3)) * 4).astype(np.float32)
    pc1 = (pc0[:, :m] + rng.normal(0, 0.3, size=(2, m, 3))).astype(np.float32)
    d = dict(
        flow=rng.normal(0, 0.5, size=(2, n, 3)).astype(np.float32),
        pc0=pc0, pc1=pc1,
        valid0=rng.uniform(size=(2, n)) > 0.1, valid1=rng.uniform(size=(2, m)) > 0.1,
        dynamic0=rng.uniform(size=(2, n)) > 0.7, dynamic1=rng.uniform(size=(2, m)) > 0.7,
        cluster0=rng.integers(0, 12, size=(2, n)).astype(np.int32),
        prior0=rng.normal(0, 0.5, size=(2, n, 3)).astype(np.float32),
        prior_valid0=rng.uniform(size=(2, n)) > 0.8,
        gate_logit0=rng.normal(size=(2, n)).astype(np.float32),
        loss_idx0=rng.integers(0, n, size=(2, k)).astype(np.int32),
        loss_idx1=rng.integers(0, m, size=(2, k)).astype(np.int32),
    )
    d["cluster0"][:, :30] = 11  # >= num_clusters (10): dropped from sums, clamped read
    return d


@pytest.mark.parametrize("sampled", [False, True])
def test_seflowpp_loss_terms_and_gradients_match_jax(sampled):
    d = _loss_batch(6)
    names = ["flow", "pc0", "pc1", "valid0", "valid1", "dynamic0", "dynamic1", "cluster0"]
    extra = ["loss_idx0", "loss_idx1"] if sampled else []
    kw = dict(num_clusters=10, max_dist=2.0, dynamic_max_dist=5.0)
    jfn = JL.seflowpp_loss_sampled if sampled else JL.seflowpp_loss
    pfn = PL.seflowpp_loss_sampled if sampled else PL.seflowpp_loss
    for b in range(2):
        def jloss(flow, gate):
            args = [flow] + [jnp.asarray(d[k][b]) for k in names[1:] + extra]
            return jfn(*args, prior0=jnp.asarray(d["prior0"][b]),
                       prior_valid0=jnp.asarray(d["prior_valid0"][b]),
                       gate_logit0=gate, **kw)

        jterms = jloss(jnp.asarray(d["flow"][b]), jnp.asarray(d["gate_logit0"][b]))
        jgf, jgg = jax.grad(lambda f, g: jloss(f, g)["total"], argnums=(0, 1))(
            jnp.asarray(d["flow"][b]), jnp.asarray(d["gate_logit0"][b]))
        flow = _t(d["flow"][b : b + 1]).requires_grad_()
        gate = _t(d["gate_logit0"][b : b + 1]).requires_grad_()
        pterms = pfn(flow, *(_t(d[k][b : b + 1]) for k in names[1:] + extra),
                     prior0=_t(d["prior0"][b : b + 1]),
                     prior_valid0=_t(d["prior_valid0"][b : b + 1]), gate_logit0=gate, **kw)
        assert set(pterms) == set(jterms)
        for name, v in jterms.items():
            np.testing.assert_allclose(float(pterms[name][0].detach()), float(v), rtol=1e-5,
                                       err_msg=name)
        pterms["total"].sum().backward()
        np.testing.assert_allclose(flow.grad[0].numpy(), np.asarray(jgf), atol=1e-5)
        np.testing.assert_allclose(gate.grad[0].numpy(), np.asarray(jgg), atol=1e-5)
        # Prior-covered points send no chamfer gradient: only the
        # elementwise terms reach them, and those are the same either way.
        assert np.isfinite(flow.grad.numpy()).all()


def test_loss_terms_are_per_frame():
    d = _loss_batch(7)
    names = ["flow", "pc0", "pc1", "valid0", "valid1", "dynamic0", "dynamic1", "cluster0"]
    both = PL.seflowpp_loss(*(_t(d[k]) for k in names), num_clusters=10)
    for b in range(2):
        one = PL.seflowpp_loss(*(_t(d[k][b : b + 1]) for k in names), num_clusters=10)
        for k in both:
            torch.testing.assert_close(both[k][b], one[k][0])


def test_dyn_image_loss_and_gradient_match_jax(interpreted_sorted_path):
    rng = np.random.default_rng(8)
    pts, valid = _grid_cloud(rng, 1500)
    obj = rng.uniform(size=1500) > 0.9
    logit = rng.normal(size=(50, 64)).astype(np.float32)
    cfg_j, cfg_p = JV.PillarConfig(**GRID), PV.PillarConfig(**GRID)
    jv, jg = jax.value_and_grad(lambda x: JL.dyn_image_loss(
        x, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(obj), cfg_j))(jnp.asarray(logit))
    tl = _t(logit)[None].requires_grad_()
    pv = PL.dyn_image_loss(tl, _t(pts)[None], _t(valid)[None], _t(obj)[None], cfg_p)
    pv.sum().backward()
    np.testing.assert_allclose(float(pv[0].detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tl.grad[0].numpy(), np.asarray(jg), atol=1e-7)


def test_schedule_matches_optax():
    for kw, spe in (({}, 10), ({"warmup_steps": 5}, 4), ({"warmup_steps": 0}, 3),
                    ({"epochs": 1}, 2)):
        jcfg = JT.TrainConfig(**kw)
        pcfg = PT.TrainConfig(**kw)
        _, jsched = JT.make_optimizer(jcfg, spe)
        psched = PT.make_schedule(pcfg, spe)
        steps = range(spe * jcfg.epochs + 5)
        np.testing.assert_allclose([psched(s) for s in steps],
                                   [float(jsched(s)) for s in steps], rtol=1e-6, atol=0)
    sched = PT.make_schedule(PT.TrainConfig(), 10)
    assert sched(0) == 0.0  # the first update has lr 0
    # warmup = min(100, 120 // 10) = 12; StepLR boundaries count after it.
    assert sched(12) == pytest.approx(6e-5)
    assert sched(12 + 29) == pytest.approx(6e-5)
    assert sched(12 + 30) == pytest.approx(3e-5)


@pytest.mark.parametrize("scale", [0.01, 50.0])  # below and above the clip
def test_clip_and_adam_match_optax(scale):
    rng = np.random.default_rng(9)
    shapes = [(4, 3), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
             for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, epochs=2, grad_clip=2.0)
    jopt, _ = JT.make_optimizer(JT.TrainConfig(**cfg), 5)
    jp = [jnp.asarray(p) for p in params]
    state = jopt.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    popt, sched = PT.make_optimizer(tp, PT.TrainConfig(**cfg), 5)
    for step, g in enumerate(grads):
        upd, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        popt.zero_grad()
        for p, x in zip(tp, g):
            p.grad = _t(x).clone()
        popt.step()
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g))
        assert float(popt.last_grad_norm) == pytest.approx(norm, rel=1e-5)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-6 * cfg["lr"], rtol=2e-7)


def test_build_frame_arrays_matches_jax():
    rng = np.random.default_rng(10)
    n = 900

    def pose():
        a = rng.uniform(-0.3, 0.3)
        p = np.eye(4)
        p[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        p[:3, 3] = rng.uniform(-5, 5, 3)
        return p

    data = dict(
        pc0=rng.normal(size=(n, 4)) * 10, pc1=rng.normal(size=(n - 50, 3)) * 10,
        pc_prev=rng.normal(size=(n + 40, 3)) * 10,
        pose0=pose(), pose1=pose(), pose_prev=pose(),
        gm0=rng.uniform(size=n) > 0.7, gm1=rng.uniform(size=n - 50) > 0.7,
        gm_prev=rng.uniform(size=n + 40) > 0.7,
        ssl_dynamic=rng.uniform(size=n) > 0.8, ssl_dynamic1=rng.uniform(size=n - 50) > 0.8,
        ssl_cluster=rng.integers(0, 9, n).astype(np.int32),
        ssl_prior=rng.normal(size=(n, 3)).astype(np.float32),
        ssl_prior_valid=rng.uniform(size=n) > 0.9,
        flow=rng.normal(size=(n, 3)), flow_is_valid=rng.uniform(size=n) > 0.2,
    )
    for num_points, num_frames in ((1024, 3), (800, 2)):
        ref = JT.build_frame_arrays(data, num_points, num_frames, loss_points=256,
                                    rng=np.random.default_rng(11), with_gt=True)
        got = PT.build_frame_arrays(data, num_points, num_frames, loss_points=256,
                                    rng=np.random.default_rng(11), with_gt=True)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dataclasses_copy_the_reference():
    import dataclasses

    for jcls, pcls in ((JT.TrainConfig, PT.TrainConfig),
                       (JL.SSLLossWeights, PL.SSLLossWeights)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        pf = [(f.name, f.default) for f in dataclasses.fields(pcls)]
        assert [n for n, _ in jf] == [n for n, _ in pf]
        for (name, jd), (_, pd) in zip(jf, pf):
            if dataclasses.is_dataclass(jd):
                assert dataclasses.asdict(jd) == dataclasses.asdict(pd), name
            else:
                assert jd == pd, name


# ------------------------------------------------------------ whole step

TOY = {
    "pillar.voxel_size": (0.4, 0.4),
    "pillar.x_range": (-12.8, 12.8),
    "pillar.y_range": (-12.8, 12.8),
    "depths": (16, 32),
}
B, N, K = 2, 1024, 256
STEP_CFG = dict(batch_size=B, num_points=N, loss_points=K, lr=1e-3)


def _step_batch():
    rng = np.random.default_rng(0)
    pc0 = lidar_like_cloud(rng, B, N) * np.float32(0.25)
    shift = np.array([0.6, -0.2, 0.0], np.float32)
    valid = np.arange(N)[None].repeat(B, 0) < int(N * 0.92)
    batch = dict(
        pc0=pc0,
        pc1=(pc0 + shift + rng.normal(0, 0.02, pc0.shape)).astype(np.float32),
        pc_hist=(pc0 - shift).astype(np.float32),
        valid0=valid, valid1=valid.copy(), valid_hist=valid.copy(),
        dynamic0=rng.random((B, N)) < 0.1, dynamic1=rng.random((B, N)) < 0.1,
        cluster0=rng.integers(0, 8, (B, N)).astype(np.int32),
        prior0=rng.normal(0, 0.1, (B, N, 3)).astype(np.float32),
        prior_valid0=rng.random((B, N)) < 0.05,
        loss_idx0=rng.integers(0, N, (B, K)).astype(np.int32),
        loss_idx1=rng.integers(0, N, (B, K)).astype(np.int32),
    )
    batch["cluster0"][:, :20] = 70  # beyond num_clusters (64)
    return batch


@pytest.fixture(scope="module")
def toy_step():
    jm, _ = JF.make_model("seflowpp", **TOY)
    zeros = tuple(jnp.zeros((N, 3), jnp.float32) for _ in range(3))
    ones = tuple(jnp.ones((N,), bool) for _ in range(3))
    params = jax.jit(lambda k: jm.init(k, zeros, ones, None))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    # Open some gates and form several components with random weights.
    params["params"]["UNet_0"]["Conv_0"]["bias"][64] = -1.2
    params["params"]["DeFlowGRUDecoder_0"]["Dense_3"]["bias"][3] = 0.1
    return jm, params, _step_batch()


def _jax_mean_loss_grad(jm, jcfg):
    """``jax.grad`` of the frame-mean total loss, as ``make_train_step``
    differentiates it."""

    def loss(p, b):
        losses = jax.vmap(lambda f: JT._frame_flow_and_loss(jm, jcfg, p, f)[1])(b)
        return jnp.mean(losses["total"])

    return jax.jit(jax.grad(loss))


def _grad_norm(tree):
    return float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(tree))))


def test_train_step_matches_jax(toy_step):
    jm, params, batch = toy_step
    model, cfg = PF.make_model("seflowpp", device="cpu", **TOY)
    model.load_state_dict(flax_to_torch(params, cfg))
    ref, _ = PF.make_model("seflowpp", device="cpu", **TOY)  # gradients at JAX's params
    tb = {k: _t(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    # Discrete decisions first: the slots of the soft-gated forward.
    japply = jax.jit(lambda p, s, v: jm.apply(p, s, v, with_aux=True, soft_gate=True))
    with torch.no_grad():
        _, paux = model((tb["pc0"], tb["pc1"], tb["pc_hist"]),
                        (tb["valid0"], tb["valid1"], tb["valid_hist"]),
                        with_aux=True, soft_gate=True)
    for b in range(B):
        _, jaux = japply(params, (jb["pc0"][b], jb["pc1"][b], jb["pc_hist"][b]),
                         (jb["valid0"][b], jb["valid1"][b], jb["valid_hist"][b]))
        np.testing.assert_array_equal(paux["slot"][b].numpy(), np.asarray(jaux["slot"]))
        assert np.unique(np.asarray(jaux["slot"])).size >= 3  # -1 and >= 2 slots

    jcfg, pcfg = JT.TrainConfig(**STEP_CFG), PT.TrainConfig(**STEP_CFG)
    jopt, jsched = JT.make_optimizer(jcfg, 10)
    popt, psched = PT.make_optimizer(model.parameters(), pcfg, 10)
    jstate = jopt.init(params)
    jstep = JT.make_train_step(jm, jcfg, jopt)
    pstep = PT.make_train_step(model, pcfg, popt)
    jgrad = _jax_mean_loss_grad(jm, jcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for step in range(3):
        np_params = jax.tree_util.tree_map(np.asarray, params)
        ref.load_state_dict(flax_to_torch(np_params, cfg))
        ref.zero_grad(set_to_none=True)
        PT.mean_losses(ref, pcfg, tb)["total"].backward()
        want_grad = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrad(params, jb)), cfg)
        for k, p in ref.named_parameters():
            got_grad = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            w = want_grad[k].numpy()
            np.testing.assert_allclose(got_grad, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"step {step + 1} grad {k}")
        params, jstate, jmetrics = jstep(params, jstate, jb)
        pmetrics = pstep(tb)
        assert set(pmetrics) == set(jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(pmetrics[k]), float(v), rtol=1e-5, err_msg=k)
        lr = psched(step)
        assert lr == pytest.approx(float(jsched(step)))
        want = flax_to_torch(jax.tree_util.tree_map(np.asarray, params), cfg)
        got = model.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=0.1 * lr, rtol=0, err_msg=k)
        diffs = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
        assert float((diffs > 1e-3 * lr).float().mean()) < 1e-3
        moved = max(float((got[k] - before[k]).abs().max()) for k in got)
        if step == 0:
            assert lr == 0.0 and moved == 0.0  # the first update has lr 0
        else:
            assert moved > 0.5 * lr
    assert float(popt.last_grad_norm) > 0


def test_gradient_norm_jump_on_the_512_grid_matches_jax():
    """On the 512x512 grid the global gradient norm jumps about tenfold at
    step 3, the first step at moved parameters (on the full-width chip run
    too). JAX's reference does the same at the same parameters: the jump
    belongs to the model, not to the port."""
    ov = {"depths": (16, 32)}
    b, n, k = 1, 4096, 1024
    jm, _ = JF.make_model("seflowpp", **ov)
    zeros = tuple(jnp.zeros((n, 3), jnp.float32) for _ in range(3))
    ones = tuple(jnp.ones((n,), bool) for _ in range(3))
    params = jax.jit(lambda key: jm.init(key, zeros, ones, None))(jax.random.PRNGKey(0))
    model, cfg = PF.make_model("seflowpp", device="cpu", **ov)
    assert cfg.pillar.grid_shape == (512, 512)
    model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, params), cfg))
    batch = train_batch(np.random.default_rng(0), b, n, k)
    kw = dict(batch_size=b, num_points=n, loss_points=k)
    jcfg, pcfg = JT.TrainConfig(**kw), PT.TrainConfig(**kw)
    jopt, _ = JT.make_optimizer(jcfg, 10)
    jstate = jopt.init(params)
    jgrad = _jax_mean_loss_grad(jm, jcfg)
    popt, _ = PT.make_optimizer(model.parameters(), pcfg, 10)
    pstep = PT.make_train_step(model, pcfg, popt)
    tb = {key: _t(v) for key, v in batch.items()}
    jb = {key: jnp.asarray(v) for key, v in batch.items()}
    norms = []
    for _ in range(3):
        g = jgrad(params, jb)
        updates, jstate = jopt.update(g, jstate, params)
        params = optax.apply_updates(params, updates)
        pstep(tb)
        norms.append((float(popt.last_grad_norm), _grad_norm(g)))
    for got, want in norms:
        assert got == pytest.approx(want, rel=1e-3)
    assert norms[1][1] == pytest.approx(norms[0][1], rel=1e-6)  # lr 0 at step 1
    assert norms[2][1] > 5 * norms[0][1]  # the jump
    # Both put it in the bias of the UNet's first convolution (the clip
    # scales every .grad alike, so the ranking survives it).
    jg = flax_to_torch(jax.tree_util.tree_map(np.asarray, g), cfg)
    top = max(jg, key=lambda name: float(jg[name].norm()))
    port_top = max(((name, p) for name, p in model.named_parameters() if p.grad is not None),
                   key=lambda item: float(item[1].grad.norm()))[0]
    assert top == port_top == "unet.down.0.conv0.bias"
    assert float(jg[top].norm()) > 0.9 * norms[2][1]


def test_val_step_runs_without_gradient(toy_step):
    _, params, batch = toy_step
    model, cfg = PF.make_model("seflowpp", device="cpu", **TOY)
    model.load_state_dict(flax_to_torch(params, cfg))
    tb = {k: _t(v) for k, v in batch.items()}
    rng = np.random.default_rng(12)
    tb["gt_flow"] = _t(rng.normal(0, 0.3, (B, N, 3)).astype(np.float32))
    tb["gt_valid"] = tb["valid0"] & _t(rng.random((B, N)) < 0.7)
    out = PT.make_val_step(model, PT.TrainConfig(**STEP_CFG))(tb)
    assert float(out["frames"]) == B
    assert float(out["epe_count"]) == float(tb["gt_valid"].sum())
    assert all(torch.isfinite(v) and not v.requires_grad for v in out.values())
    with torch.no_grad():
        _, losses = PT._frame_flow_and_loss(model, PT.TrainConfig(**STEP_CFG), tb)
    torch.testing.assert_close(out["total_sum"], losses["total"].sum())


def test_entry_points_default_to_the_gpu(monkeypatch):
    from himo_tpu_torch.models.registry import get_estimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF.make_model("seflowpp", depths=(16,))
    state = PF.make_model("seflowpp", device="cpu", depths=(16,))[0].state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_estimator("seflowpp", params=state, depths=(16,))
    model, _ = PF.make_model("seflowpp", device="cpu", depths=(16,))
    assert next(model.parameters()).device.type == "cpu"
