"""Port parity for the pillar ops, the streaming NN search and the connected
components, against the JAX package on the CPU.

- ``voxelize_pillars``: exact.
- ``scatter_max``: exact, against the JAX TPU kernel itself
  (``_sorted_scatter_table_band_kernel``) run through the Pallas
  interpreter, with the VMEM budgets shrunk so that the 512x512 path
  (``_sorted_scatter_forward``'s table variant) runs on a small grid.
- ``nn_argmin`` / ``nn_distance_sq``: exact, against the JAX CPU path
  (``_nn_argmin_xla`` / ``_nn_distance_sq_xla``; the NN kernels have no
  interpret switch). The port's CPU versions compute the same
  ``|q|^2 + |r|^2 - 2 q.r`` form in float32.
- components: labels and slots exact; pooling within 1e-5 (fp32 one-hot
  matmuls summed in another order).

The CUDA kernels themselves are compared with their plain versions in
``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.ops import components as JCmp
from himo_tpu.ops import nn as JNN
from himo_tpu.ops import voxelize as JV
from himo_tpu_torch.ops import components as PCmp
from himo_tpu_torch.ops import nn as PNN
from himo_tpu_torch.ops import voxelize as PV

# A 50 x 64 grid: 3200 rows (unique, so the JAX kernels' lru caches built
# with the real budgets elsewhere in the session are not reused here).
GRID = dict(x_range=(-6.4, 6.4), y_range=(-5.0, 5.0), voxel_size=(0.2, 0.2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, n):
    pts = rng.uniform(-7.0, 7.0, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3.5, 3.5, n)
    # Points exactly on pillar borders and the z limits.
    pts[:8, 0] = np.float32(-6.4) + np.arange(8, dtype=np.float32) * np.float32(0.2)
    pts[8:12, 2] = np.float32(3.0)
    return pts


def test_voxelize_pillars_exact():
    rng = np.random.default_rng(0)
    pts = np.stack([_cloud(rng, 900), _cloud(rng, 900)])
    valid = rng.uniform(size=(2, 900)) > 0.08
    grid = PV.voxelize_pillars(_t(pts), _t(valid), PV.PillarConfig(**GRID))
    assert grid.grid_shape == (50, 64)
    for b in range(2):
        ref = JV.voxelize_pillars(
            jnp.asarray(pts[b]), jnp.asarray(valid[b]), JV.PillarConfig(**GRID)
        )
        np.testing.assert_array_equal(grid.pillar_ids[b].numpy(), np.asarray(ref.pillar_ids))
        np.testing.assert_array_equal(grid.in_range[b].numpy(), np.asarray(ref.in_range))
        np.testing.assert_array_equal(
            grid.centers_offset[b].numpy(), np.asarray(ref.centers_offset)
        )
    assert grid.pillar_ids.dtype == torch.int32
    assert (grid.pillar_ids[~grid.in_range] == 50 * 64).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_max_matches_interpreted_tpu_kernel(monkeypatch, dtype):
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JV, "_VMEM_BUDGET_BYTES", 96 * 1024)
    monkeypatch.setattr(JV, "_BAND_BUDGET_BYTES", 256 * 1024)
    hw = 50 * 64
    assert not JV._pallas_fits(hw, 32)  # the sorted (512x512-style) path
    rng = np.random.default_rng(1)
    n = 1500
    pts = _cloud(rng, n)
    valid = rng.uniform(size=n) > 0.08
    feats = rng.normal(size=(n, 32)).astype(np.float32)
    feats[::7] = np.abs(feats[::7])
    jgrid = JV.voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), JV.PillarConfig(**GRID))
    jf = jnp.asarray(feats).astype(getattr(jnp, dtype))
    ref = np.asarray(JV.scatter_max(jf, jgrid).astype(jnp.float32))
    pgrid = PV.voxelize_pillars(_t(pts)[None], _t(valid)[None], PV.PillarConfig(**GRID))
    pf = _t(feats)[None].to(getattr(torch, dtype))
    got = PV.scatter_max(pf, pgrid)
    assert got.dtype == pf.dtype and got.shape == (1, 50, 64, 32)
    np.testing.assert_array_equal(got[0].float().numpy(), ref)
    assert (got[0].float().numpy() == 0).any()  # empty pillars read 0


def test_scatter_max_multi_and_batch_offsets():
    rng = np.random.default_rng(2)
    cfg = PV.PillarConfig(**GRID)
    sweeps = [_t(np.stack([_cloud(rng, 600), _cloud(rng, 600)])) for _ in range(3)]
    grids = [PV.voxelize_pillars(s, None, cfg) for s in sweeps]
    feats = [_t(rng.normal(size=(2, 600, 8)).astype(np.float32)) for _ in range(3)]
    outs = PV.scatter_max_multi(feats, grids)
    assert len(outs) == 3
    for f, g, out in zip(feats, grids, outs):
        for b in range(2):
            one = PV.scatter_max(f[b : b + 1], PV.PillarGrid(
                g.pillar_ids[b : b + 1], g.in_range[b : b + 1],
                g.centers_offset[b : b + 1], g.grid_shape,
            ))
            torch.testing.assert_close(out[b : b + 1], one, rtol=0, atol=0)


def test_gather_pillars_matches_jax_and_zeroes_out_of_range():
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 800)
    valid = rng.uniform(size=800) > 0.1
    image = rng.normal(size=(50, 64, 5)).astype(np.float32)
    jgrid = JV.voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), JV.PillarConfig(**GRID))
    ref = np.asarray(JV.gather_pillars(jnp.asarray(image), jgrid))
    pgrid = PV.voxelize_pillars(_t(pts)[None], _t(valid)[None], PV.PillarConfig(**GRID))
    got = PV.gather_pillars(_t(image)[None], pgrid)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[~pgrid.in_range[0].numpy()] == 0).all()


def _nn_case(rng, n, m, scale):
    q = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    r = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    r[m // 2 : m // 2 + 10] = r[:10]  # exact duplicate refs: lowest index wins
    q[:5] = r[:5]  # queries sitting on duplicated refs
    qv = rng.uniform(size=n) > 0.15
    rv = rng.uniform(size=m) > 0.15
    qv[:5] = True
    rv[:10] = True
    rv[m // 2 : m // 2 + 10] = True
    return q, r, qv, rv


@pytest.mark.parametrize(
    "n,m,masked", [(300, 700, True), (129, 1025, True), (256, 2048, False)]
)
def test_nn_argmin_matches_jax(n, m, masked):
    rng = np.random.default_rng(n + m)
    q, r, qv, rv = _nn_case(rng, n, m, 12.0)
    jm = (jnp.asarray(qv), jnp.asarray(rv)) if masked else (None, None)
    pm = (_t(qv)[None], _t(rv)[None]) if masked else (None, None)
    jd, ji = JNN.nn_argmin(jnp.asarray(q), jnp.asarray(r), *jm)
    pd, pi = PNN.nn_argmin(_t(q)[None], _t(r)[None], *pm)
    np.testing.assert_array_equal(pd[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pi[0].numpy(), np.asarray(ji))
    assert (pi[0, :5].numpy() == np.arange(5)).all()  # first of the duplicates
    if masked:
        assert (pd[0].numpy()[~qv] == 0).all() and (pi[0].numpy()[~qv] == 0).all()
        assert rv[pi[0].numpy()[qv]].all()  # invalid refs never win
    jdist = JNN.nn_distance_sq(jnp.asarray(q), jnp.asarray(r), *jm)
    pdist = PNN.nn_distance_sq(_t(q)[None], _t(r)[None], *pm)
    np.testing.assert_array_equal(pdist[0].numpy(), np.asarray(jdist))


def test_nn_batched_equals_per_frame():
    rng = np.random.default_rng(9)
    cases = [_nn_case(rng, 200, 300, 5.0) for _ in range(3)]
    q, r, qv, rv = (np.stack(x) for x in zip(*cases))
    d, i = PNN.nn_argmin(_t(q), _t(r), _t(qv), _t(rv))
    for b in range(3):
        d1, i1 = PNN.nn_argmin(_t(q[b])[None], _t(r[b])[None], _t(qv[b])[None], _t(rv[b])[None])
        torch.testing.assert_close(d[b], d1[0], rtol=0, atol=0)
        torch.testing.assert_close(i[b], i1[0], rtol=0, atol=0)


def test_components_match_jax():
    rng = np.random.default_rng(5)
    occ = rng.uniform(size=(2, 40, 48)) > 0.93
    occ[1, 5:25, 10:12] = True  # a long bar: labels must travel > reach * 1
    for b in range(2):
        jl = np.asarray(JCmp.connected_components_grid(jnp.asarray(occ[b]), iters=6, reach=2))
        pl = PCmp.connected_components_grid(_t(occ), iters=6, reach=2)[b].numpy()
        np.testing.assert_array_equal(pl, jl)
    pl_all = PCmp.connected_components_grid(_t(occ), iters=6, reach=2)
    slots, count = PCmp.component_slots(pl_all, 8)
    for b in range(2):
        js, jn = JCmp.component_slots(jnp.asarray(pl_all[b].numpy()), 8)
        np.testing.assert_array_equal(slots[b].numpy(), np.asarray(js))
        assert int(count[b]) == int(jn)
    assert int(count.max()) > 8  # the overflow rule is exercised


def test_pool_by_slot_matches_jax():
    rng = np.random.default_rng(6)
    n, s = 500, 16
    values = rng.normal(size=(2, n, 3)).astype(np.float32)
    weights = (rng.uniform(size=(2, n)) > 0.3).astype(np.float32)
    slot = rng.integers(-1, s, size=(2, n)).astype(np.int32)
    slot[:, :40] = 3
    pooled, ok = PCmp.pool_by_slot(_t(values), _t(weights), _t(slot), s, 5.0)
    for b in range(2):
        jp, jo = JCmp.pool_by_slot(
            jnp.asarray(values[b]), jnp.asarray(weights[b]), jnp.asarray(slot[b]), s, 5.0
        )
        np.testing.assert_allclose(pooled[b].numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jo))
