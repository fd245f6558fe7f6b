"""The reference's scatter/gather routes in the port, against the JAX package
on the CPU.

- Route rule: ``_route`` and ``_fuse_sweeps`` make the reference's choice
  (``_pallas_fits``, ``_window_bytes`` and the table threshold; the fusion
  gate of ``scatter_max_multi``) at the model's real shapes: 512x512 at
  65,536 points takes the table route (K1), 256x256 the resident route (K3,
  K4), 512x512 at 131,072 points the stream route (K2), for C = 32, 65, 1.
- Values: on each route, ``scatter_max``, ``gather_pillars`` and
  ``scatter_mean`` are bitwise equal to the JAX functions run with
  ``HIMO_PALLAS_INTERPRET=1`` (the TPU kernels K3, K4, K1 and K2 themselves,
  interpreted), in fp32 and bf16, with both packages' thresholds shrunk so
  that a toy grid takes the route; the stream route's max also at C = 1
  and on features with -0.0 and -inf (compared by value: the reference
  keeps -0.0 where the port writes +0.0). Each test grid is used by no
  other test, so the JAX package's shape-keyed kernel caches never mix
  thresholds.
- Gradients against ``jax.grad``: within rtol 1e-6; the stream route's K2
  sum bitwise (both add each row in stream order).
- The slice: the toy ``seflowpp`` forward of ``test_torch_slice.py`` at
  64x64 (the resident route) against JAX interpreting K3 max and K4; flow
  within 1e-4 with the same margins for discrete decisions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.models import feedforward as JF
from himo_tpu.ops import voxelize as JV
from himo_tpu_torch.data.synthetic import lidar_like_cloud
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.ops import voxelize as PV
from himo_tpu_torch.utils.convert import flax_to_torch

ROUTES = {
    # name: (grid with a row count no other test uses, shrunk thresholds:
    # (resident image bytes, point table bytes) or None for the real ones)
    "resident": (dict(x_range=(-8.8, 8.8), y_range=(-7.2, 7.2), voxel_size=(0.4, 0.4)),
                 None),
    "table": (dict(x_range=(-9.2, 9.2), y_range=(-7.6, 7.6), voxel_size=(0.4, 0.4)),
              (64 * 1024, 40 * 1024 * 1024)),
    "stream": (dict(x_range=(-9.6, 9.6), y_range=(-8.0, 8.0), voxel_size=(0.4, 0.4)),
               (64 * 1024, 512 * 1024)),
}
WRAPPERS = {"resident": ("scatter_max_resident_rows", "gather_rows"),
            "table": ("scatter_max_rows", "scatter_sum_rows"),
            "stream": ("sorted_scatter_max_rows", "sorted_scatter_sum_rows")}
N = 1500


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reference_route(rows, n, c):
    """The reference's choice, from its own functions and thresholds."""
    if JV._pallas_fits(rows, c):
        return "resident"
    n_pad = n + (-n % JV._SCATTER_CHUNK)
    return "table" if JV._window_bytes(n_pad, c) <= JV._TABLE_BUDGET_BYTES else "stream"


@pytest.mark.parametrize("c", [32, 65, 1])
@pytest.mark.parametrize("rows,n,want", [
    (512 * 512, 65536, "table"), (256 * 256, 65536, "resident"),
    (512 * 512, 131072, "stream"), (512 * 512, 81920, "table"),
    (512 * 512, 81921, "stream"), (256 * 256, 131072, "resident"),
])
def test_route_rule_is_the_references(rows, n, c, want):
    assert _reference_route(rows, n, c) == want
    assert PV._route(rows, n, c) == want


@pytest.mark.parametrize("side,n,fused", [
    (512, 65536, False), (256, 65536, False), (512, 131072, False), (512, 16384, True),
])
def test_fusion_gate_is_the_references(monkeypatch, side, n, fused):
    """The reference's scatter_max_multi over 3 sweeps, traced (not run):
    one scatter call when it fuses, three when it does not."""
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    calls = []
    inner = JV._scatter_rows_pallas
    monkeypatch.setattr(JV, "_scatter_rows_pallas",
                        lambda *a, **k: calls.append(k["num_rows"]) or inner(*a, **k))
    half = side * 0.1
    cfg = JV.PillarConfig(x_range=(-half, half), y_range=(-half, half))
    pts = jax.ShapeDtypeStruct((n, 3), jnp.float32)
    feats = jax.ShapeDtypeStruct((n, 32), jnp.float32)

    def multi(p, f):
        grid = JV.voxelize_pillars(p, None, cfg)
        return JV.scatter_max_multi([f] * 3, [grid] * 3)

    jax.eval_shape(multi, pts, feats)
    assert len(calls) == (1 if fused else 3)
    assert PV._fuse_sweeps(side * side, 3 * n, 32, 3) == fused


def _shrink(monkeypatch, route):
    grid, limits = ROUTES[route]
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    if limits is not None:
        resident, table = limits
        monkeypatch.setattr(JV, "_VMEM_BUDGET_BYTES", resident)
        monkeypatch.setattr(JV, "_BAND_BUDGET_BYTES", 256 * 1024)
        monkeypatch.setattr(JV, "_TABLE_BUDGET_BYTES", table)
        monkeypatch.setattr(PV, "_RESIDENT_BYTES", resident)
        monkeypatch.setattr(PV, "_TABLE_BYTES", table)
    return grid


def _count_wrappers(monkeypatch):
    """Replace each kernel wrapper of the port by a counting call of itself
    (the CPU wrappers count nothing); returns the counts."""
    counts = {}
    for mod, name in ((PV, "scatter_max_rows"), (PV, "scatter_max_resident_rows"),
                      (PV, "scatter_sum_rows"), (PV, "sorted_scatter_max_rows"),
                      (PV, "sorted_scatter_sum_rows"), (PV, "gather_rows")):
        def counted(*args, _fn=getattr(mod, name), _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    from himo_tpu_torch.ops import nn as PNN

    seg = PNN.segment_rows_sum

    def counted_seg(*args):
        counts["segment_rows_sum"] = counts.get("segment_rows_sum", 0) + 1
        return seg(*args)

    monkeypatch.setattr(PNN, "segment_rows_sum", counted_seg)
    return counts


def _case(seed, grid, c, dtype, signed=False):
    """Points, masks and features; ``signed`` also sets a tenth of the
    feature values to -0.0 and some to -inf (a pillar whose max is -inf
    reads 0 in both packages; -0.0 and +0.0 compare equal)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-11.0, 11.0, size=(N, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3.5, 3.5, N)
    pts[:400] = pts[:400] * np.float32(0.1)  # crowded pillars: long runs
    valid = rng.uniform(size=N) > 0.08
    feats = rng.normal(size=(N, c)).astype(np.float32)
    feats[::5] = -np.abs(feats[::5])
    feats[::7] = np.abs(feats[::7])
    feats[1::9] = feats[0::9][: len(feats[1::9])]  # exact ties in the max
    if signed:
        draw = rng.uniform(size=feats.shape)
        feats[draw < 0.1] = -0.0
        feats[draw > 0.98] = -np.inf
    cfg_j, cfg_p = JV.PillarConfig(**grid), PV.PillarConfig(**grid)
    jgrid = JV.voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), cfg_j)
    pgrid = PV.voxelize_pillars(_t(pts)[None], _t(valid)[None], cfg_p)
    jf = jnp.asarray(feats).astype(getattr(jnp, dtype))
    pf = _t(feats)[None].to(getattr(torch, dtype))
    return rng, jgrid, pgrid, jf, pf


def _grad_check(got, want, exact):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("route,dtype,c,signed", [
    pytest.param(route, dtype, 32, False, id=f"{route}-{dtype}")
    for route in ("resident", "table", "stream") for dtype in ("float32", "bfloat16")
] + [
    # The stream route's max (K2 max) at the dynamic-image loss's width, and
    # on features with -0.0 and -inf beside the all-negative pillars.
    pytest.param("stream", "float32", 1, False, id="stream-float32-c1"),
    pytest.param("stream", "float32", 32, True, id="stream-float32-signed"),
])
def test_scatter_max_and_gather_match_interpreted_kernels(monkeypatch, route, dtype, c,
                                                          signed):
    grid = _shrink(monkeypatch, route)
    counts = _count_wrappers(monkeypatch)
    rng, jgrid, pgrid, jf, pf = _case(1, grid, c, dtype, signed)
    rows = pgrid.grid_shape[0] * pgrid.grid_shape[1]
    assert PV._route(rows, N, c) == _reference_route(rows, N, c) == route
    w_max = rng.normal(size=pgrid.grid_shape + (c,)).astype(np.float32)

    # scatter_max: values, and the gradient of sum(out * w) (a plain take in both).
    jimg = np.asarray(JV.scatter_max(jf, jgrid).astype(jnp.float32))
    jgrad = jax.grad(lambda f: (JV.scatter_max(f, jgrid).astype(jnp.float32) * w_max).sum())(jf)
    pf.requires_grad_()
    img = PV.scatter_max(pf, pgrid)
    assert img.dtype == pf.dtype and img.shape == (1, *pgrid.grid_shape, c)
    np.testing.assert_array_equal(img[0].detach().float().numpy(), jimg)
    assert (jimg == 0).any()  # empty pillars read 0
    (img.float() * _t(w_max)).sum().backward()
    _grad_check(pf.grad[0], jgrad, exact=True)

    # gather_pillars of a 65-channel image: values and the image gradient.
    image = rng.normal(size=pgrid.grid_shape + (65,)).astype(np.float32)
    w_pts = rng.normal(size=(N, 65)).astype(np.float32)
    jimage = jnp.asarray(image).astype(getattr(jnp, dtype))
    jout = JV.gather_pillars(jimage, jgrid)
    jgrad = jax.grad(lambda im: (JV.gather_pillars(im, jgrid).astype(jnp.float32)
                                 * w_pts).sum())(jimage)
    pimage = _t(image)[None].to(getattr(torch, dtype)).requires_grad_()
    out = PV.gather_pillars(pimage, pgrid)
    assert out.dtype == pimage.dtype
    np.testing.assert_array_equal(out[0].detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    (out.float() * _t(w_pts)[None]).sum().backward()
    _grad_check(pimage.grad[0], jgrad, exact=route == "stream")

    scatter, gather_or_sum = WRAPPERS[route]
    want = {scatter: 1}
    if route == "resident":
        want.update(gather_rows=1, segment_rows_sum=1)
    else:
        want[gather_or_sum] = 1
    assert counts == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["resident", "table", "stream"])
def test_scatter_mean_matches_interpreted_kernels(monkeypatch, route, dtype):
    grid = _shrink(monkeypatch, route)
    counts = _count_wrappers(monkeypatch)
    rng, jgrid, pgrid, jf, pf = _case(2, grid, 7, dtype)
    w = rng.normal(size=pgrid.grid_shape + (7,)).astype(np.float32)
    jmean = JV.scatter_mean(jf, jgrid)
    jgrad = jax.grad(lambda f: (JV.scatter_mean(f, jgrid).astype(jnp.float32) * w).sum())(jf)
    pf.requires_grad_()
    mean = PV.scatter_mean(pf, pgrid)
    assert mean.dtype == pf.dtype and mean.shape == (1, *pgrid.grid_shape, 7)
    np.testing.assert_array_equal(mean[0].detach().float().numpy(),
                                  np.asarray(jmean.astype(jnp.float32)))
    (mean.float() * _t(w)).sum().backward()
    _grad_check(pf.grad[0], jgrad, exact=False)
    sums = {"resident": "segment_rows_sum", "table": "scatter_sum_rows",
            "stream": "sorted_scatter_sum_rows"}
    assert counts == {sums[route]: 1}


def test_fused_sweeps_match_the_reference(monkeypatch):
    """A toy grid that is not resident, three 600-point sweeps whose
    concatenated stream still takes the table route: both packages fuse
    (one scatter), and the images equal the reference's and the per-sweep
    ones; the fused gradient equals the per-sweep gradient."""
    grid = dict(x_range=(-10.0, 10.0), y_range=(-8.4, 8.4), voxel_size=(0.4, 0.4))
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    for mod, name, value in ((JV, "_VMEM_BUDGET_BYTES", 64 * 1024),
                             (JV, "_BAND_BUDGET_BYTES", 256 * 1024),
                             (PV, "_RESIDENT_BYTES", 64 * 1024)):
        monkeypatch.setattr(mod, name, value)
    calls = []
    inner = JV._scatter_rows_pallas
    monkeypatch.setattr(JV, "_scatter_rows_pallas",
                        lambda *a, **k: calls.append(k["num_rows"]) or inner(*a, **k))
    counts = _count_wrappers(monkeypatch)
    rng = np.random.default_rng(3)
    cfg_j, cfg_p = JV.PillarConfig(**grid), PV.PillarConfig(**grid)
    pts = [rng.uniform(-11, 11, size=(600, 3)).astype(np.float32) for _ in range(3)]
    feats = [rng.normal(size=(600, 16)).astype(np.float32) for _ in range(3)]
    jgrids = [JV.voxelize_pillars(jnp.asarray(p), None, cfg_j) for p in pts]
    ref = JV.scatter_max_multi([jnp.asarray(f) for f in feats], jgrids)
    rows = 42 * 50
    assert calls == [3 * rows]
    pgrids = [PV.voxelize_pillars(_t(p)[None], None, cfg_p) for p in pts]
    pfeats = [_t(f)[None].requires_grad_() for f in feats]
    outs = PV.scatter_max_multi(pfeats, pgrids)
    assert counts == {"scatter_max_rows": 1}
    w = [_t(rng.normal(size=(1, 42, 50, 16)).astype(np.float32)) for _ in range(3)]
    sum((o * wi).sum() for o, wi in zip(outs, w)).backward()
    for k in range(3):
        np.testing.assert_array_equal(outs[k][0].detach().numpy(), np.asarray(ref[k]))
        f = _t(feats[k])[None].requires_grad_()
        one = PV.scatter_max(f, pgrids[k])
        (one * w[k]).sum().backward()
        assert torch.equal(one, outs[k]) and torch.equal(f.grad, pfeats[k].grad)


OVERRIDES = {
    "pillar.voxel_size": (0.4, 0.4),
    "pillar.x_range": (-12.8, 12.8),
    "pillar.y_range": (-12.8, 12.8),
    "depths": (16, 32),
    "refine.num_query": 256,
    "refine.num_ref": 512,
}
SHIFT = np.array([0.6, -0.2, 0.0], np.float32)
MARGIN = 1e-3
ATOL = 1e-4


def test_slice_on_the_resident_route_matches_interpreted_jax(monkeypatch):
    """The toy seflowpp forward at 64x64: JAX pools with K3 max and gathers
    with K4 (interpreted); the port takes the same route."""
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    counts = _count_wrappers(monkeypatch)
    n, b = 512, 2
    jm, _ = JF.make_model("seflowpp", **OVERRIDES)
    zeros = tuple(jnp.zeros((n, 3), jnp.float32) for _ in range(3))
    ones = tuple(jnp.ones((n,), bool) for _ in range(3))
    params = jax.jit(lambda k: jm.init(k, zeros, ones, None))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["UNet_0"]["Conv_0"]["bias"][64] = -1.2  # dynamic logit
    params["params"]["DeFlowGRUDecoder_0"]["Dense_3"]["bias"][3] = 0.1  # gate
    rng = np.random.default_rng(0)
    pc0 = lidar_like_cloud(rng, b, n) * np.float32(0.25)
    pc1 = pc0 + SHIFT + rng.normal(0, 0.02, pc0.shape).astype(np.float32)
    pch = pc0 - SHIFT
    valid = np.arange(n)[None].repeat(b, 0) < int(n * 0.92)
    dt0 = rng.uniform(0, 0.1, (b, n)).astype(np.float32)
    model, cfg = PF.make_model("seflowpp", device="cpu", **OVERRIDES)
    model.load_state_dict(flax_to_torch(params, cfg))
    rows = cfg.pillar.num_pillars
    assert PV._route(rows, n, 32) == _reference_route(rows, n, 32) == "resident"
    t = torch.from_numpy
    with torch.inference_mode():
        flow, aux = model((t(pc0), t(pc1), t(pch)), (t(valid),) * 3, with_aux=True,
                          dts=(t(dt0), t(dt0)))
    assert counts == {"scatter_max_resident_rows": 3, "gather_rows": 1}
    apply = jax.jit(lambda p, s, v, d: jm.apply(p, s, v, with_aux=True, dts=(d, d)))
    excluded = 0
    for i in range(b):
        ref_flow, ref = apply(params, (jnp.asarray(pc0[i]), jnp.asarray(pc1[i]),
                                       jnp.asarray(pch[i])),
                              (jnp.asarray(valid[i]),) * 3, jnp.asarray(dt0[i]))
        ref = {k: np.asarray(v) for k, v in ref.items()}
        gate, dyn = aux["gate_logit"][i].numpy(), aux["dyn_logit"][i].numpy()
        np.testing.assert_allclose(gate, ref["gate_logit"], atol=ATOL)
        np.testing.assert_allclose(dyn, ref["dyn_logit"], atol=ATOL)
        # Discrete decisions may differ only within MARGIN of their
        # threshold; the points downstream of such a flip are left out.
        slot, rslot = aux["slot"][i].numpy(), ref["slot"]
        out = np.zeros(n, bool)
        occ = dyn.reshape(32, 2, 32, 2).max((1, 3))
        rocc = ref["dyn_logit"].reshape(32, 2, 32, 2).max((1, 3))
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
        excluded += out.sum()
        np.testing.assert_array_equal(slot[~out], rslot[~out])
        np.testing.assert_allclose(flow[i].numpy()[~out], np.asarray(ref_flow)[~out],
                                   atol=ATOL)
        assert (gate > 0).mean() > 0.05 and np.unique(rslot[rslot >= 0]).size >= 2
    assert excluded < 0.01 * b * n
