"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU host, which has none:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.) The tests
marked ``cuda`` need a card and skip without one; the others check the
plain versions and the wrappers' CPU behaviour against numpy loops.

Tolerances: scatter-max (``scatter_max_rows``, ``scatter_max_resident_rows``,
``sorted_scatter_max_rows``) and the gather (``gather_rows``) bitwise (max
does not depend on order); scatter-add (``scatter_sum_rows``,
``segment_rows_sum``) within ``1e-5 * sum|x| + 1e-6`` per cell (fp32 atomics
add in no fixed order); the sorted sum (``sorted_scatter_sum_rows``) within
that bound of the plain version on the card, and bitwise from launch to
launch and against the plain version on the CPU (both add in stream order);
K10's sorted sum (``sorted_segment_sum``, with and without bf16 rounding)
the same way; the sorted gathers K11 (``sorted_segment_gather``) and K5
(``sorted_gather_rows``) bitwise; NN squared distances, plain and fused, within ``1e-5 * (|q|^2 + |r|^2) +
1e-6`` (the kernels compute ``sum((q - r)^2)``, the plain versions
``|q|^2 + |r|^2 - 2 q.r``), the kernel's argmin at a distance equal to the
plain min within the same bound, and exact duplicates resolved to the
lowest index. k-NN distances: bitwise on quarter-metre grid coordinates
(exact in both forms, so ties collapse alike), and within the NN bound as
sets on float coordinates (a near-tie may collapse in one form only)."""

import numpy as np
import pytest
import torch

from himo_tpu_torch.ops import nn as PNN
from himo_tpu_torch.ops import voxelize as PV


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scatter_case(rng, b=2, n=20000, c=32, rows=128 * 128):
    pids = rng.integers(0, rows, size=(b, n)).astype(np.int32)
    pids[rng.uniform(size=(b, n)) < 0.08] = rows  # trash
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    feats[:, ::5] = -np.abs(feats[:, ::5])  # all-negative pillars exist
    return pids, feats, rows


def _nn_case(rng, n, m, scale):
    q = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    r = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    r[m // 2 : m // 2 + 10] = r[:10]  # exact duplicates: lowest index wins
    q[:5] = r[:5]
    qv = rng.uniform(size=n) > 0.15
    rv = rng.uniform(size=m) > 0.15
    qv[:5] = True
    rv[:10] = True
    rv[m // 2 : m // 2 + 10] = True
    return q, r, qv, rv


def test_scatter_max_plain_matches_numpy_loop():
    rng = np.random.default_rng(0)
    pids, feats, rows = _scatter_case(rng, b=2, n=3000, c=5, rows=400)
    before = PV.scatter_max_rows.launches
    got = PV.scatter_max_rows(_t(pids), _t(feats), rows).numpy()
    assert PV.scatter_max_rows.launches == before  # CPU: no kernel launch
    want = np.full((2, rows, 5), -np.inf, np.float32)
    for b in range(2):
        for i in range(pids.shape[1]):
            if pids[b, i] < rows:
                want[b, pids[b, i]] = np.maximum(want[b, pids[b, i]], feats[b, i])
    want[np.isneginf(want)] = 0.0
    np.testing.assert_array_equal(got, want)
    assert not np.signbit(got[got == 0]).any()  # zeros come out as +0.0


def test_nn_plain_matches_brute_force():
    rng = np.random.default_rng(1)
    q, r, qv, rv = _nn_case(rng, 300, 500, 10.0)
    d2, idx = PNN.nn_argmin(_t(q)[None], _t(r)[None], _t(qv)[None], _t(rv)[None])
    dmin = PNN.nn_distance_sq(_t(q)[None], _t(r)[None], _t(qv)[None], _t(rv)[None])
    full = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    full[:, ~rv] = np.inf
    tol = 1e-5 * ((q * q).sum(-1) + (r * r).sum(-1).max()) + 1e-6
    best = full.min(1)
    assert (np.abs(d2[0].numpy() - best)[qv] <= tol[qv]).all()
    assert (np.abs(dmin[0].numpy() - best)[qv] <= tol[qv]).all()
    chosen = full[np.arange(300), idx[0].numpy()]
    assert (np.abs(chosen - best)[qv] <= tol[qv]).all()
    assert (idx[0, :5].numpy() == np.arange(5)).all()
    assert (d2[0].numpy()[~qv] == 0).all() and (idx[0].numpy()[~qv] == 0).all()


@pytest.mark.cuda
def test_scatter_max_kernel_bitwise_equals_plain(cuda_device):
    rng = np.random.default_rng(11)
    pids, feats, rows = _scatter_case(rng)
    p, f = _t(pids).to(cuda_device), _t(feats).to(cuda_device)
    before = PV.scatter_max_rows.launches
    got = PV.scatter_max_rows(p, f, rows)
    assert PV.scatter_max_rows.launches == before + 1
    want = PV._scatter_max_rows_plain(p, f, rows)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(TypeError):
        PV.scatter_max_rows(p, f.double(), rows)
    # The kernel serves scatter_max's autograd forward: grad inputs pass,
    # and the raw kernel output carries no graph.
    out = PV.scatter_max_rows(p, f.clone().requires_grad_(), rows)
    assert not out.requires_grad and torch.equal(out, got)


@pytest.mark.cuda
def test_scatter_max_bf16_through_fp32(cuda_device):
    rng = np.random.default_rng(13)
    cfg = PV.PillarConfig(x_range=(-12.8, 12.8), y_range=(-12.8, 12.8))
    pts = _t(rng.uniform(-14, 14, size=(2, 4000, 3)).astype(np.float32)).to(cuda_device)
    grid = PV.voxelize_pillars(pts, None, cfg)
    feats = _t(rng.normal(size=(2, 4000, 32)).astype(np.float32)).to(cuda_device)
    feats = feats.to(torch.bfloat16)
    got = PV.scatter_max(feats, grid)
    want = PV._scatter_max_rows_plain(
        grid.pillar_ids, feats.float(), 128 * 128
    ).reshape(2, 128, 128, 32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1000, 3000), (4096, 8192), (129, 1025)])
def test_nn_kernels_match_plain(cuda_device, n, m):
    rng = np.random.default_rng(n)
    q, r, qv, rv = _nn_case(rng, n, m, 20.0)
    qs = PNN._pad_coords(_t(q)[None].to(cuda_device), _t(qv)[None].to(cuda_device))
    rs = PNN._pad_coords(_t(r)[None].to(cuda_device), _t(rv)[None].to(cuda_device))
    before = (PNN.nn_argmin_rows.launches, PNN.nn_min_rows.launches)
    d, i = PNN.nn_argmin_rows(qs, rs)
    dm = PNN.nn_min_rows(qs, rs)
    assert (PNN.nn_argmin_rows.launches, PNN.nn_min_rows.launches) == (
        before[0] + 1, before[1] + 1
    )
    pd, _ = PNN._nn_argmin_plain(qs, rs)
    torch.cuda.synchronize()
    qn = (qs * qs).sum(-1)
    tol = 1e-5 * (qn + (rs * rs).sum(-1)[0, i[0].long()]) + 1e-6
    valid = _t(qv).to(cuda_device)
    assert ((d - pd).abs() <= tol)[0, valid].all()
    assert torch.equal(d, dm)
    direct = ((qs[0] - rs[0, i[0].long()]) ** 2).sum(-1)
    assert ((direct - pd[0]).abs() <= tol[0])[valid].all()
    assert (i[0, :5].cpu().numpy() == np.arange(5)).all()
    with pytest.raises(RuntimeError):
        PNN.nn_min_rows(qs.clone().requires_grad_(), rs)


def _sum_case(rng, b, n, c, rows):
    ids = rng.integers(0, rows, size=(b, n)).astype(np.int32)
    ids[rng.uniform(size=(b, n)) < 0.08] = rows  # skipped
    ids[:, :50] = 3  # many points onto one row
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    vals[:, ::7, : c // 2] = 0.0  # zero cotangents, skipped by the kernel
    return ids, vals


def _sum_loop(ids, vals, rows):
    b, n, c = vals.shape
    out = np.zeros((b, rows, c), np.float64)
    mag = np.zeros((b, rows, c), np.float64)
    for bi in range(b):
        for i in range(n):
            if 0 <= ids[bi, i] < rows:
                out[bi, ids[bi, i]] += vals[bi, i]
                mag[bi, ids[bi, i]] += np.abs(vals[bi, i])
    return out, mag


def test_scatter_sum_plain_versions_match_numpy_loop():
    rng = np.random.default_rng(2)
    for c in (65, 3):
        ids, vals = _sum_case(rng, 2, 1500, c, 300)
        want, mag = _sum_loop(ids, vals, 300)
        tol = 1e-5 * mag + 1e-6
        before = (PV.scatter_sum_rows.launches, PNN.segment_rows_sum.launches)
        for got in (PV.scatter_sum_rows(_t(ids), _t(vals), 300),
                    PNN.segment_rows_sum(_t(vals), _t(ids), 300)):
            assert got.shape == (2, 300, c) and got.dtype == torch.float32
            assert (np.abs(got.numpy() - want) <= tol).all()
        assert (PV.scatter_sum_rows.launches, PNN.segment_rows_sum.launches) == before


def _fused_case(rng, n, m, scale):
    q, r, qv, rv = _nn_case(rng, n, m, scale)
    q[n - 5 :] = q[:5]  # duplicate queries: column-side ties
    qv[n - 5 :] = True
    qd = qv & (rng.uniform(size=n) > 0.5)
    rd = rv & (rng.uniform(size=m) > 0.5)
    rd[:10] = rd[m // 2 : m // 2 + 10] = True
    qd[:5] = qd[n - 5 :] = True
    pen = [np.where(x, 0.0, 1e14).astype(np.float32) for x in (qv, qd, rv, rd)]
    return q, r, pen


def test_fused_nn_plain_matches_brute_force():
    rng = np.random.default_rng(3)
    n, m = 300, 257
    q, r, pen = _fused_case(rng, n, m, 10.0)
    outs = PNN.fused_nn_idx(_t(q)[None], _t(r)[None], *(_t(p)[None] for p in pen))
    full = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    tol_q = 1e-5 * ((q * q).sum(-1) + (r * r).sum(-1).max()) + 1e-6
    tol_r = 1e-5 * ((r * r).sum(-1) + (q * q).sum(-1).max()) + 1e-6
    for k, (mat, pens, tol) in enumerate(((full, pen[2], tol_q), (full, pen[3], tol_q),
                                          (full.T, pen[0], tol_r), (full.T, pen[1], tol_r))):
        live = pens == 0
        best = np.where(live[None], mat, np.inf).min(1)
        d, i = outs[k][0].numpy(), outs[k + 4][0].numpy()
        assert (np.abs(d - best) <= tol).all()
        assert live[i].all()  # a masked point never wins
        assert (np.abs(mat[np.arange(len(i)), i] - best) <= tol).all()
    assert (outs[4][0, :5].numpy() == np.arange(5)).all()
    assert (outs[6][0, :5].numpy() == np.arange(5)).all()
    mins = PNN.fused_nn(_t(q)[None], _t(r)[None], *(_t(p)[None] for p in pen))
    assert all(torch.equal(a, b) for a, b in zip(mins, outs[:4]))


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", [(65, 128 * 128), (3, 16384), (3, 4096)])
def test_scatter_sum_kernels_match_plain(cuda_device, c, rows):
    rng = np.random.default_rng(c + rows)
    ids, vals = _sum_case(rng, 2, 20000, c, rows)
    i, v = _t(ids).to(cuda_device), _t(vals).to(cuda_device)
    before = (PV.scatter_sum_rows.launches, PNN.segment_rows_sum.launches)
    got = PV.scatter_sum_rows(i, v, rows)
    seg = PNN.segment_rows_sum(v, i, rows)
    assert (PV.scatter_sum_rows.launches, PNN.segment_rows_sum.launches) == (
        before[0] + 1, before[1] + 1
    )
    want = PV._scatter_sum_rows_plain(i, v, rows)
    mag = PV._scatter_sum_rows_plain(i, v.abs(), rows)
    torch.cuda.synchronize()
    tol = 1e-5 * mag + 1e-6
    assert ((got - want).abs() <= tol).all() and ((seg - want).abs() <= tol).all()
    with pytest.raises(TypeError):
        PNN.segment_rows_sum(v, i.long(), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 5, 31])
def test_segment_rows_sum_narrow_kernel_matches_plain(cuda_device, c):
    """K3 sum's one-thread-per-point kernel (C < 32) within 1e-5 * sum|x| +
    1e-6 of its plain version: 3 frames of 5,003 points (not a multiple of
    the block), ids below 0 and at or past ``rows`` skipped, one crowded
    row, zero values. The table is zeroed by the entry point itself: the
    output lands on freed memory filled with NaN, and an empty stream
    gives a zero table."""
    rng = np.random.default_rng(60 + c)
    b, n, rows = 3, 5003, 1000
    ids, vals = _sum_case(rng, b, n, c, rows)
    ids[:, 100:140] = -3
    ids[:, 140:160] = rows + 1000
    i, v = _t(ids).to(cuda_device), _t(vals).to(cuda_device)
    junk = torch.full((4 * b * rows * c,), float("nan"), device=cuda_device)
    del junk
    before = PNN.segment_rows_sum.launches
    got = PNN.segment_rows_sum(v, i, rows)
    empty = PNN.segment_rows_sum(v[:, :0].contiguous(), i[:, :0].contiguous(), rows)
    assert PNN.segment_rows_sum.launches == before + 2
    want = PNN._segment_rows_sum_plain(v, i, rows)
    mag = PNN._segment_rows_sum_plain(v.abs(), i, rows)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-5 * mag + 1e-6).all()
    assert torch.equal(empty, torch.zeros_like(empty))
    loop, _ = _sum_loop(ids, vals, rows)
    assert np.abs(got.cpu().numpy() - loop).max() <= 1e-5 * mag.max().item() + 1e-6


@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream(cuda_device):
    """The launch helper reads PyTorch's current stream: inside a
    ``torch.cuda.stream`` context the raw handle is the side stream's, and
    the launches there give the plain versions' results."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    rng = np.random.default_rng(61)
    ids, vals = _sum_case(rng, 2, 3000, 3, 500)
    sids = np.sort(ids, axis=1)
    i, v, si = (_t(a).to(cuda_device) for a in (ids, vals, sids))
    image = _t(rng.normal(size=(2, 500, 33)).astype(np.float32)).to(cuda_device)
    raw = torch._C._cuda_getCurrentRawStream
    index = v.get_device()
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    assert raw(index) == torch.cuda.current_stream().cuda_stream
    with torch.cuda.stream(side):
        assert raw(index) == side.cuda_stream != torch.cuda.default_stream().cuda_stream
        got_sum = PNN.segment_rows_sum(v, i, 500)
        got_gather = PM.sorted_segment_gather(image, si, True)
    side.synchronize()
    want = PNN._segment_rows_sum_plain(v, i, 500)
    mag = PNN._segment_rows_sum_plain(v.abs(), i, 500)
    assert ((got_sum - want).abs() <= 1e-5 * mag + 1e-6).all()
    assert torch.equal(got_gather, PM._sorted_segment_gather_plain(image, si, True))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1000, 3000), (16384, 16384), (129, 1025)])
def test_fused_nn_kernels_match_plain(cuda_device, n, m):
    rng = np.random.default_rng(n + 7 * m)
    q, r, pen = _fused_case(rng, n, m, 20.0)
    args = [_t(x)[None].to(cuda_device) for x in (q, r, *pen)]
    before = (PNN.fused_nn.launches, PNN.fused_nn_idx.launches)
    outs = PNN.fused_nn_idx(*args)
    mins = PNN.fused_nn(*args)
    assert (PNN.fused_nn.launches, PNN.fused_nn_idx.launches) == (
        before[0] + 1, before[1] + 1
    )
    plain = PNN._fused_nn_plain(*args)
    torch.cuda.synchronize()
    qs, rs = args[0][0], args[1][0]
    # Output k: (its queries, the points searched, their penalties).
    sides = ((qs, rs, args[4]), (qs, rs, args[5]), (rs, qs, args[2]), (rs, qs, args[3]))
    for k, (src, dst, pen) in enumerate(sides):
        live = pen[0] == 0
        idx = outs[k + 4][0].long()
        tol = 1e-5 * ((src * src).sum(-1) + (dst[idx] ** 2).sum(-1)) + 1e-6
        d, pd = outs[k][0], plain[k][0]
        assert ((d - pd).abs() <= tol).all(), k
        assert torch.equal(d, mins[k][0]), k
        direct = ((src - dst[idx]) ** 2).sum(-1)
        assert ((direct - pd).abs() <= tol).all(), k
        assert live[idx].all(), k  # a masked point never wins
    assert (outs[4][0, :5].cpu().numpy() == np.arange(5)).all()
    assert (outs[6][0, :5].cpu().numpy() == np.arange(5)).all()


def _grid_penalties(rng, b, n, m):
    """qa, qd (b, n) and ra, rd (b, m): 0 live, _MASK_BIG masked."""
    qv, rv = rng.random((b, n)) < 0.85, rng.random((b, m)) < 0.85
    qd, rd = qv & (rng.random((b, n)) < 0.5), rv & (rng.random((b, m)) < 0.5)
    return [np.where(x, 0.0, PNN._MASK_BIG).astype(np.float32) for x in (qv, qd, rv, rd)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(2, 129, 1025), (2, 1000, 3000), (1, 33, 4097),
                                   (8, 4096, 8192)])
def test_nn_argmin_kernel_bitwise_on_grid(cuda_device, b, n, m):
    """Grid coordinates: K7's distances and indices equal the plain
    version's bit for bit (exact distances, first-min ties)."""
    rng = np.random.default_rng(b * n + m)
    q, r = (_t(a).to(cuda_device) for a in _grid_knn_case(rng, b, n, m))
    d, i = PNN.nn_argmin_rows(q, r)
    pd, pi = PNN._nn_argmin_plain(q, r)
    torch.cuda.synchronize()
    assert torch.equal(d, pd) and torch.equal(i, pi)


def _grid_min_case(rng, b, n, m):
    """``_grid_knn_case`` at any n, m >= 1: grid coordinates, duplicate
    references and queries sitting on references where the sizes allow."""
    q = rng.integers(-32, 33, size=(b, n, 3)).astype(np.float32) / 4
    r = rng.integers(-32, 33, size=(b, m, 3)).astype(np.float32) / 4
    k = min(20, m // 2)
    r[:, m // 2 : m // 2 + k] = r[:, :k]
    j = min(10, n, m)
    q[:, :j] = r[:, :j]
    return q, r


def _f32_bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(2, 129, 1025), (2, 1000, 3000), (1, 33, 4097),
                                   (2, 129, 300), (2, 200, 77), (1, 1, 300), (2, 257, 1),
                                   (1, 1, 1), (8, 4096, 8192)])
def test_nn_min_kernel_bitwise_on_grid(cuda_device, b, n, m):
    """Grid coordinates: K6's distances equal its plain version's and K7's
    d2 bit for bit. The shapes cross K6's block of 256 queries and its 16
    warp segments (whole 32-reference steps: below 16 x 32 references the
    trailing warps get none), with one query, one reference, and the
    refine head's B8 4,096 x 8,192."""
    rng = np.random.default_rng(b * n + 5 * m)
    q, r = (_t(a).to(cuda_device) for a in _grid_min_case(rng, b, n, m))
    before = PNN.nn_min_rows.launches
    d = PNN.nn_min_rows(q, r)
    assert PNN.nn_min_rows.launches == before + 1
    pd = PNN._nn_min_plain(q, r)
    d7, _ = PNN.nn_argmin_rows(q, r)
    torch.cuda.synchronize()
    assert _f32_bits_equal(d, pd) and _f32_bits_equal(d, d7)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(2, 1000, 3000), (8, 4096, 8192), (8, 8192, 4096),
                                   (1, 65536, 65536)])
def test_nn_min_kernel_equals_argmin_d2_on_uniform_clouds(cuda_device, b, n, m):
    """Uniform float clouds with exact duplicates: K6's distances equal
    K7's d2 bit for bit (both fold the same direct form, and a min does not
    depend on the order of its fold), so ``nn_distance_sq`` gives the same
    value with a gradient (K7) and without (K6)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + m)
    q = torch.rand(b, n, 3, device=cuda_device, generator=gen) * 80.0 - 40.0
    r = torch.rand(b, m, 3, device=cuda_device, generator=gen) * 80.0 - 40.0
    r[:, m // 2 : m // 2 + 64] = r[:, :64]
    q[:, :32] = r[:, :32]
    d = PNN.nn_min_rows(q, r)
    d7, _ = PNN.nn_argmin_rows(q, r)
    torch.cuda.synchronize()
    assert _f32_bits_equal(d, d7)
    assert (d[:, :32] == 0).all()
    with torch.no_grad():
        plain_path = PNN.nn_distance_sq(q, r)
    grad_path = PNN.nn_distance_sq(q.clone().requires_grad_(), r)
    assert grad_path.requires_grad
    assert _f32_bits_equal(plain_path, grad_path.detach())


@pytest.mark.cuda
def test_nn_min_kernel_non_finite_coordinates(cuda_device):
    """NaN and +-inf coordinates: a NaN distance never wins (``fminf``
    skips it, as a strict ``<`` would), a +inf one never lowers a min, and
    a query with no finite distance (a non-finite coordinate, or no finite
    reference: frame 2) gets +inf; K7's d2 agrees."""
    rng = np.random.default_rng(31)
    b, n, m = 3, 1000, 3000
    q, r = _grid_min_case(rng, b, n, m)
    bad = {}
    for name, pts in (("q", q), ("r", r)):
        rows = rng.random(pts.shape[:2]) < (0.1 if name == "q" else 0.2)
        axis = rng.integers(0, 3, size=pts.shape[:2])
        value = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), size=pts.shape[:2])
        pts[rows, axis[rows]] = value[rows]
        bad[name] = rows
    r[2] = np.nan
    bad["r"][2] = True
    want = np.full((b, n), np.inf, np.float32)
    for f in range(b):
        keep = ~bad["r"][f]
        if keep.any():
            full = ((q[f, :, None].astype(np.float64) - r[f, keep][None]) ** 2).sum(-1)
            want[f] = np.where(bad["q"][f], np.inf, full.min(1)).astype(np.float32)
    qt, rt = _t(q).to(cuda_device), _t(r).to(cuda_device)
    d = PNN.nn_min_rows(qt, rt)
    d7, _ = PNN.nn_argmin_rows(qt, rt)
    torch.cuda.synchronize()
    assert _f32_bits_equal(d, _t(want).to(cuda_device))
    assert _f32_bits_equal(d, d7)
    assert torch.isinf(d[2]).all() and not torch.isnan(d).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(2, 129, 1025), (2, 1000, 3000), (1, 33, 4097),
                                   (8, 16384, 16384)])
def test_fused_nn_kernels_bitwise_on_grid(cuda_device, b, n, m):
    """Grid coordinates with masks: K8's four mins and indices equal the
    plain version's bit for bit; at 8 x 16,384 x 16,384 the column mins
    meet across 16 query blocks and the rows across 4 reference segments."""
    rng = np.random.default_rng(b * n + 3 * m)
    q, r = _grid_knn_case(rng, b, n, m)
    args = [_t(x).to(cuda_device) for x in (q, r, *_grid_penalties(rng, b, n, m))]
    outs = PNN.fused_nn_idx(*args)
    mins = PNN.fused_nn(*args)
    plain = PNN._fused_nn_plain(*args)
    torch.cuda.synchronize()
    for k in range(8):
        assert torch.equal(outs[k], plain[k]), k
    for k in range(4):
        assert torch.equal(mins[k], plain[k]), k


@pytest.mark.cuda
def test_nn_kernels_falling_cloud_and_one_reference(cuda_device):
    """The re-walk's worst case, a cloud whose distance falls with the
    index (every chunk lowers every query's min), and a single reference:
    K7 and K8 bitwise against the plain versions (exact coordinates)."""
    rng = np.random.default_rng(12)
    n, m = 2000, 3000  # |r|^2 below 2^20: exact in both forms
    q = _t(rng.integers(-4, 5, size=(2, n, 3)).astype(np.float32) / 4).to(cuda_device)
    r = torch.zeros(2, m, 3, device=cuda_device)
    r[..., 0] = 2.0 + torch.arange(m, 0, -1, device=cuda_device, dtype=torch.float32) / 4
    for refs in (r, r[:, :1].contiguous()):
        k = refs.shape[1]
        d, i = PNN.nn_argmin_rows(q, refs)
        pd, pi = PNN._nn_argmin_plain(q, refs)
        pens = [torch.zeros(2, s, device=cuda_device) for s in (n, n, k, k)]
        outs = PNN.fused_nn_idx(q, refs, *pens)
        plain = PNN._fused_nn_plain(q, refs, *pens)
        torch.cuda.synchronize()
        assert torch.equal(d, pd) and torch.equal(i, pi)
        assert all(torch.equal(a, b) for a, b in zip(outs, plain))
    assert (i == 0).all()


def _grid_knn_case(rng, b, n, m):
    """Coordinates on a 1/4 m grid in [-8, 8]: every squared distance is a
    multiple of 1/16 below 2^20, exact in fp32 in both the kernel's form and
    the plain version's, and exact ties abound (the collapse rule)."""
    q = rng.integers(-32, 33, size=(b, n, 3)).astype(np.float32) / 4
    r = rng.integers(-32, 33, size=(b, m, 3)).astype(np.float32) / 4
    r[:, m // 2 : m // 2 + 20] = r[:, :20]  # exact duplicate references
    q[:, :10] = r[:, :10]
    return q, r


def test_knn_plain_matches_numpy_distinct_values():
    """The k smallest DISTINCT distances, 3.0e38 where fewer exist."""
    from himo_tpu_torch.ops import knn as PK

    rng = np.random.default_rng(4)
    q, r = _grid_knn_case(rng, 2, 150, 40)
    r[1, 5:] = r[1, 0]  # frame 1: 5 distinct references only
    for k in (1, 4, 16):
        got = PK.knn_rows(_t(q), _t(r), k).numpy()
        for b in range(2):
            full = ((q[b, :, None].astype(np.float64) - r[b, None]) ** 2).sum(-1)
            for i in range(150):
                distinct = np.unique(full[i])[:k]
                want = np.full(k, 3.0e38)
                want[: len(distinct)] = distinct
                np.testing.assert_array_equal(got[b, i], want.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1000, 3000), (129, 1025), (4096, 8192)])
def test_knn_kernel_matches_plain(cuda_device, n, m):
    """Grid coordinates: bitwise equal to the plain version for k = 1..16,
    ties collapsed alike; float coordinates: within 1e-5 * (|q|^2 + |r|^2)
    + 1e-6 as sets (chip_smoke.knn_agreement), slot by slot on >= 0.99 of
    queries."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    from himo_tpu_torch.ops import knn as PK

    rng = np.random.default_rng(n + m)
    q, r = (_t(a).to(cuda_device) for a in _grid_knn_case(rng, 2, n, m))
    for k in range(1, 17):
        before = PK.knn_rows.launches
        got = PK.knn_rows(q, r, k)
        assert PK.knn_rows.launches == before + 1
        want = PK._knn_plain(q, r, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
    assert (got[:, :10, 0] == 0).all() and (got[:, :10, 1] > 0).all()
    qf, rf, qv, rv = _nn_case(rng, n, m, 20.0)
    qs = PNN._pad_coords(_t(qf)[None].to(cuda_device), _t(qv)[None].to(cuda_device))
    rs = PNN._pad_coords(_t(rf)[None].to(cuda_device), _t(rv)[None].to(cuda_device))
    got = PK.knn_rows(qs, rs, 8)
    want = PK._knn_plain(qs, rs, 8)
    torch.cuda.synchronize()
    as_sets, slotwise, _ = chip_smoke.knn_agreement(got[0], want[0], qs[0])
    valid = _t(qv).to(cuda_device)
    assert as_sets[valid].all() and float(slotwise[valid].float().mean()) >= 0.99
    with pytest.raises(ValueError):
        PK.knn_rows(q, r, 17)
    with pytest.raises(RuntimeError):
        PK.knn_rows(q.clone().requires_grad_(), r, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 255, 1025])
@pytest.mark.parametrize("n", [1, 33, 129])
def test_knn_kernel_edges_match_plain(cuda_device, n, m):
    """K9 at every k in 1..16 on counts that leave partial query blocks,
    reference tiles and warp segments (n = 1, 33, 129; m = 1, 5, 255,
    1,025): as sets within the NN bound (``chip_smoke.knn_agreement``) and
    slot by slot; slots past the distinct distances read exactly 3.0e38
    (the +inf points padding each tile never enter a list). Then one
    reference point held m times: one distinct distance per query."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    from himo_tpu_torch.ops import knn as PK

    rng = np.random.default_rng(1000 * n + m)
    q = _t((rng.normal(size=(2, n, 3)) * 10).astype(np.float32)).to(cuda_device)
    r = _t((rng.normal(size=(2, m, 3)) * 10).astype(np.float32)).to(cuda_device)
    same = r[:, :1].expand(-1, m, -1).contiguous()
    for k in range(1, 17):
        before = PK.knn_rows.launches
        got = PK.knn_rows(q, r, k)
        assert PK.knn_rows.launches == before + 1
        want = PK._knn_plain(q, r, k)
        torch.cuda.synchronize()
        for b in range(2):
            as_sets, slotwise, _ = chip_smoke.knn_agreement(got[b], want[b], q[b])
            assert as_sets.all() and slotwise.all(), (k, b)
        assert (got[..., m:] == 3.0e38).all() and torch.isfinite(got).all(), k
        # One distance per query (the plain form's matmul may round copies
        # of one column apart, so slot 0 is held against its first slot).
        one = PK.knn_rows(q, same, k)
        plain_one = PK._knn_plain(q, same, 1)
        torch.cuda.synchronize()
        for b in range(2):
            as_sets, _, _ = chip_smoke.knn_agreement(one[b, :, :1], plain_one[b], q[b])
            assert as_sets.all(), (k, b)
        assert (one[..., 1:] == 3.0e38).all(), k


def _sorted_case(rng, b, n, c, rows, long_run=0):
    """A stream sorted by id in each frame (stable), with ids >= rows at the
    end, empty rows, and optionally one run of ``long_run`` equal ids."""
    ids = rng.integers(0, rows, size=(b, n)).astype(np.int32)
    ids[rng.uniform(size=(b, n)) < 0.08] = rows  # skipped
    ids[:, : n // 10] = rows // 2  # a crowded row
    if long_run:
        ids[0, :long_run] = 7
    vals = rng.normal(size=(b, n, c)).astype(np.float32)
    vals[:, ::5] = -np.abs(vals[:, ::5])  # all-negative rows exist
    vals[:, ::11] = -0.0
    order = np.argsort(ids, axis=1, kind="stable")
    return (np.take_along_axis(ids, order, 1),
            np.take_along_axis(vals, order[..., None], 1))


def _sequential_rows(ids, vals, rows, combine):
    """Per-row max or fp32 sum, adding in stream order from +0.0; ids
    outside [0, rows) skipped."""
    b, n, c = vals.shape
    out = np.full((b, rows, c), -np.inf if combine == "max" else 0.0, np.float32)
    for bi in range(b):
        for i in range(n):
            r = ids[bi, i]
            if 0 <= r < rows:
                out[bi, r] = (np.maximum(out[bi, r], vals[bi, i]) if combine == "max"
                              else out[bi, r] + vals[bi, i])
    if combine == "max":
        out[np.isneginf(out)] = 0.0
        out = out + np.float32(0.0)
    return out


def _sorted_sum_edges(rng, c, rows=300, n=1007):
    """Four sorted frames of n points (not a multiple of 32) for the sorted
    sums, which work over 32-position spans. Frame 0: a 100-point run (id 7)
    from position 20, across four spans, among runs of one to a few points.
    Frame 1: a hundred negative ids at its head and a hundred ids >= rows at
    its tail (both skipped). Frame 2: every id >= rows, an empty frame.
    Frame 3: its last 40 points one run on the last row, ending the frame.
    Normal values, a tenth of them -0.0."""
    def some(k, lo, hi):
        return rng.integers(lo, hi, size=k)

    ids = np.stack([
        np.concatenate([some(20, 0, 7), np.full(100, 7), some(n - 120, 8, rows)]),
        np.concatenate([some(100, -5, 0), some(n - 200, 0, rows), some(100, rows, rows + 3)]),
        some(n, rows, rows + 3),
        np.concatenate([some(n - 40, 0, rows - 1), np.full(40, rows - 1)]),
    ])
    ids = np.sort(ids, axis=1).astype(np.int32)
    vals = rng.normal(size=(4, n, c)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.1] = -0.0
    return ids, vals


def _sorted_sums(bf16_flags=(False, True)):
    """The sorted sums by name: K2 sum, and K10 with each rounding flag."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    sums = {"K2 sum": (PV.sorted_scatter_sum_rows, False)}
    for bf16 in bf16_flags:
        sums[f"K10 bf16={int(bf16)}"] = (
            lambda i, v, r, _b=bf16: PM.sorted_segment_sum(i, v, r, _b), bf16)
    return sums


@pytest.mark.parametrize("kernel", list(_sorted_sums()))
@pytest.mark.parametrize("c", [33, 65])
def test_sorted_sums_plain_edges_match_sequential_loop(c, kernel):
    """The sorted sums' plain versions on the CPU, bitwise against a
    sequential loop (``index_add_`` adds in stream order there, as the
    kernel does) on ``_sorted_sum_edges``: a run across spans, n not a
    multiple of 32, negative ids, an empty frame, a run ending the frame.
    Rows no live id reaches, and the whole empty frame, read +0.0."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    rows = 300
    ids, vals = _sorted_sum_edges(np.random.default_rng(140 + c), c, rows)
    fn, bf16 = _sorted_sums()[kernel]
    before = (PV.sorted_scatter_sum_rows.launches, PM.sorted_segment_sum.launches,
              dict(PM.sorted_segment_sum.launches_by_c))
    got = fn(_t(ids), _t(vals), rows).numpy()
    assert (PV.sorted_scatter_sum_rows.launches, PM.sorted_segment_sum.launches,
            PM.sorted_segment_sum.launches_by_c) == before
    want = _sequential_rows(ids, _round_bf16(vals) if bf16 else vals, rows, "sum")
    np.testing.assert_array_equal(got, want)
    assert (got[2] == 0).all() and not np.signbit(got[2]).any()
    reached = np.zeros((4, rows), bool)
    for b in range(4):
        reached[b, ids[b][(ids[b] >= 0) & (ids[b] < rows)]] = True
    assert not np.signbit(got[~reached]).any() and (got[~reached] == 0).all()
    assert reached[0, 7] and reached[3, rows - 1]


@pytest.mark.parametrize("c", [32, 65, 1])
def test_sorted_scatter_plain_versions_match_sequential_loop(c):
    """K2's plain versions (and the resident max's) on the CPU: the max
    bitwise, the sum bitwise too (``index_add_`` adds in stream order on
    the CPU, as the kernel does); zeros come out as +0.0."""
    rng = np.random.default_rng(c)
    rows = 300
    ids, vals = _sorted_case(rng, 2, 1200, c, rows)
    before = (PV.sorted_scatter_max_rows.launches, PV.sorted_scatter_sum_rows.launches,
              PV.scatter_max_resident_rows.launches)
    got_max = PV.sorted_scatter_max_rows(_t(ids), _t(vals), rows).numpy()
    got_sum = PV.sorted_scatter_sum_rows(_t(ids), _t(vals), rows).numpy()
    got_res = PV.scatter_max_resident_rows(_t(ids), _t(vals), rows).numpy()
    assert (PV.sorted_scatter_max_rows.launches, PV.sorted_scatter_sum_rows.launches,
            PV.scatter_max_resident_rows.launches) == before
    want_max = _sequential_rows(ids, vals, rows, "max")
    np.testing.assert_array_equal(got_max, want_max)
    np.testing.assert_array_equal(got_res, want_max)
    assert not np.signbit(got_max[got_max == 0]).any()
    np.testing.assert_array_equal(got_sum, _sequential_rows(ids, vals, rows, "sum"))


@pytest.mark.parametrize("c", [1, 3, 32, 33, 65])
def test_gather_rows_plain_matches_numpy(c):
    """K4's plain version (what the wrapper takes on the CPU, counting no
    launch) bitwise against numpy: negative ids read row 0, ids >= rows
    the last row."""
    rng = np.random.default_rng(5 + c)
    rows = 400
    image = rng.normal(size=(2, rows, c)).astype(np.float32)
    ids = rng.integers(-5, rows + 5, size=(2, 1001)).astype(np.int32)
    ids[:, :3] = (-1, rows, 2 ** 31 - 1)
    before = PV.gather_rows.launches
    got = PV.gather_rows(_t(image), _t(ids)).numpy()
    assert PV.gather_rows.launches == before
    want = np.stack([image[b, np.clip(ids[b], 0, rows - 1)] for b in range(2)])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:, 0] == image[:, 0]).all() and (got[:, 1] == image[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 1])
def test_scatter_max_resident_kernel_bitwise_equals_plain(cuda_device, c):
    rng = np.random.default_rng(17 + c)
    pids, feats, rows = _scatter_case(rng, c=c)
    p, f = _t(pids).to(cuda_device), _t(feats).to(cuda_device)
    before = (PV.scatter_max_rows.launches, PV.scatter_max_resident_rows.launches)
    got = PV.scatter_max_resident_rows(p, f, rows)
    assert (PV.scatter_max_rows.launches, PV.scatter_max_resident_rows.launches) == (
        before[0], before[1] + 1)
    want = PV._scatter_max_rows_plain(p, f, rows)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(TypeError):
        PV.scatter_max_resident_rows(p.long(), f, rows)


def _max_edge_case(rng, n, c, rows):
    """Three frames of ``n`` points for the per-row max. Frame 0: random ids,
    some negative and some >= rows (skipped); normal values, a tenth of them
    -0.0, some -inf and +inf; every third row all negative; the last row
    reached only by -0.0 and the one before it only by -inf (both read
    +0.0). Frame 1: one point per row (ids past ``rows`` skipped). Frame 2:
    only ids outside [0, rows)."""
    ids = rng.integers(0, rows, size=(3, n)).astype(np.int32)
    vals = rng.normal(size=(3, n, c)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.1] = -0.0
    vals[0, 1::97] = -np.inf
    vals[0, 2::89, 0] = np.inf
    negative = ids[0] % 3 == 0
    vals[0, negative] = -np.abs(vals[0, negative])
    ids[0, ids[0] >= rows - 2] = 0
    ids[0, 5:9], vals[0, 5:9] = rows - 1, -0.0
    ids[0, 70:74], vals[0, 70:74] = rows - 2, -np.inf
    ids[0, 10:40] = -3
    ids[0, 40:70] = rows + rng.integers(0, 3, size=30)
    ids[1] = np.arange(n)
    ids[2] = np.where(np.arange(n) % 2 == 0, rows, -1)
    return ids, vals


def _max_loop(ids, vals, rows):
    """Per-row max by a numpy loop over the points, by the reference's rule:
    rows no id in [0, rows) reaches and maxima of -inf read +0.0, and -0.0
    comes out as +0.0."""
    b, n, c = vals.shape
    out = np.full((b, rows, c), -np.inf, np.float32)
    for bi in range(b):
        for i in range(n):
            if 0 <= ids[bi, i] < rows:
                out[bi, ids[bi, i]] = np.maximum(out[bi, ids[bi, i]], vals[bi, i])
    out[np.isneginf(out)] = 0.0
    return out + np.float32(0.0)


@pytest.mark.parametrize("c", [1, 3, 32, 33, 65])
def test_scatter_max_plain_edge_cases_match_numpy_loop(c):
    """The per-row max's plain version (the K1 max and K3 max kernels' yardstick)
    bitwise against a numpy loop: -0.0, -inf and +inf values, all-negative
    rows, rows reached only by -0.0 or only by -inf (both read +0.0), one
    point per row, a frame of only ids outside [0, rows) (all +0.0)."""
    rng = np.random.default_rng(80 + c)
    rows = 50
    ids, vals = _max_edge_case(rng, 600, c, rows)
    got = PV._scatter_max_rows_plain(_t(ids), _t(vals), rows).numpy()
    want = _max_loop(ids, vals, rows)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[0, rows - 2:] == 0).all() and not np.signbit(got[0, rows - 2:]).any()
    assert (got[0, ::3] < 0).any() and np.isposinf(got).any() and not np.isneginf(got).any()
    assert (got[2] == 0).all() and not np.signbit(got[2]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300, 128 * 128])
@pytest.mark.parametrize("c", [1, 3, 32, 33, 65])
def test_scatter_max_kernels_edge_cases_bitwise(cuda_device, c, rows):
    """K1 max and K3 max (one entry point, two counters) bitwise against the
    plain version on ``_max_edge_case``'s frames: the keys of negative
    floats, -inf and +inf, the reached-row table (rows reached only by -0.0
    or only by -inf read +0.0; one point per row; a frame of trash ids
    stays +0.0); each of the two decodes forced at every C. The image and
    its table land on freed memory filled with NaN: the entry point zeroes
    both itself."""
    rng = np.random.default_rng(100 + c + rows)
    ids, vals = _max_edge_case(rng, 5003, c, rows)
    i, v = _t(ids).to(cuda_device), _t(vals).to(cuda_device)
    want = PV._scatter_max_rows_plain(i, v, rows)
    for fn in (PV.scatter_max_rows, PV.scatter_max_resident_rows):
        junk = torch.full((4 * 3 * rows * (c + 1),), float("nan"), device=cuda_device)
        del junk
        before = fn.launches
        got = fn(i, v, rows)
        assert fn.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), fn.__name__
    for flagged in (True, False):
        forced = PV._run_max_kernel(i, v, rows, flagged=flagged)
        torch.cuda.synchronize()
        assert torch.equal(forced.view(torch.int32), want.view(torch.int32)), flagged
    assert (got[2] == 0).all() and not torch.signbit(got[2]).any()
    cpu = PV._scatter_max_rows_plain(_t(ids), _t(vals), rows)
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 32, 33, 65])
def test_gather_rows_kernel_edge_cases_bitwise(cuda_device, c):
    """K4 bitwise against its plain version on the card and on the CPU:
    negative ids (row 0), ids >= rows (the last row), N = 1,001 and 7
    (multiples neither of 4 nor of the 128-position tile, so rows start
    unaligned and tiles straddle frames)."""
    rng = np.random.default_rng(110 + c)
    rows = 300
    image_np = rng.normal(size=(3, rows, c)).astype(np.float32)
    image = _t(image_np).to(cuda_device)
    for n in (1001, 7):
        ids = rng.integers(-5, rows + 5, size=(3, n)).astype(np.int32)
        ids[:, :3] = (-1, rows, 2 ** 31 - 1)
        i = _t(ids).to(cuda_device)
        before = PV.gather_rows.launches
        got = PV.gather_rows(image, i)
        assert PV.gather_rows.launches == before + 1
        want = PV._gather_rows_plain(image, i)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n
        cpu = PV._gather_rows_plain(_t(image_np), _t(ids))
        assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32)), n


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", [(65, 128 * 128), (1, 4096), (32, 300)])
def test_gather_rows_kernel_bitwise_equals_plain(cuda_device, c, rows):
    rng = np.random.default_rng(c + rows)
    image = _t(rng.normal(size=(2, rows, c)).astype(np.float32)).to(cuda_device)
    ids = rng.integers(0, rows, size=(2, 20000)).astype(np.int32)
    ids[:, :100] = rows + 5  # clamped to the last row
    ids[:, 100:200] = 0
    i = _t(ids).to(cuda_device)
    before = PV.gather_rows.launches
    got = PV.gather_rows(image, i)
    assert PV.gather_rows.launches == before + 1
    want = PV._gather_rows_plain(image, i)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[:, :100], image[:, -1:].expand(-1, 100, -1))
    with pytest.raises(TypeError):
        PV.gather_rows(image.double(), i)
    with pytest.raises(ValueError):
        PV.gather_rows(image[:, ::2], i)


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows,long_run", [(32, 512 * 64, 0), (65, 512 * 64, 0),
                                             (1, 4096, 0), (32, 4096, 50000),
                                             (33, 300, None), (65, 300, None)])
def test_sorted_scatter_kernels_match_plain(cuda_device, c, rows, long_run):
    """K2 max bitwise against the plain version; K2 sum within
    1e-5 * sum|x| + 1e-6 of the plain version on the card (atomics), bitwise
    from launch to launch and bitwise against the CPU plain version (the
    same sequential order). ``long_run`` None: ``_sorted_sum_edges``. The
    tables land on freed memory filled with NaN: every float must be
    written."""
    if long_run is None:
        ids, vals = _sorted_sum_edges(np.random.default_rng(150 + c), c, rows)
    else:
        rng = np.random.default_rng(c + rows + long_run)
        ids, vals = _sorted_case(rng, 2, max(60000, long_run + 5000), c, rows, long_run)
    i, v = _t(ids).to(cuda_device), _t(vals).to(cuda_device)
    junk = torch.full((4 * len(ids) * rows * c,), float("nan"), device=cuda_device)
    del junk
    before = (PV.sorted_scatter_max_rows.launches, PV.sorted_scatter_sum_rows.launches)
    got_max = PV.sorted_scatter_max_rows(i, v, rows)
    got_sum = PV.sorted_scatter_sum_rows(i, v, rows)
    again = PV.sorted_scatter_sum_rows(i, v, rows)
    assert (PV.sorted_scatter_max_rows.launches, PV.sorted_scatter_sum_rows.launches) == (
        before[0] + 1, before[1] + 2)
    want_max = PV._scatter_max_rows_plain(i, v, rows)
    want_sum = PV._scatter_sum_rows_plain(i, v, rows)
    mag = PV._scatter_sum_rows_plain(i, v.abs(), rows)
    torch.cuda.synchronize()
    assert torch.equal(got_max.view(torch.int32), want_max.view(torch.int32))
    assert ((got_sum - want_sum).abs() <= 1e-5 * mag + 1e-6).all()
    assert torch.equal(got_sum.view(torch.int32), again.view(torch.int32))
    cpu = PV._scatter_sum_rows_plain(_t(ids), _t(vals), rows)
    assert torch.equal(got_sum.cpu().view(torch.int32), cpu.view(torch.int32))
    with pytest.raises(TypeError):
        PV.sorted_scatter_sum_rows(i, v.double(), rows)


def _sorted_max_case(rng, c, rows):
    """Three sorted frames of 60,000 points for K2 max. Frame 0: a
    50,000-point run (id 7) crossing many warp spans, then ids on every
    3,001st row (gaps of thousands of rows), the first and the last row
    reached. Frame 1: every id >= rows. Frame 2: random ids, a hundred
    negative ones and a hundred >= rows (both skipped). Signed values: a
    tenth -0.0, some -inf, every fifth point negative."""
    n = 60000
    ids = rng.integers(0, rows, size=(3, n)).astype(np.int32)
    ids[0, :50000] = 7
    ids[0, 50000:59980] = rng.choice(np.arange(0, rows, 3001), size=9980)
    ids[0, 59980:59990] = 0
    ids[0, 59990:] = rows - 1
    ids[1] = rows + rng.integers(0, 3, size=n)
    ids[2, :100] = -3
    ids[2, 100:200] = rows + 1
    vals = rng.normal(size=(3, n, c)).astype(np.float32)
    vals[:, ::5] = -np.abs(vals[:, ::5])
    draw = rng.uniform(size=vals.shape)
    vals[draw < 0.1] = -0.0
    vals[draw > 0.999] = -np.inf
    order = np.argsort(ids, axis=1, kind="stable")
    return (np.take_along_axis(ids, order, 1),
            np.take_along_axis(vals, order[..., None], 1))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 32, 33])
def test_sorted_scatter_max_kernel_edges_bitwise(cuda_device, c):
    """K2 max bitwise against its plain version, on the card and on the CPU
    (``_sorted_max_case``: a long run across spans, gaps of thousands of
    rows, the first and last row reached, a frame of ids >= rows, negative
    ids, signed values). The table lands on freed memory filled with NaN:
    every row must be written."""
    rows = 512 * 64
    ids, vals = _sorted_max_case(np.random.default_rng(120 + c), c, rows)
    i, v = _t(ids).to(cuda_device), _t(vals).to(cuda_device)
    want = PV._scatter_max_rows_plain(i, v, rows)
    cpu = PV._scatter_max_rows_plain(_t(ids), _t(vals), rows)
    assert torch.equal(want.cpu().view(torch.int32), cpu.view(torch.int32))
    assert (cpu[0, 0] != 0).any() and (cpu[0, rows - 1] != 0).any()
    junk = torch.full((2 * 3 * rows * c,), float("nan"), device=cuda_device)
    del junk
    before = PV.sorted_scatter_max_rows.launches
    got = PV.sorted_scatter_max_rows(i, v, rows)
    assert PV.sorted_scatter_max_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[1] == 0).all() and not torch.signbit(got[1]).any()


# ------------------------------------------------ K10, K11 and K5: sorted streams


def _round_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [33, 65, 1])
def test_sorted_segment_sum_plain_matches_sequential_loop(c, bf16):
    """K10's plain version: the sequential fp32 sum of the (bf16-rounded)
    values, bitwise (``index_add_`` adds in stream order on the CPU)."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    rng = np.random.default_rng(20 + c)
    rows = 300
    ids, vals = _sorted_case(rng, 2, 1200, c, rows)
    before = PM.sorted_segment_sum.launches
    got = PM.sorted_segment_sum(_t(ids), _t(vals), rows, bf16).numpy()
    assert PM.sorted_segment_sum.launches == before
    want = _sequential_rows(ids, _round_bf16(vals) if bf16 else vals, rows, "sum")
    np.testing.assert_array_equal(got, want)
    empty = np.ones((2, rows), bool)
    for b in range(2):
        empty[b, ids[b][ids[b] < rows]] = False
    assert empty.any() and (got[empty] == 0).all()  # rows no id reaches


@pytest.mark.parametrize("c", [65, 1])
def test_sorted_gathers_plain_match_numpy(c):
    """K11's and K5's plain versions against numpy loops: ids >= rows read
    0; K11 rounds the image with ``bf16``; K5 writes each sorted position's
    row to ``order``, a random permutation here."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    rng = np.random.default_rng(30 + c)
    rows, n = 400, 900
    image = rng.normal(size=(2, rows, c)).astype(np.float32)
    ids = np.sort(rng.integers(0, rows + 3, size=(2, n)), axis=1).astype(np.int32)
    order = np.stack([rng.permutation(n) for _ in range(2)]).astype(np.int32)
    before = (PM.sorted_segment_gather.launches, PV.sorted_gather_rows.launches)
    for bf16 in (False, True):
        img = _round_bf16(image) if bf16 else image
        want = np.zeros((2, n, c), np.float32)
        for b in range(2):
            for j in range(n):
                if ids[b, j] < rows:
                    want[b, j] = img[b, ids[b, j]]
        got = PM.sorted_segment_gather(_t(image), _t(ids), bf16).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.zeros((2, n, c), np.float32)
    for b in range(2):
        for j in range(n):
            if ids[b, j] < rows:
                want[b, order[b, j]] = image[b, ids[b, j]]
    got = PV.sorted_gather_rows(_t(image), _t(ids), _t(order)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (PM.sorted_segment_gather.launches, PV.sorted_gather_rows.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,rows,long_run", [(33, 512 * 64, 0), (65, 512 * 64, 0),
                                             (1, 4096, 0), (33, 4096, 50000),
                                             (65, 4096, 50000), (33, 300, None),
                                             (65, 300, None)])
def test_sorted_segment_sum_kernel_matches_plain(cuda_device, c, rows, long_run, bf16):
    """K10 within 1e-5 * sum|x| + 1e-6 of its plain version on the card
    (index_add_'s atomics), bitwise from launch to launch and against the
    CPU plain version (the same sequential order, the same rounding).
    ``long_run`` None: ``_sorted_sum_edges``. The tables land on freed
    memory filled with NaN: every float must be written."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    if long_run is None:
        ids, vals = _sorted_sum_edges(np.random.default_rng(160 + c), c, rows)
    else:
        rng = np.random.default_rng(c + rows + long_run)
        ids, vals = _sorted_case(rng, 2, max(60000, long_run + 5000), c, rows, long_run)
    i, v = _t(ids).to(cuda_device), _t(vals).to(cuda_device)
    junk = torch.full((4 * len(ids) * rows * c,), float("nan"), device=cuda_device)
    del junk
    before = PM.sorted_segment_sum.launches
    before_c = PM.sorted_segment_sum.launches_by_c.get(c, 0)
    got = PM.sorted_segment_sum(i, v, rows, bf16)
    again = PM.sorted_segment_sum(i, v, rows, bf16)
    assert PM.sorted_segment_sum.launches == before + 2
    assert PM.sorted_segment_sum.launches_by_c[c] == before_c + 2
    want = PM._sorted_segment_sum_plain(i, v, rows, bf16)
    mag = PM._sorted_segment_sum_plain(i, v.abs(), rows, bf16)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-5 * mag + 1e-6).all()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    cpu = PM._sorted_segment_sum_plain(_t(ids), _t(vals), rows, bf16)
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
    with pytest.raises(TypeError):
        PM.sorted_segment_sum(i, v.double(), rows, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows,long_run", [(65, 512 * 64, 0), (1, 4096, 0),
                                             (65, 4096, 50000)])
def test_sorted_segment_gather_kernel_bitwise_equals_plain(cuda_device, c, rows,
                                                           long_run):
    """K11 bitwise against its plain version in both modes: empty rows,
    ids >= rows (read 0), one run of 50,000 equal ids."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    rng = np.random.default_rng(40 + c + rows + long_run)
    ids, _ = _sorted_case(rng, 2, max(60000, long_run + 5000), 1, rows, long_run)
    image = _t(rng.normal(size=(2, rows, c)).astype(np.float32)).to(cuda_device)
    i = _t(ids).to(cuda_device)
    for bf16 in (False, True):
        before = PM.sorted_segment_gather.launches
        got = PM.sorted_segment_gather(image, i, bf16)
        assert PM.sorted_segment_gather.launches == before + 1
        want = PM._sorted_segment_gather_plain(image, i, bf16)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got[i >= rows] == 0).all()
    with pytest.raises(TypeError):
        PM.sorted_segment_gather(image, i.long())
    with pytest.raises(ValueError):
        PM.sorted_segment_gather(image[:, ::2], i)


def _k11_edge_case(rng, n, rows):
    """Four frames of ``n`` sorted ids: random ids with a run across three
    128-position tiles and ids past the grid at the end; only ids >= rows;
    one run of a single id; random ids up to the last row. The flattened
    stream's tiles straddle frames when ``n`` is not a multiple of 128."""
    ids = np.sort(rng.integers(0, rows + 4, size=(4, n)), axis=1).astype(np.int32)
    if n > 300:
        ids[0, 100:300] = ids[0, 100]
    ids[1] = np.sort(rng.integers(rows, rows + 5, size=n))
    ids[2] = rows // 3
    ids[3] = np.sort(rng.integers(0, rows, size=n))
    ids[3, -1] = rows - 1
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [1, 3, 33, 65])
def test_sorted_segment_gather_kernel_edge_cases(cuda_device, c, bf16):
    """K11 bitwise against its plain version (on the card and on the CPU)
    where its tiles and 16-byte words meet their edges: N = 1,001 and N = 7
    (multiples neither of 4 nor of the 128-position tile, so rows start
    unaligned and tiles straddle frames), a run across tiles, a frame of
    only ids >= rows (all zeros), a frame that is one run."""
    from himo_tpu_torch.ops import mxu_scatter as PM

    rng = np.random.default_rng(70 + c + 2 * bf16)
    rows = 300
    image_np = rng.normal(size=(4, rows, c)).astype(np.float32)
    image = _t(image_np).to(cuda_device)
    for n in (1001, 7):
        ids = _k11_edge_case(rng, n, rows)
        i = _t(ids).to(cuda_device)
        before = PM.sorted_segment_gather.launches
        got = PM.sorted_segment_gather(image, i, bf16)
        assert PM.sorted_segment_gather.launches == before + 1
        want = PM._sorted_segment_gather_plain(image, i, bf16)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n
        cpu = PM._sorted_segment_gather_plain(_t(image_np), _t(ids), bf16)
        assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32)), n
        assert (got[1] == 0).all() and (got[2] == got[2, :1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows,long_run,b,n,trash,offset", [
    pytest.param(64, 512 * 64, 0, 2, None, False, 0, id="64-32768-0"),
    pytest.param(2, 4096, 0, 2, None, False, 0, id="2-4096-0"),
    pytest.param(64, 4096, 50000, 2, None, False, 0, id="64-4096-50000"),
    pytest.param(65, 4096, 0, 2, None, False, 0, id="C=65"),  # scalar words
    pytest.param(1, 4096, 0, 2, None, False, 0, id="C=1"),
    pytest.param(64, 512 * 64, 0, 1, 32768, False, 0, id="B=1 N=32768"),  # SegNet's
    pytest.param(64, 4096, 0, 3, 7, False, 0, id="N=7"),  # tiles across frames
    pytest.param(65, 300, 0, 3, 7, False, 0, id="N=7 C=65"),
    pytest.param(64, 4096, 0, 2, None, True, 0, id="all past rows"),
    pytest.param(65, 4096, 0, 2, None, True, 0, id="all past rows C=65"),
    pytest.param(64, 4096, 0, 2, None, False, 1, id="unaligned image"),
])
def test_sorted_gather_rows_kernel_bitwise_equals_plain(cuda_device, c, rows, long_run, b, n,
                                                        trash, offset):
    """K5 bitwise against its plain version: sorted ids with empty rows,
    ids >= rows and a 50,000-id run, and a random permutation as ``order``;
    at C = 65 and 1 (scalar words), B = 1, N = 7 (shorter than one tile, so
    a tile spans frames), a last frame whose ids are all >= rows (all
    zeros), and an image whose storage starts 4 bytes past a 16-byte
    boundary (scalar words at C = 64); and the scatter-max backward's take
    (the stable sort's order) against plain indexing."""
    rng = np.random.default_rng(50 + c + rows + long_run)
    n = n or max(60000, long_run + 5000)
    ids, _ = _sorted_case(rng, b, n, 1, rows, long_run)
    if trash:
        ids[-1] = np.sort(rows + rng.integers(0, 3, size=n))
    order = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    flat = torch.zeros(offset + b * rows * c, device=cuda_device)
    flat[offset:] = _t(rng.normal(size=b * rows * c).astype(np.float32)).to(cuda_device)
    image = flat[offset:].view(b, rows, c)
    assert image.is_contiguous() and image.data_ptr() % 16 == 4 * offset % 16
    i, o = _t(ids).to(cuda_device), _t(order).to(cuda_device)
    before = PV.sorted_gather_rows.launches
    got = PV.sorted_gather_rows(image, i, o)
    assert PV.sorted_gather_rows.launches == before + 1
    want = PV._sorted_gather_rows_plain(image, i, o)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if trash:
        assert not got[-1].view(torch.int32).any()
    pids = _t(rng.integers(0, rows + 1, size=(b, n)).astype(np.int32)).to(cuda_device)
    spids, sorder = PV._stable_sort(pids)
    got = PV.sorted_gather_rows(image, spids, sorder)
    want = PV._take_live_rows(image, pids)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        PV.sorted_gather_rows(image, i, o[:, 1:].contiguous())
