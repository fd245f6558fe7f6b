"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU host, which has none:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.) The tests
marked ``cuda`` need a card and skip without one; the others check the
plain versions and the wrappers' CPU behaviour against numpy loops.

Tolerances: scatter-max bitwise (max does not depend on order);
scatter-add (``scatter_sum_rows``, ``segment_rows_sum``) within
``1e-5 * sum|x| + 1e-6`` per cell (fp32 atomics add in no fixed order);
NN squared distances, plain and fused, within ``1e-5 * (|q|^2 + |r|^2) +
1e-6`` (the kernels compute ``sum((q - r)^2)``, the plain versions
``|q|^2 + |r|^2 - 2 q.r``), the kernel's argmin at a distance equal to the
plain min within the same bound, and exact duplicates resolved to the
lowest index."""

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
