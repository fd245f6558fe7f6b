"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU host, which has none:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.) The tests
marked ``cuda`` need a card and skip without one; the others check the
plain versions and the wrappers' CPU behaviour against numpy loops.

Tolerances: scatter-max bitwise (max does not depend on order); NN squared
distances within ``1e-5 * (|q|^2 + |r|^2) + 1e-6`` (the kernel computes
``sum((q - r)^2)``, the plain version ``|q|^2 + |r|^2 - 2 q.r``), the
kernel's argmin at a distance equal to the plain min within the same bound,
and exact duplicates resolved to the lowest index."""

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
    with pytest.raises(RuntimeError):
        PV.scatter_max_rows(p, f.clone().requires_grad_(), rows)


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
