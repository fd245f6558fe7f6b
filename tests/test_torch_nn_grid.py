"""K6's, K7's and K8's plain versions on exact grid coordinates, against
numpy min and first-min loops and the JAX package's CPU paths, bit for bit.

Coordinates lie on a quarter-metre grid in [-8, 8] (as
``test_torch_kernels._grid_knn_case`` builds them): every squared distance
is a multiple of 1/16 below 2^10, exact in fp32 both as ``sum((q - r)^2)``
(the CUDA kernels' form) and as ``|q|^2 + |r|^2 - 2 q.r`` (the plain
versions' and the reference's), and exact ties abound, so the first-min
rule decides most indices. Each penalty add ``d + p`` rounds the same way
in numpy, PyTorch and JAX. The shapes cross the kernels' edges: K6's
block of queries (256) and its 16 warp segments (whole 32-reference steps,
so below 16 x 32 references trailing warps get none; one reference), K7's
block of queries (128) and chunk (32 references), K8's query group (128),
block (1,024 queries) and reference tile (256).

The same inputs on the card, kernels against these plain versions, are in
``test_torch_kernels.py`` (``cuda``-marked)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.ops import nn as JNN
from himo_tpu_torch.ops import nn as PNN

SHAPES = [(129, 1025), (1000, 3000), (33, 4097)]
# K6: also N past a block of 256 queries, M under 16 warps x 32, a single
# query, a single reference, both.
K6_SHAPES = SHAPES + [(129, 300), (200, 77), (1, 300), (257, 1), (1, 1)]
BIG = np.float32(PNN._MASK_BIG)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_case(rng, n, m):
    """(n, 3) queries and (m, 3) references on the grid, with duplicate
    references and queries sitting on references."""
    q = rng.integers(-32, 33, size=(n, 3)).astype(np.float32) / 4
    r = rng.integers(-32, 33, size=(m, 3)).astype(np.float32) / 4
    k = min(20, m // 2)
    r[m // 2 : m // 2 + k] = r[:k]
    q[: min(10, n, k)] = r[: min(10, n, k)]
    return q, r


def _penalties(rng, n, m):
    """qa, qd (n,), ra, rd (m,): 0 live, _MASK_BIG masked; the dynamic
    sides a random subset of the valid ones."""
    qv, rv = rng.random(n) < 0.85, rng.random(m) < 0.85
    qd, rd = qv & (rng.random(n) < 0.5), rv & (rng.random(m) < 0.5)
    return [np.where(x, np.float32(0), BIG).astype(np.float32) for x in (qv, qd, rv, rd)]


def _d2(q, r):
    """Exact squared distances (float64 sums of grid values, then fp32)."""
    return ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1).astype(np.float32)


@pytest.mark.parametrize("n,m", SHAPES)
def test_nn_argmin_plain_bitwise_on_grid(n, m):
    """K7's plain version against a numpy first-min loop (values and
    indices), and the public ``nn_argmin`` against the JAX package's."""
    rng = np.random.default_rng(n * 7 + m)
    frames = [_grid_case(rng, n, m) for _ in range(2)]
    q, r = (np.stack(x) for x in zip(*frames))
    d2, idx = PNN.nn_argmin_rows(_t(q), _t(r))
    for b in range(2):
        full = _d2(q[b], r[b])
        want = np.argmin(full, axis=1)  # the first minimal index
        np.testing.assert_array_equal(idx[b].numpy(), want.astype(np.int32))
        np.testing.assert_array_equal(d2[b].numpy(), full[np.arange(n), want])
        jd, ji = JNN.nn_argmin(jnp.asarray(q[b]), jnp.asarray(r[b]))
        pd, pi = PNN.nn_argmin(_t(q[b])[None], _t(r[b])[None])
        np.testing.assert_array_equal(pd[0].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pi[0].numpy(), np.asarray(ji))
    assert (idx[:, : min(10, n)].numpy() == np.arange(min(10, n))).all()


@pytest.mark.parametrize("n,m", SHAPES)
def test_fused_nn_plain_bitwise_on_grid(n, m):
    """K8's plain version, all four masked mins and their indices, against
    a numpy first-min loop and the JAX package's fused search
    (``_fused_dispatch`` with indices, the CPU path through
    ``_fused_xla``); ``fused_nn`` equals ``fused_nn_idx``'s mins."""
    rng = np.random.default_rng(n * 11 + m)
    q, r = _grid_case(rng, n, m)
    pens = _penalties(rng, n, m)
    args = (_t(q)[None], _t(r)[None], *(_t(p)[None] for p in pens))
    outs = [o[0].numpy() for o in PNN.fused_nn_idx(*args)]
    full = _d2(q, r)
    qa, qd, ra, rd = pens
    for k, mat in enumerate((full + ra[None], full + rd[None],
                             (full + qa[:, None]).T, (full + qd[:, None]).T)):
        want = np.argmin(mat, axis=1)
        np.testing.assert_array_equal(outs[4 + k], want.astype(np.int32))
        np.testing.assert_array_equal(outs[k], mat[np.arange(mat.shape[0]), want])
    mins = PNN.fused_nn(*args)
    assert all(np.array_equal(a[0].numpy(), b) for a, b in zip(mins, outs[:4]))
    jax_outs = JNN._fused_dispatch(jnp.asarray(q), jnp.asarray(r),
                                   *(jnp.asarray(p) for p in pens), track_idx=True)
    port = PNN._fused_dispatch(*args, track_idx=True)
    for k, (got, want) in enumerate(zip(port, jax_outs)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want), err_msg=str(k))


def test_plain_versions_on_a_falling_cloud_and_one_reference():
    """A cloud whose distance falls with the index (every chunk of the
    kernels' walk lowers every query's min) and a single reference: the
    plain versions against the first-min loop."""
    rng = np.random.default_rng(3)
    n, m = 200, 700
    q = rng.integers(-4, 5, size=(n, 3)).astype(np.float32) / 4
    r = np.zeros((m, 3), np.float32)
    r[:, 0] = 2.0 + np.arange(m, 0, -1, dtype=np.float32) / 4
    for refs in (r, r[:1]):
        d2, idx = PNN.nn_argmin_rows(_t(q)[None], _t(refs)[None])
        full = _d2(q, refs)
        want = np.argmin(full, axis=1)
        np.testing.assert_array_equal(idx[0].numpy(), want.astype(np.int32))
        np.testing.assert_array_equal(d2[0].numpy(), full.min(1))
        zeros = [np.zeros(k, np.float32) for k in (n, n, len(refs), len(refs))]
        outs = PNN.fused_nn_idx(_t(q)[None], _t(refs)[None], *(_t(z)[None] for z in zeros))
        np.testing.assert_array_equal(outs[4][0].numpy(), want.astype(np.int32))
        np.testing.assert_array_equal(outs[6][0].numpy(), np.argmin(full.T, axis=1))
    assert (idx[0].numpy() == 0).all()


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _jax_min(q, r):
    """The JAX package's plain version of ``_nn_kernel`` (``_nn_distance_sq_xla``)
    on one frame, padded as ``_nn_core`` pads it (rows to the query and
    reference tiles, at the sentinel)."""
    qp = JNN._pad_coords(jnp.asarray(q), JNN._QT, None)
    rp = JNN._pad_coords(jnp.asarray(r), JNN._RT, None)
    return np.asarray(JNN._nn_distance_sq_xla(qp, rp))[: q.shape[0]]


def _check_min_plain(q, r):
    """K6's plain version on (B, n, 3) x (B, m, 3) equal, bit for bit, to
    the JAX package's plain version per frame, and the port's no-grad
    ``nn_distance_sq`` to ``nn_argmin``'s d2 (the K6 = K7 contract) and to
    the plain min; returns the plain mins."""
    got = PNN._nn_min_plain(_t(q), _t(r)).numpy()
    for b in range(q.shape[0]):
        np.testing.assert_array_equal(_bits(got[b]), _bits(_jax_min(q[b], r[b])))
    with torch.no_grad():
        dmin = PNN.nn_distance_sq(_t(q), _t(r)).numpy()
    np.testing.assert_array_equal(_bits(dmin), _bits(PNN.nn_argmin(_t(q), _t(r))[0].numpy()))
    np.testing.assert_array_equal(_bits(dmin), _bits(got))
    return got


@pytest.mark.parametrize("n,m", K6_SHAPES)
def test_nn_min_plain_bitwise_on_grid(n, m):
    """K6's plain version against a numpy min and the JAX package's plain
    version, bit for bit, on two frames; the no-grad ``nn_distance_sq``
    equals ``nn_argmin``'s d2."""
    rng = np.random.default_rng(n * 13 + m)
    frames = [_grid_case(rng, n, m) for _ in range(2)]
    q, r = (np.stack(x) for x in zip(*frames))
    got = _check_min_plain(q, r)
    for b in range(2):
        np.testing.assert_array_equal(_bits(got[b]), _bits(_d2(q[b], r[b]).min(1)))
    assert (got[:, : min(10, n, m // 2)] == 0).all()  # queries on references


@pytest.mark.parametrize("n,m", [(129, 1025), (200, 77), (1, 300), (257, 1)])
def test_nn_distance_sq_no_grad_matches_jax_with_masks(n, m):
    """The public ``nn_distance_sq`` of both packages under no grad (K6's
    path) with random query and reference masks, bit for bit, and equal to
    the port's ``nn_argmin`` d2 and to a numpy min over the valid
    references (invalid queries 0)."""
    rng = np.random.default_rng(n * 17 + m)
    q, r = _grid_case(rng, n, m)
    qv, rv = rng.random(n) < 0.8, rng.random(m) < 0.8
    rv[-1] = True
    masks = (_t(qv)[None], _t(rv)[None])
    with torch.no_grad():
        got = PNN.nn_distance_sq(_t(q)[None], _t(r)[None], *masks)[0].numpy()
    want = JNN.nn_distance_sq(jnp.asarray(q), jnp.asarray(r), jnp.asarray(qv), jnp.asarray(rv))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(PNN.nn_argmin(_t(q)[None], _t(r)[None],
                                                                  *masks)[0][0].numpy()))
    exact = np.where(qv, _d2(q, r[rv]).min(1), np.float32(0))
    np.testing.assert_array_equal(_bits(got), _bits(exact))


def test_nn_min_plain_on_a_falling_cloud():
    """References on a line, farther first: every reference lowers every
    query's min (the order a walk meets them in is the worst for a fold
    that tracks where the min fell). Plain against numpy and JAX."""
    rng = np.random.default_rng(4)
    n, m = 200, 700
    q = rng.integers(-4, 5, size=(2, n, 3)).astype(np.float32) / 4
    r = np.zeros((2, m, 3), np.float32)
    r[..., 0] = 2.0 + np.arange(m, 0, -1, dtype=np.float32) / 4
    got = _check_min_plain(q, r)
    for b in range(2):
        np.testing.assert_array_equal(_bits(got[b]), _bits(_d2(q[b], r[b]).min(1)))
        np.testing.assert_array_equal(_bits(got[b]), _bits(_d2(q[b], r[b, -1:])[:, 0]))


def test_nn_min_plain_with_every_reference_at_the_sentinel():
    """A reference set wholly at ``SENTINEL`` (every reference masked):
    the plain versions of both packages agree bit for bit, and with the
    public ``nn_distance_sq`` of both at an all-false reference mask; the
    value is the sentinel distance within fp32 rounding."""
    rng = np.random.default_rng(5)
    q, _ = _grid_case(rng, 300, 1)
    r = np.full((2, 77, 3), PNN.SENTINEL, np.float32)
    got = _check_min_plain(np.stack([q, q[::-1]]), r)
    exact = ((q.astype(np.float64) - PNN.SENTINEL) ** 2).sum(-1)
    np.testing.assert_allclose(got[0], exact, rtol=1e-6)
    rv = np.zeros(77, bool)
    with torch.no_grad():
        port = PNN.nn_distance_sq(_t(q)[None], _t(r[0])[None], None, _t(rv)[None])[0]
    jax_out = JNN.nn_distance_sq(jnp.asarray(q), jnp.asarray(r[0]), None, jnp.asarray(rv))
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(jax_out))
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(got[0]))
