"""K7's and K8's plain versions on exact grid coordinates, against a numpy
first-min loop and the JAX package's CPU paths, bit for bit.

Coordinates lie on a quarter-metre grid in [-8, 8] (as
``test_torch_kernels._grid_knn_case`` builds them): every squared distance
is a multiple of 1/16 below 2^10, exact in fp32 both as ``sum((q - r)^2)``
(the CUDA kernels' form) and as ``|q|^2 + |r|^2 - 2 q.r`` (the plain
versions' and the reference's), and exact ties abound, so the first-min
rule decides most indices. Each penalty add ``d + p`` rounds the same way
in numpy, PyTorch and JAX. The shapes cross the kernels' edges: K7's chunk
(32 references) and warp segment, K8's query group (128), block (1,024
queries) and reference tile (256).

The same inputs on the card, kernels against these plain versions, are in
``test_torch_kernels.py`` (``cuda``-marked)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.ops import nn as JNN
from himo_tpu_torch.ops import nn as PNN

SHAPES = [(129, 1025), (1000, 3000), (33, 4097)]
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
