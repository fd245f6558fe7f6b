"""Port parity for the k-NN distances, the differentiable NN core and the
chamfer losses, against the JAX package on the CPU.

- ``knn_distance_sq``: exact, against the JAX TPU kernel ``_knn_kernel``
  itself run through the Pallas interpreter (``HIMO_PALLAS_INTERPRET=1``):
  exact duplicates collapse into one slot in both, and a query with fewer
  than k distinct valid references reads the reference's padding
  candidate (about 3e12), then 3.0e38.
- ``nn_distance_sq``, ``truncated_chamfer``, ``chamfer_distance``,
  ``knn_smoothed_chamfer``: values within 1e-6 relative and gradients in
  both clouds within 1e-5 relative (plus 1e-7 of the largest component) of
  ``jax.value_and_grad`` (the JAX NN path is its XLA one on the CPU; the
  sums run in another order). A query sits exactly at the truncation
  radius, where both split the gradient 0.5 / 0.5. The smoothed chamfer
  runs JAX's XLA k-NN path (its interpreter cannot take a gradient through
  the kernel), whose ``top_k`` keeps ties: the clouds there have no
  duplicate points, so both rules agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.ops import knn as JK
from himo_tpu.ops import nn as JNN
from himo_tpu_torch.ops import knn as PK
from himo_tpu_torch.ops import nn as PNN


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _knn_case(rng, n, m, scale, dup):
    """Clouds and masks; ``dup`` holds references 0..9 three times with
    queries 0..4 on them, and ``"many"`` also holds reference 0 forty
    times more."""
    q = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    r = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    qv = rng.uniform(size=n) > 0.15
    rv = rng.uniform(size=m) > 0.15
    if dup:
        r[m // 2 : m // 2 + 10] = r[:10]  # exact duplicates collapse
        r[m // 3 : m // 3 + 10] = r[:10]
        q[:5] = r[:5]
        qv[:5] = True
        rv[:10] = rv[m // 2 : m // 2 + 10] = True
    if dup == "many":
        r[-40:] = r[0]
        rv[-40:] = True
    return q, r, qv, rv


@pytest.mark.parametrize("k,n,m,masked,dup", [
    (4, 300, 1500, True, True),
    (8, 129, 1024, True, True),
    (1, 200, 700, False, True),
    (4, 256, 2048, False, False),
    (8, 130, 520, True, False),
    # k = MAX_K with one reference held 43 times; tails of every tile and
    # warp segment (n = 33, m = 1,025); one valid reference (slot 1 is the
    # padding candidate, slot 2 empty).
    (16, 200, 1500, True, "many"),
    (2, 33, 1025, True, True),
    (3, 100, 700, "one", False),
])
def test_knn_distance_sq_matches_interpreted_tpu_kernel(monkeypatch, k, n, m, masked, dup):
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(k * 1000 + n)
    q, r, qv, rv = _knn_case(rng, n, m, 10.0, dup)
    if masked == "one":
        rv[:] = False
        rv[m // 2] = True
    jm = (jnp.asarray(qv), jnp.asarray(rv)) if masked else (None, None)
    pm = (_t(qv)[None], _t(rv)[None]) if masked else (None, None)
    want = np.asarray(JK.knn_distance_sq(jnp.asarray(q), jnp.asarray(r), k, *jm))
    got = PK.knn_distance_sq(_t(q)[None], _t(r)[None], k, *pm)
    assert got.shape == (1, n, k) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want)
    live = qv if masked else np.ones(n, bool)
    assert (np.diff(want[live], axis=1) > 0).all()  # distinct, ascending
    if dup and k > 1:
        # Queries on a reference held three times: one slot near 0 (the
        # expansion form's rounding), then the next distinct point.
        assert (want[:5, 0] < 1e-3).all() and (want[:5, 1] > 1e-2).all()
    if masked:
        assert (got[0].numpy()[~qv] == 0).all()
    if masked == "one":
        assert (np.abs(want[live, 1] - 3e12) < 1e10).all() and (want[live, 2] == 3.0e38).all()


def test_knn_few_valid_references_read_the_padding_candidate(monkeypatch):
    """M % 1024 != 0 with 2 valid references: slot 3 is the reference's
    SENTINEL padding (about 3e12) and slot 4 is empty (3.0e38)."""
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(5)
    q = rng.normal(size=(50, 3)).astype(np.float32)
    r = rng.normal(size=(300, 3)).astype(np.float32)
    rv = np.zeros(300, bool)
    rv[:2] = True
    want = np.asarray(JK.knn_distance_sq(jnp.asarray(q), jnp.asarray(r), 4, None,
                                         jnp.asarray(rv)))
    got = PK.knn_distance_sq(_t(q)[None], _t(r)[None], 4, None, _t(rv)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[:, 2] - 3e12) < 1e10).all() and (got[:, 3] == 3.0e38).all()
    # All references valid and M a multiple of 1,024: no padding candidate.
    r = rng.normal(size=(1024, 3)).astype(np.float32)
    want = np.asarray(JK.knn_distance_sq(jnp.asarray(q), jnp.asarray(r), 4))
    got = PK.knn_distance_sq(_t(q)[None], _t(r)[None], 4)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_rows_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    q, r, _, _ = _knn_case(rng, 64, 200, 3.0, True)
    before = PK.knn_rows.launches
    got = PK.knn_rows(_t(q)[None], _t(r)[None], 5)[0].numpy()
    assert PK.knn_rows.launches == before  # CPU: no kernel launch
    full = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    for i in range(64):
        distinct = np.unique(full[i])[:5]
        np.testing.assert_allclose(got[i], distinct, rtol=1e-5, atol=1e-4)


def _grad_close(got, want):
    want = np.asarray(want)
    tol = 1e-5 * np.abs(want) + 1e-7 * max(np.abs(want).max(), 1.0)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _loss_pair(rng, n=200, m=260, scale=1.0):
    """Two clouds with a query / reference pair exactly 2 m apart (the
    truncation radius) far from the rest."""
    a = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    b = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    a[0] = (50.0, 0.0, 0.0)
    b[0] = (52.0, 0.0, 0.0)
    va = rng.uniform(size=n) > 0.1
    vb = rng.uniform(size=m) > 0.1
    va[0] = vb[0] = True
    return a, b, va, vb


@pytest.mark.parametrize("name", ["nn_distance_sq", "truncated_chamfer",
                                  "chamfer_distance", "knn_smoothed_chamfer"])
@pytest.mark.parametrize("masked", [True, False])
def test_loss_values_and_gradients_match_jax(name, masked):
    rng = np.random.default_rng(11 + masked)
    a, b, va, vb = _loss_pair(rng)
    jm = (jnp.asarray(va), jnp.asarray(vb)) if masked else (None, None)
    pm = (_t(va)[None], _t(vb)[None]) if masked else (None, None)
    weights = rng.uniform(0.5, 1.5, size=a.shape[0]).astype(np.float32)

    def jax_loss(x, y):
        if name == "nn_distance_sq":
            return jnp.sum(JNN.nn_distance_sq(x, y, *jm) * weights)
        if name == "knn_smoothed_chamfer":
            return JK.knn_smoothed_chamfer(x, y, 4, *jm, max_dist=2.0)
        return getattr(JNN, name)(x, y, *jm)

    def port_loss(x, y):
        if name == "nn_distance_sq":
            return (PNN.nn_distance_sq(x, y, *pm)[0] * _t(weights)).sum()
        if name == "knn_smoothed_chamfer":
            return PK.knn_smoothed_chamfer(x, y, 4, *pm, max_dist=2.0)[0]
        return getattr(PNN, name)(x, y, *pm)[0]

    val, (ga, gb) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x = _t(a)[None].requires_grad_()
    y = _t(b)[None].requires_grad_()
    got = port_loss(x, y)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-6)
    _grad_close(x.grad[0].numpy(), ga)
    _grad_close(y.grad[0].numpy(), gb)
    if name == "truncated_chamfer":
        # The pair sits exactly at the cap in both directions, and each
        # direction sends half its gradient, 0.5 * 2 (a0 - b0) / count.
        counts = (va.sum(), vb.sum()) if masked else (len(va), len(vb))
        want = 0.5 * np.array([-4.0, 0.0, 0.0]) * (1 / counts[0] + 1 / counts[1])
        np.testing.assert_allclose(x.grad[0, 0].numpy(), want, rtol=1e-5)


def test_nn_backward_launches_the_reference_scatter_only_when_needed(monkeypatch):
    """``dr`` (one ``segment_rows_sum``) only when the references need a
    gradient; the no-grad primal takes the min-only search."""
    calls = []
    monkeypatch.setattr(PNN, "segment_rows_sum", lambda *a: calls.append(1)
                        or PNN._segment_rows_sum_plain(*a))
    argmins = []
    plain_argmin = PNN.nn_argmin_rows
    monkeypatch.setattr(PNN, "nn_argmin_rows", lambda q, r: argmins.append(1)
                        or plain_argmin(q, r))
    rng = np.random.default_rng(3)
    a, b, va, vb = _loss_pair(rng)
    x = _t(a)[None].requires_grad_()
    PNN.nn_distance_sq(x, _t(b)[None]).sum().backward()
    assert calls == [] and len(argmins) == 1
    y = _t(b)[None].requires_grad_()
    PNN.nn_distance_sq(_t(a)[None], y).sum().backward()
    assert calls == [1] and len(argmins) == 2
    with torch.no_grad():
        PNN.nn_distance_sq(x, y)
    assert len(argmins) == 2
