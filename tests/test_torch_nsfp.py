"""Port parity for the runtime-optimisation estimators ``nsfp`` and
``fastnsf`` and their parts, against the JAX package on the CPU.

Every input is float32 (tests/conftest.py turns JAX's x64 on, and float64
inputs break the reference's loop carries). The port starts from JAX's own
initial MLP parameters (``init_mlp(PRNGKey)``, converted with
``utils.convert.mlp_from_jax`` and passed as ``params=``): the two
frameworks draw different random numbers.

- ``run_adam``, all four modes (fixed length, early stopping, cosine
  schedule with early stopping, annealed caps with ``track_from``):
  parameters and loss within 1e-5 relative (plus 1e-6), the step count
  exact. optax and ``torch.optim.Adam`` round the same update differently.
- ``distance_transform``: exact. ``sample_dt``: values within 1e-6
  relative, gradients within 1e-5 relative (plus 1e-6), points exactly on
  both clamp bounds included (gradient 0.5 there in both).
- ``nsfp_flow`` (``knn_k`` 0 and 4) and ``fastnsf_flow`` at toy size
  (hidden 32, 2-3 layers, 12-20 steps, a few hundred points): flow within
  1e-4 m plus 1e-4 relative, loss within 1e-4 relative. ``knn_k=4`` runs
  JAX's XLA k-NN path (``top_k``, ties kept) on clouds with no duplicate
  points, where both tie rules agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.models import coordinate_mlp as JMLP
from himo_tpu.models import fastnsf as JF
from himo_tpu.models import nsfp as JN
from himo_tpu.models import opt_loop as JO
from himo_tpu.ops import dt as JDT
from himo_tpu_torch.models import fastnsf as PF
from himo_tpu_torch.models import nsfp as PN
from himo_tpu_torch.models import opt_loop as PO
from himo_tpu_torch.models.coordinate_mlp import apply_mlp
from himo_tpu_torch.models.registry import get_estimator
from himo_tpu_torch.ops import dt as PDT
from himo_tpu_torch.utils.convert import mlp_from_jax


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_mlp(seed, hidden, layers):
    params = JMLP.init_mlp(jax.random.PRNGKey(seed), hidden=hidden, layers=layers)
    return params, mlp_from_jax([(np.asarray(w), np.asarray(b)) for w, b in params])


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_apply_mlp_matches_jax():
    jp, pp = _jax_mlp(0, 32, 3)
    x = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    _close(apply_mlp(pp, _t(x)).numpy(), JMLP.apply_mlp(jp, jnp.asarray(x)), 1e-5, 1e-6)


_MODES = {
    "fixed": dict(iterations=40, patience=0),
    "early_stop": dict(iterations=400, patience=8, min_delta=1e-2),
    "cosine": dict(iterations=300, patience=5, min_delta=1e-2, schedule="cosine"),
    "caps": dict(iterations=200, patience=5, min_delta=1e-2, track_from=100),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_run_adam_matches_jax(mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = (np.tanh(x @ rng.normal(size=(3, 2))) * 2.0).astype(np.float32)
    w0 = (rng.normal(size=(3, 2)) * 0.1).astype(np.float32)
    b0 = np.zeros(2, np.float32)
    kwargs = dict(lr=0.05, **_MODES[mode])
    caps = None
    if mode == "caps":
        caps = PO.anneal_caps(200, 0.5, 3.0, 0.5)
        _close(caps.numpy(), JO.anneal_caps(200, 0.5, 3.0, 0.5), 1e-6, 0)

    def jax_loss(p, cap=1.0):
        (w, b), = p
        d = (jnp.asarray(x) @ w + b - jnp.asarray(y)) ** 2
        return jnp.mean(jnp.minimum(d, cap * cap))

    def port_loss(p, cap=1.0):
        (w, b), = p
        d = (torch.addmm(b, _t(x), w) - _t(y)) ** 2
        return torch.minimum(d, torch.full_like(d, cap * cap)).mean()

    jp, jl, js = JO.run_adam(jax_loss, [(jnp.asarray(w0), jnp.asarray(b0))],
                             step_caps=None if caps is None else jnp.asarray(caps.numpy()),
                             **kwargs)
    pp, pl, ps = PO.run_adam(port_loss, [(_t(w0), _t(b0))], step_caps=caps, **kwargs)
    assert ps == int(js), (ps, int(js))
    if mode != "fixed":
        assert ps < kwargs["iterations"]  # the loop stopped early
    _close(float(pl), float(jl), 1e-5, 1e-6)
    for got, want in zip(pp[0], jp[0]):
        assert not got.requires_grad
        _close(got.numpy(), want, 1e-5, 1e-6)


SMALL_DT = dict(x_range=(-4.0, 4.0), y_range=(-3.0, 3.0), z_range=(-1.0, 1.0),
                voxel_size=(0.5, 0.5, 0.25))


def _dt_cloud(rng, n):
    pts = rng.uniform([-4.5, -3.5, -1.2], [4.5, 3.5, 1.2], size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    return pts, valid


def test_distance_transform_and_sample_match_jax():
    rng = np.random.default_rng(2)
    pts, valid = _dt_cloud(rng, 60)
    jgrid = JDT.distance_transform(jnp.asarray(pts), jnp.asarray(valid), JDT.DTConfig(**SMALL_DT))
    pgrid = PDT.distance_transform(_t(pts), _t(valid), PDT.DTConfig(**SMALL_DT))
    assert pgrid.dist_sq.shape == (16, 12, 8)
    np.testing.assert_array_equal(pgrid.dist_sq.numpy(), np.asarray(jgrid.dist_sq))
    q = rng.uniform([-5, -4, -1.5], [5, 4, 1.5], size=(200, 3)).astype(np.float32)
    # Exactly on the lower and upper clamp bounds of each axis (u = 0 and
    # u = size - 1), and one point outside on every axis.
    q[0] = (-3.75, -2.75, -0.875)
    q[1] = (3.75, 2.75, 0.875)
    q[2] = (-3.75, 0.3, 0.875)
    q[3] = (6.0, -5.0, 2.0)

    def jax_sum(p):
        return jnp.sum(JDT.sample_dt(jgrid, p) * jnp.arange(1, 201, dtype=jnp.float32))

    val, grad = jax.value_and_grad(jax_sum)(jnp.asarray(q))
    x = _t(q).requires_grad_()
    got = PDT.sample_dt(pgrid, x)
    (got * torch.arange(1, 201, dtype=torch.float32)).sum().backward()
    _close(got.detach().numpy(), JDT.sample_dt(jgrid, jnp.asarray(q)), 1e-6, 1e-6)
    _close(x.grad.numpy(), grad, 1e-5, 1e-6)
    # Clamped outside the grid: no gradient along the clamped axes.
    assert (x.grad[3] == 0).all()


def _pair(rng, n=240, m=260, scale=2.0):
    """One toy frame pair: a static background and a blob moved 0.6 m."""
    pc0 = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    pc1 = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    pc1[:60] = pc0[:60] + np.array([0.6, 0.0, 0.0], np.float32)
    v0 = rng.uniform(size=n) > 0.1
    v1 = rng.uniform(size=m) > 0.1
    return pc0, pc1, v0, v1


@pytest.mark.parametrize("knn_k,extra", [
    (0, dict(iterations=20)),
    (4, dict(iterations=15)),
    (0, dict(iterations=30, patience=4, min_delta=0.05, schedule="cosine")),
    (0, dict(iterations=12, coarse_init=4.0, anneal_frac=0.5)),
])
def test_nsfp_flow_matches_jax(knn_k, extra):
    rng = np.random.default_rng(3 + knn_k)
    pc0, pc1, v0, v1 = _pair(rng)
    fields = dict(hidden=32, layers=2, lr=8e-3, knn_k=knn_k, cluster_prior=False, **extra)
    _, pparams = _jax_mlp(7, 32, 2)
    # JAX's nsfp_flow draws its parameters from the key: same key, same draw.
    jflow, jloss = JN.nsfp_flow(jnp.asarray(pc0), jnp.asarray(pc1), jnp.asarray(v0),
                                jnp.asarray(v1), jax.random.PRNGKey(7),
                                config=JN.NSFPConfig(**fields))
    flow, loss = PN.nsfp_flow(_t(pc0), _t(pc1), _t(v0), _t(v1), None,
                              PN.NSFPConfig(**fields), params=pparams)
    assert flow.shape == (240, 3) and not flow.requires_grad
    _close(flow.numpy(), jflow, 1e-4, 1e-4)
    _close(float(loss), float(jloss), 1e-4, 0)
    assert (flow.numpy()[~v0] == 0).all()


def test_fastnsf_flow_matches_jax():
    rng = np.random.default_rng(8)
    pc0, pc1, v0, v1 = _pair(rng, scale=1.2)
    fields = dict(hidden=32, layers=3, lr=8e-3, iterations=20, cluster_prior=False)
    jflow, jloss = JF.fastnsf_flow(
        jnp.asarray(pc0), jnp.asarray(pc1), jnp.asarray(v0), jnp.asarray(v1),
        jax.random.PRNGKey(9), config=JF.FastNSFConfig(dt=JDT.DTConfig(**SMALL_DT), **fields))
    _, pparams = _jax_mlp(9, 32, 3)
    flow, loss = PF.fastnsf_flow(
        _t(pc0), _t(pc1), _t(v0), _t(v1), None,
        PF.FastNSFConfig(dt=PDT.DTConfig(**SMALL_DT), **fields), params=pparams)
    _close(flow.numpy(), jflow, 1e-4, 1e-4)
    _close(float(loss), float(jloss), 1e-4, 0)


@pytest.mark.parametrize("name", ["nsfp", "fastnsf", "fastnsf10"])
def test_registry_refuses_the_cluster_prior_and_runs_without_it(name):
    # The reference's default, cluster_prior=True, runs (the host cluster
    # prior is ported); cluster_prior=False is the cold start.
    assert get_estimator(name, device="cpu").config.cluster_prior is True
    rng = np.random.default_rng(4)
    pc0, pc1, v0, v1 = _pair(rng, n=80, m=90)
    for prior in (False, True):
        small = dict(hidden=16, layers=2, iterations=3, cluster_prior=prior)
        if name != "nsfp":
            small["dt"] = PDT.DTConfig(**SMALL_DT)
        est = get_estimator(name, device="cpu", **small)
        assert est.config.iterations == 3 and est.config.cluster_prior is prior
        flow, loss = est(_t(pc0), _t(pc1), _t(v0), _t(v1), torch.Generator().manual_seed(0))
        assert flow.shape == (80, 3) and torch.isfinite(flow).all() and torch.isfinite(loss)
    if name == "fastnsf10":
        assert get_estimator(name, device="cpu", cluster_prior=False).config.iterations == 150


def _fast_pair():
    """tests/test_fast_objects.py's pair: static clutter and a blob moved
    3.4 m (beyond the 2 m truncation), padded to 1,024 points."""
    from test_fast_objects import _fast_scene

    p0, p1, v, gt, n_static, n = _fast_scene(np.random.default_rng(0))
    return p0, p1, v, gt, n_static, n


@pytest.mark.parametrize("name", ["nsfp", "fastnsf"])
def test_cluster_prior_estimators_match_jax(name, monkeypatch):
    """cluster_prior=True at toy size: the host prior bitwise equal to the
    reference's (both on scipy's KD-tree), then the prior-seeded
    optimisation from JAX's own initial MLP within the tolerances above."""
    import himo_tpu.native
    import himo_tpu_torch.native

    monkeypatch.setattr(himo_tpu.native, "available", lambda: False)
    monkeypatch.setattr(himo_tpu_torch.native, "available", lambda: False)
    p0, p1, v, gt, n_static, n = _fast_pair()
    if name == "nsfp":
        fields = dict(hidden=32, layers=2, lr=8e-3, iterations=20)
        jcfg, pcfg = JN.NSFPConfig(**fields), PN.NSFPConfig(**fields)
    else:
        fields = dict(hidden=32, layers=3, lr=8e-3, iterations=20)
        jcfg = JF.FastNSFConfig(dt=JDT.DTConfig(**SMALL_DT), **fields)
        pcfg = PF.FastNSFConfig(dt=PDT.DTConfig(**SMALL_DT), **fields)
    assert jcfg.cluster_prior and pcfg.cluster_prior
    jprior = JN.cluster_prior_flow(p0, p1, v, v, jcfg)
    prior = PN.cluster_prior_flow(_t(p0), _t(p1), _t(v), _t(v), pcfg)
    np.testing.assert_array_equal(prior.numpy(), np.asarray(jprior))
    moved = slice(n_static, n)
    assert (np.abs(prior.numpy()[moved] - gt[moved]).max(1) < 0.3).mean() > 0.8
    assert (prior.numpy()[:n_static] == 0).all()
    _, pparams = _jax_mlp(5, 32, fields["layers"])
    jflow_fn, pflow_fn = (JN.nsfp_flow, PN.nsfp_flow) if name == "nsfp" else (
        JF.fastnsf_flow, PF.fastnsf_flow)
    jflow, jloss = jflow_fn(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(v), jnp.asarray(v),
                            jax.random.PRNGKey(5), config=jcfg, prior_flow=jprior)
    flow, loss = pflow_fn(_t(p0), _t(p1), _t(v), _t(v), None, pcfg, prior_flow=prior,
                          params=pparams)
    _close(flow.numpy(), jflow, 1e-4, 1e-4)
    _close(float(loss), float(jloss), 1e-4, 0)
    # The registry estimator seeds the same prior (its flow equals the
    # flow function's from the same generator and that prior) and keeps a
    # tracker per scene when given scene_id and pose1.
    est = get_estimator(name, device="cpu", **({} if name == "nsfp" else dict(
        dt=PDT.DTConfig(**SMALL_DT))), **fields)
    flow, _ = est(_t(p0), _t(p1), _t(v), _t(v), torch.Generator().manual_seed(0),
                  scene_id="s0", pose1=_t(np.eye(4)))
    want, _ = pflow_fn(_t(p0), _t(p1), _t(v), _t(v), torch.Generator().manual_seed(0),
                       pcfg, prior_flow=prior)
    torch.testing.assert_close(flow, want, rtol=0, atol=0)
    assert set(est.trackers) == {"s0"} and est.trackers["s0"].tracks
