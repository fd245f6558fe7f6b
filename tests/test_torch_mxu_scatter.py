"""The sorted-stream kernels of ``pooling='mean_sorted'`` (K10, K11) and the
scatter-max backward's sorted gather (K5) in the port, against the JAX
package on the CPU, which runs the TPU kernels themselves through the
interpreter (``HIMO_PALLAS_INTERPRET=1``): without it the JAX package
skips K10 and K11 for XLA ops that do not round to bf16.

Tolerances, each with its reason:

- K10 (``scatter_sum_sorted``): sums within ``1e-5 * sum|x| + 1e-6`` per
  cell (the TPU adds window by window, the port in stream order), the
  count column exact. With ``mxu_bf16`` both round every value to bf16
  first, except that the reference's scalar fallback (a 128-point chunk
  whose ids span more than its 1,024-row window) adds unrounded values: the
  clustered case, which reaches it, takes bf16 values there (what the
  model's bf16 PFN gives), on which the rounding is the identity.
- K11 (``gather_rows_sorted``): bitwise, ids past the grid included (the
  reference reads the zero rows appended to its image, the port 0); the
  same bf16 rule for the clustered case.
- Gradients of both against ``jax.grad``: the gather's (K10 on the
  cotangent) within the sum bound; the sum's (K11 on the cotangent)
  bitwise, and in bf16 different from the fp32 gradient, which shows the
  cotangent's rounding.
- K5: the plain version bitwise against the interpreted
  ``_sorted_gather_forward`` on ids below ``rows`` (the reference reads its
  scatter's trash row for the others; the backward masks them), over
  several bands. ``scatter_max``'s gradient bitwise against ``jax.grad``
  with ``HIMO_MAXBWD_PALLAS=1`` on the table and stream routes (a
  selection, no arithmetic), where the port runs K5 once per backward.
- The toy ``seflowpp`` slice at ``pooling='mean_sorted'``: in fp32 the
  training forward's flow and gate logits within 1e-4, slots equal, and
  every parameter's gradient of ``sum(flow^2)`` within rtol 1e-4 plus 1e-4
  of the tensor's largest component (float32 sums in another order); the
  inference forward (refine head on) as ``tests/test_torch_slice.py``
  holds it. In bf16 see ``test_bf16_slice_matches_interpreted_jax``.

Each grid or row count here is used by no other test, so the JAX
package's shape-keyed kernel caches never mix the band thresholds shrunk
here with the real ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.models import feedforward as JF
from himo_tpu.ops import mxu_scatter as JM
from himo_tpu.ops import voxelize as JV
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.ops import mxu_scatter as PM
from himo_tpu_torch.ops import voxelize as PV
from himo_tpu_torch.utils.convert import flax_to_torch


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("HIMO_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _sorted_case(rng, num_rows, n, c, clustered, trash=5):
    """``tests/test_mxu_scatter.py``'s cases: sorted ids (a dense blob plus
    a sparse tail when ``clustered``), the last ``trash`` at ``num_rows``;
    normal features, the last column a count (1 for ids below
    ``num_rows``)."""
    if clustered:
        dense = rng.integers(0, num_rows // 50, size=n // 2)
        sparse = rng.integers(0, num_rows, size=n - n // 2)
        pids = np.sort(np.concatenate([dense, sparse])).astype(np.int32)
    else:
        pids = np.sort(rng.integers(0, num_rows, size=n)).astype(np.int32)
    pids[-trash:] = num_rows
    feats = rng.normal(size=(n, c)).astype(np.float32)
    feats[:, -1] = pids < num_rows
    return pids, feats


CASES = {  # num_rows, n, c, clustered
    "uniform": (4000, 2000, 32, False),
    "window_is_band": (300, 700, 8, False),
    "clustered": (65536, 4096, 33, True),
    "step_width": (65536, 4096, 65, True),  # the train step's gather backward
}


def _counting(monkeypatch, *names):
    """Count the calls of the port's kernel wrappers (the CPU wrappers
    count no launches)."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        mod = PV if name == "sorted_gather_rows" else PM

        def counted(*args, _fn=getattr(mod, name), _name=name):
            counts[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_scatter_sum_sorted_matches_interpreted_k10(monkeypatch, case, bf16):
    num_rows, n, c, clustered = CASES[case]
    pids, feats = _sorted_case(np.random.default_rng(0), num_rows, n, c, clustered)
    if bf16 and clustered:
        feats = _bf16(feats)
    counts = _counting(monkeypatch, "sorted_segment_sum")
    want = np.asarray(JM.scatter_sum_sorted(jnp.asarray(pids), jnp.asarray(feats),
                                            num_rows=num_rows, mxu_bf16=bf16))[:num_rows]
    got = PM.scatter_sum_sorted(_t(pids)[None], _t(feats)[None], num_rows=num_rows,
                                mxu_bf16=bf16)[0].numpy()
    assert counts == {"sorted_segment_sum": 1} and got.shape == (num_rows, c)
    mag = np.zeros((num_rows + 1, c), np.float64)
    np.add.at(mag, np.minimum(pids, num_rows), np.abs(_bf16(feats) if bf16 else feats))
    assert (np.abs(got - want) <= 1e-5 * mag[:num_rows] + 1e-6).all()
    np.testing.assert_array_equal(got[:, -1], want[:, -1])  # counts exact
    np.testing.assert_array_equal(got[:, -1], np.bincount(pids, minlength=num_rows + 1)
                                  [:num_rows])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_gather_rows_sorted_matches_interpreted_k11(monkeypatch, case, bf16):
    num_rows, n, c, clustered = CASES[case]
    rng = np.random.default_rng(1)
    pids, _ = _sorted_case(rng, num_rows, n, c, clustered)
    image = rng.normal(size=(num_rows, c)).astype(np.float32)
    if bf16 and clustered:
        image = _bf16(image)
    counts = _counting(monkeypatch, "sorted_segment_gather")
    jimage = np.concatenate([image, np.zeros((8, c), np.float32)])
    want = np.asarray(JM.gather_rows_sorted(jnp.asarray(pids), jnp.asarray(jimage),
                                            num_rows=num_rows, mxu_bf16=bf16))
    got = PM.gather_rows_sorted(_t(pids)[None], _t(image)[None], num_rows=num_rows,
                                mxu_bf16=bf16)[0].numpy()
    assert counts == {"sorted_segment_gather": 1}
    np.testing.assert_array_equal(got, want)
    assert (got[pids >= num_rows] == 0).all()
    if bf16 and not clustered:  # the rounding shows
        assert (got != image[np.minimum(pids, num_rows - 1)])[pids < num_rows].any()


@pytest.mark.parametrize("case", ["uniform", "window_is_band"])
def test_gradients_are_the_transposed_kernels(monkeypatch, case):
    """``jax.grad`` through the interpreted kernels' custom VJPs, in both
    modes; the port's backwards run the other kernel with the same flag."""
    num_rows, n, c, _ = CASES[case]
    rng = np.random.default_rng(2)
    pids, feats = _sorted_case(rng, num_rows, n, c, False)
    image = rng.normal(size=(num_rows, c)).astype(np.float32)
    w_img = rng.normal(size=(num_rows, c)).astype(np.float32)
    w_pts = rng.normal(size=(n, c)).astype(np.float32)
    jp = jnp.asarray(pids)
    counts = _counting(monkeypatch, "sorted_segment_sum", "sorted_segment_gather")
    grads = {}
    for bf16 in (False, True):
        jg_f = np.asarray(jax.grad(lambda f: jnp.sum(JM.scatter_sum_sorted(
            jp, f, num_rows=num_rows, mxu_bf16=bf16)[:num_rows] * w_img))(
                jnp.asarray(feats)))
        jg_i = np.asarray(jax.grad(lambda im: jnp.sum(JM.gather_rows_sorted(
            jp, jnp.concatenate([im, jnp.zeros((8, c), jnp.float32)]), num_rows=num_rows,
            mxu_bf16=bf16) * w_pts))(jnp.asarray(image)))
        tf = _t(feats)[None].requires_grad_()
        ti = _t(image)[None].requires_grad_()
        (PM.scatter_sum_sorted(_t(pids)[None], tf, num_rows=num_rows, mxu_bf16=bf16)
         * _t(w_img)).sum().backward()
        (PM.gather_rows_sorted(_t(pids)[None], ti, num_rows=num_rows, mxu_bf16=bf16)
         * _t(w_pts)).sum().backward()
        np.testing.assert_array_equal(tf.grad[0].numpy(), jg_f)
        live = pids < num_rows
        mag = np.zeros((num_rows + 1, c), np.float64)
        np.add.at(mag, np.minimum(pids, num_rows), np.abs(_bf16(w_pts) if bf16 else w_pts))
        assert (np.abs(ti.grad[0].numpy() - jg_i) <= 1e-5 * mag[:num_rows] + 1e-6).all()
        assert (tf.grad[0].numpy()[~live] == 0).all()
        grads[bf16] = (tf.grad[0].numpy(), ti.grad[0].numpy())
    assert counts == {"sorted_segment_sum": 4, "sorted_segment_gather": 4}
    # The bf16 backwards round the cotangent: their gradients differ.
    assert (grads[True][0] != grads[False][0]).any()
    assert (grads[True][1] != grads[False][1]).any()


def test_sorted_gather_rows_plain_matches_interpreted_k5(monkeypatch):
    """K5 over 7 bands (the band budget shrunk to 256 KiB): rows read in
    pillar-sorted order, written back to each point's own position."""
    monkeypatch.setattr(JV, "_BAND_BUDGET_BYTES", 256 * 1024)
    num_rows, n, c = 3300, 2500, 64
    assert JV._band_partition(num_rows, c)[0] == 7
    rng = np.random.default_rng(3)
    pids = rng.integers(0, num_rows, size=n).astype(np.int32)
    pids[:300] = 1234  # one crowded pillar
    image = rng.normal(size=(num_rows + 8, c)).astype(np.float32)
    want = np.asarray(JV._sorted_gather_forward(jnp.asarray(pids), jnp.asarray(image),
                                                num_rows=num_rows, interpret=True))
    spids, order = PV._stable_sort(_t(pids)[None])
    got = PV.sorted_gather_rows(_t(image[:num_rows])[None], spids, order)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, image[pids])
    # Ids >= rows read 0 (the reference reads its trash row there).
    bad = pids.copy()
    bad[::7] = num_rows
    spids, order = PV._stable_sort(_t(bad)[None])
    got = PV.sorted_gather_rows(_t(image[:num_rows])[None], spids, order)[0].numpy()
    assert (got[::7] == 0).all()
    np.testing.assert_array_equal(np.delete(got, np.s_[::7], 0),
                                  np.delete(image[pids], np.s_[::7], 0))


ROUTE_GRIDS = {  # row counts no other test uses; (resident, point table) thresholds
    "resident": (dict(x_range=(-7.6, 7.6), y_range=(-6.0, 6.0)), None),
    "table": (dict(x_range=(-10.4, 10.4), y_range=(-7.2, 7.2)),
              (64 * 1024, 40 * 1024 * 1024)),
    "stream": (dict(x_range=(-10.8, 10.8), y_range=(-6.8, 6.8)),
               (64 * 1024, 512 * 1024)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["resident", "table", "stream"])
def test_scatter_max_gradient_takes_k5_like_the_reference(monkeypatch, route, dtype):
    """The scatter-max gradient against ``jax.grad`` with
    ``HIMO_MAXBWD_PALLAS=1`` (the interpreted K5 on the table and stream
    routes; the resident route keeps its plain take in both)."""
    monkeypatch.setenv("HIMO_MAXBWD_PALLAS", "1")
    grid, limits = ROUTE_GRIDS[route]
    if limits is not None:
        resident, table = limits
        monkeypatch.setattr(JV, "_VMEM_BUDGET_BYTES", resident)
        monkeypatch.setattr(JV, "_BAND_BUDGET_BYTES", 256 * 1024)
        monkeypatch.setattr(JV, "_TABLE_BUDGET_BYTES", table)
        monkeypatch.setattr(PV, "_RESIDENT_BYTES", resident)
        monkeypatch.setattr(PV, "_TABLE_BYTES", table)
    cfg_j = JV.PillarConfig(voxel_size=(0.4, 0.4), **grid)
    cfg_p = PV.PillarConfig(voxel_size=(0.4, 0.4), **grid)
    n, c = 1500, 32
    rows = cfg_p.num_pillars
    assert PV._route(rows, n, c) == route
    rng = np.random.default_rng(4)
    pts = rng.uniform(-11.0, 11.0, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3.5, 3.5, n)
    pts[:400] *= np.float32(0.1)  # crowded pillars
    valid = rng.uniform(size=n) > 0.08
    feats = rng.normal(size=(n, c)).astype(np.float32)
    feats[1::9] = feats[0::9][: len(feats[1::9])]  # exact ties in the max
    w = rng.normal(size=cfg_p.grid_shape + (c,)).astype(np.float32)
    jgrid = JV.voxelize_pillars(jnp.asarray(pts), jnp.asarray(valid), cfg_j)
    jf = jnp.asarray(feats).astype(getattr(jnp, dtype))
    jgrad = jax.grad(lambda f: (JV.scatter_max(f, jgrid).astype(jnp.float32) * w).sum())(jf)
    counts = _counting(monkeypatch, "sorted_gather_rows")
    pgrid = PV.voxelize_pillars(_t(pts)[None], _t(valid)[None], cfg_p)
    pf = _t(feats)[None].to(getattr(torch, dtype)).requires_grad_()
    (PV.scatter_max(pf, pgrid).float() * _t(w)).sum().backward()
    np.testing.assert_array_equal(pf.grad[0].float().numpy(),
                                  np.asarray(jgrad.astype(jnp.float32)))
    assert counts == {"sorted_gather_rows": 0 if route == "resident" else 1}
    assert (pf.grad[0].float().abs().sum(-1) > 0).sum() > 100


# ------------------------------------------------------------ the toy slice

SLICE = {"pillar.x_range": (-10, 10), "pillar.y_range": (-10, 10),
         "pillar.voxel_size": (0.5, 0.5), "depths": (16, 32), "point_feat_dim": 8,
         "base_channels": 8, "refine.num_query": 256, "refine.num_ref": 512}
B, N = 2, 1024
MARGIN = 1e-3


@pytest.fixture(scope="module")
def toy_slice():
    """``tests/test_models.py``'s mean_sorted configuration (40x40 grid,
    1,024 points, the first 960 valid), two frames; flax's initialisation
    with the dynamic-logit bias at -1.2 and the gate bias at +0.1 so that
    random weights open gates and form components; the second sweep is the
    first shifted 0.6 m."""
    from himo_tpu_torch.data.synthetic import lidar_like_cloud

    jm, _ = JF.make_model("seflowpp", pooling="mean_sorted", **SLICE)
    zeros = tuple(jnp.zeros((N, 3), jnp.float32) for _ in range(3))
    ones = tuple(jnp.ones((N,), bool) for _ in range(3))
    jmax, _ = JF.make_model("seflowpp", **SLICE)  # the same parameters
    params = jax.jit(lambda k: jmax.init(k, zeros, ones, None))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["UNet_0"]["Conv_0"]["bias"][16] = -1.2  # dynamic logit
    params["params"]["DeFlowGRUDecoder_0"]["Dense_3"]["bias"][3] = 0.1  # gate
    rng = np.random.default_rng(0)
    pc0 = lidar_like_cloud(rng, B, N) * np.float32(0.2)
    shift = np.array([0.6, -0.2, 0.0], np.float32)
    pc1 = pc0 + shift + rng.normal(0, 0.02, pc0.shape).astype(np.float32)
    pch = pc0 - shift
    valid = np.arange(N)[None].repeat(B, 0) < 960
    return jm, params, (pc0, pc1, pch), valid


def _port_model(params, dtype="float32"):
    model, cfg = PF.make_model("seflowpp", device="cpu", pooling="mean_sorted",
                               dtype=dtype, **SLICE)
    model.load_state_dict(flax_to_torch(params, cfg))
    return model


def _jax_fns(jm):
    """Jitted JAX functions of one frame: the training forward, the
    gradient of its ``sum(flow^2)``, and the inference forward."""
    def train(p, s, v):
        return jm.apply(p, s, v, with_aux=True, soft_gate=True)

    return (jax.jit(train),
            jax.jit(jax.grad(lambda p, s, v: jnp.sum(train(p, s, v)[0] ** 2))),
            jax.jit(lambda p, s, v: jm.apply(p, s, v, with_aux=True)))


def _frame(clouds, valid, b):
    return (tuple(jnp.asarray(c[b]) for c in clouds), (jnp.asarray(valid[b]),) * 3)


def test_slice_matches_interpreted_jax(monkeypatch, toy_slice):
    jm, params, clouds, valid = toy_slice
    model = _port_model(params)
    counts = _counting(monkeypatch, "sorted_segment_sum", "sorted_segment_gather")
    sweeps = tuple(_t(c) for c in clouds)
    valids = (_t(valid),) * 3

    # The training forward (soft gate, no refine) and its gradient.
    flow, aux = model(sweeps, valids, with_aux=True, soft_gate=True)
    assert counts == {"sorted_segment_sum": 3, "sorted_segment_gather": 1}
    (flow ** 2).sum().backward()
    assert counts == {"sorted_segment_sum": 4, "sorted_segment_gather": 4}
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads["pfn.dense0.weight"].abs().sum() > 0  # through K10's backward
    jtrain, jgrad_fn, jinfer = _jax_fns(jm)
    jgrad = None
    for b in range(B):
        jflow, jaux = jtrain(params, *_frame(clouds, valid, b))
        np.testing.assert_array_equal(aux["slot"][b].numpy(), np.asarray(jaux["slot"]))
        np.testing.assert_allclose(flow[b].detach().numpy(), np.asarray(jflow), atol=1e-4)
        np.testing.assert_allclose(aux["gate_logit"][b].detach().numpy(),
                                   np.asarray(jaux["gate_logit"]), atol=1e-4)
        g = jgrad_fn(params, *_frame(clouds, valid, b))
        jgrad = g if jgrad is None else jax.tree_util.tree_map(jnp.add, jgrad, g)
    assert np.unique(aux["slot"].numpy()).size >= 3  # -1 and >= 2 slots
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrad), model.config)
    for k, w in want.items():
        got = grads[k] if grads[k] is not None else torch.zeros_like(w)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()), err_msg=k)

    # The inference forward (hard gate, refine head): decisions may differ
    # only within MARGIN of their threshold, as in tests/test_torch_slice.py.
    with torch.inference_mode():
        flow, aux = model(sweeps, valids, with_aux=True)
    excluded = 0
    for b in range(B):
        jflow, jaux = jinfer(params, *_frame(clouds, valid, b))
        gate, rgate = aux["gate_logit"][b].numpy(), np.asarray(jaux["gate_logit"])
        slot, rslot = aux["slot"][b].numpy(), np.asarray(jaux["slot"])
        flip = (gate > 0) != (rgate > 0)
        assert not flip[np.abs(rgate) > MARGIN].any()
        out = flip.copy()
        for sl in np.unique(rslot[flip]):
            if sl >= 0:
                out |= rslot == sl
        excluded += out.sum()
        np.testing.assert_array_equal(slot[~out], rslot[~out])
        np.testing.assert_allclose(flow[b].numpy()[~out], np.asarray(jflow)[~out],
                                   atol=1e-4)
        assert (gate > 0).mean() > 0.05
    assert excluded < 0.01 * B * N


def test_bf16_slice_matches_interpreted_jax(monkeypatch, toy_slice):
    """The same slice in bf16, JAX running K10 and K11 with ``mxu_bf16``
    (interpreted). The two frameworks round the bf16 convolutions,
    GroupNorms and matmuls at other places, so the outputs agree as
    distributions: slots on at least 0.99 of the points, flow within 1e-2 m
    on at least 0.98 of them (a point whose slot differs moves with its
    slot), and the whole gradient of ``sum(flow^2)`` within 2e-2 relative
    in norm at cosine 0.999 or more (measured: 0.9961 of the points within
    1e-2 m, gradient difference 0.95 % of its norm, cosine 0.99996)."""
    _, params, clouds, valid = toy_slice
    jm, _ = JF.make_model("seflowpp", pooling="mean_sorted", dtype="bfloat16", **SLICE)
    model = _port_model(params, "bfloat16")
    counts = _counting(monkeypatch, "sorted_segment_sum", "sorted_segment_gather")
    flow, aux = model(tuple(_t(c) for c in clouds), (_t(valid),) * 3, with_aux=True,
                      soft_gate=True)
    (flow ** 2).sum().backward()
    assert counts == {"sorted_segment_sum": 4, "sorted_segment_gather": 4}
    jtrain, jgrad_fn, _ = _jax_fns(jm)
    near, same_slot, jgrad = [], [], None
    for b in range(B):
        jflow, jaux = jtrain(params, *_frame(clouds, valid, b))
        dist = np.linalg.norm(flow[b].detach().numpy() - np.asarray(jflow), axis=-1)
        near.append(dist <= 1e-2)
        same_slot.append(aux["slot"][b].numpy() == np.asarray(jaux["slot"]))
        g = jgrad_fn(params, *_frame(clouds, valid, b))
        jgrad = g if jgrad is None else jax.tree_util.tree_map(jnp.add, jgrad, g)
    assert np.mean(same_slot) >= 0.99 and np.mean(near) >= 0.98
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrad), model.config)
    got = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                     for k, p in model.named_parameters() if k in want])
    ref = torch.cat([want[k].reshape(-1) for k, _ in model.named_parameters() if k in want])
    assert float((got - ref).norm() / ref.norm()) < 2e-2
    assert float(torch.nn.functional.cosine_similarity(got, ref, dim=0)) >= 0.999
