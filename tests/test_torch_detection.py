"""The port's downstream detection (``himo_tpu_torch/downstream/
detection.py``, ``det_net.py``, ``cli/det_h5.py``) against the JAX package
on the CPU, at toy sizes (a 0.8 m grid over +-25.6 m, depths (16, 32),
feature width 8). JAX's weights come across through
``utils/convert.det_flax_to_torch``; inputs come from seeded numpy.

Tolerances, each with its reason:

- ``fit_bev_box``, ``bev_iou``, ``gt_boxes_from_instances``,
  ``match_detections``, ``render_targets``: bitwise (the same numpy).
- ``detect_frame`` and ``evaluate_detection``: equal (the port's
  ``training/clustering.dbscan`` gives sklearn's labels bit for bit; the
  rest is the same numpy).
- ``DetNet`` heat and regression maps within 1e-4 (float32 sums in
  another order; measured about 5e-6).
- One train step's loss within 1e-5 relative; each parameter's gradient
  within rtol 1e-4 plus 1e-4 of the tensor's largest component. The
  pillar max takes the resident route here, whose backward is plain
  indexing on both sides; its only ties are ReLU zeros, which carry no
  gradient (see ``tests/test_torch_downstream.py``).
- ``decode_boxes``: the peak indices equal, tied scores included (the
  lower flat index first, as ``jax.lax.top_k``); boxes within 1e-5.
- The training frames (points, masks, targets) and their order bitwise.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.downstream import det_net as JD
from himo_tpu.downstream import detection as JG
from himo_tpu.ops.voxelize import PillarConfig as JPillar
from himo_tpu_torch.downstream import det_net as PD
from himo_tpu_torch.downstream import detection as PG
from himo_tpu_torch.ops.voxelize import PillarConfig as PPillar
from himo_tpu_torch.utils.convert import det_flax_to_torch

GRID = dict(x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(0.8, 0.8))
TOY = dict(depths=(16, 32), point_feat_dim=8, base_channels=8, max_detections=8)
N = 2048


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def det_data(tmp_path_factory):
    from himo_tpu_torch.data.synthetic import make_dataset

    root = tmp_path_factory.mktemp("det") / "av2_det"
    make_dataset(root, num_scenes=2, num_frames=4, seed=31, num_background=800,
                 method_flows={"perfect": 0.0})
    return root


@pytest.fixture(scope="module")
def nets():
    jm, jc = JD.make_det_model(pillar=JPillar(**GRID), **TOY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((N, 3)), jnp.ones((N,), bool))
    state = det_flax_to_torch(_numpy(params), jc)
    pm, pc = PD.make_det_model(device="cpu", pillar=PPillar(**GRID), **TOY)
    pm.load_state_dict(state)
    return jm, jc, params, pm, pc, state


def _boxes(seed, n=12):
    rng = np.random.default_rng(seed)
    return [np.array([*rng.uniform(-30, 30, 2), rng.uniform(-1, 1), *rng.uniform(0.3, 6, 3),
                      rng.uniform(-np.pi, np.pi)], np.float32) for _ in range(n)]


def test_box_geometry_is_bitwise_the_reference():
    rng = np.random.default_rng(0)
    for k in range(6):
        pts = (rng.normal(size=(200, 3)) * [3.0, 1.0, 0.7] + rng.uniform(-20, 20, 3))
        pts = pts.astype(np.float32)
        assert PG.fit_bev_box(pts).tobytes() == JG.fit_bev_box(pts).tobytes()
    boxes = _boxes(1)
    for a in boxes:
        np.testing.assert_array_equal(PG._box_corners_bev(a), JG._box_corners_bev(a))
        for b in boxes:
            assert PG.bev_iou(a, b) == JG.bev_iou(a, b)
        near = a.copy()
        near[:2] += 0.3
        assert PG.bev_iou(a, near) == JG.bev_iou(a, near) > 0
    dets, gts = _boxes(2, 9), _boxes(2, 6)
    dets[3] = gts[2] + np.array([0.2, -0.1, 0, 0, 0, 0, 0.05], np.float32)
    for iou in (0.0, 0.3, 0.9):
        assert PG.match_detections(dets, gts, iou) == JG.match_detections(dets, gts, iou)
    assert PG.match_detections(dets, [], 0.3) == JG.match_detections(dets, [], 0.3)
    inst = rng.integers(0, 7, 600)
    pts = rng.normal(size=(600, 3)).astype(np.float32) * 4
    got, want = PG.gt_boxes_from_instances(pts, inst, 60), JG.gt_boxes_from_instances(pts, inst, 60)
    assert len(got) == len(want) > 0
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


def _objects(seed):
    """A cloud of boxes' worth of clustered points with noise, two of them
    touching (a border point in reach of both)."""
    rng = np.random.default_rng(seed)
    parts = [c + rng.normal(0, [1.2, 0.5, 0.4], (int(rng.integers(20, 120)), 3))
             for c in rng.uniform(-25, 25, (8, 3))]
    parts.append(rng.uniform(-30, 30, (150, 3)))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_frame_equals_the_reference(seed):
    pts = _objects(seed)
    ground = np.random.default_rng(seed).uniform(size=len(pts)) < 0.1
    for cfg in (JG.DetectionConfig(), JG.DetectionConfig(dbscan_eps=1.5, min_points=8),
                JG.DetectionConfig(dbscan_eps=0.6, min_points=4, max_clusters=3)):
        pcfg = PG.DetectionConfig(**vars(cfg))
        for gm in (None, ground):
            got, want = PG.detect_frame(pts, gm, pcfg), JG.detect_frame(pts, gm, cfg)
            assert len(got) == len(want)
            assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


@pytest.mark.parametrize("mode", ["raw", "perfect"])
def test_evaluate_detection_equals_the_reference(det_data, mode):
    cfg = dict(min_points=10, dbscan_eps=1.2)
    for dynamic_only in (True, False):
        got = PG.evaluate_detection(str(det_data), mode, PG.DetectionConfig(**cfg),
                                    dynamic_only=dynamic_only, verbose=False)
        want = JG.evaluate_detection(str(det_data), mode, JG.DetectionConfig(**cfg),
                                     dynamic_only=dynamic_only, verbose=False)
        assert got == want
    assert got["tp"] > 0


def test_render_targets_are_bitwise_the_reference():
    for grid in (GRID, dict(voxel_size=(0.4, 0.4))):
        jc, pc = JD.DetNetConfig(pillar=JPillar(**grid)), PD.DetNetConfig(pillar=PPillar(**grid))
        boxes = _boxes(3, 20) + [np.array([25.5, -25.5, 0, 4, 2, 1.5, 0.3], np.float32),
                                 np.array([80, 0, 0, 4, 2, 1.5, 0], np.float32)]
        got, want = PD.render_targets(boxes, pc), JD.render_targets(boxes, jc)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_detnet_maps_match_jax(nets):
    jm, _, params, pm, _, _ = nets
    rng = np.random.default_rng(4)
    pts = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 4, N)
    valid = rng.uniform(size=N) > 0.1
    jh, jr = jax.jit(jm.apply)(params, pts, valid)
    with torch.no_grad():
        ph, pr = pm(_t(pts)[None], _t(valid)[None])
    assert ph.shape == (1, 64, 64) and pr.shape == (1, 64, 64, 8)
    np.testing.assert_allclose(ph[0].numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(pr[0].numpy(), np.asarray(jr), atol=1e-4)
    # The heat head's bias starts at -2.19, as flax's constant init sets it.
    assert float(params["params"]["Conv_1"]["bias"][0]) == pytest.approx(-2.19)
    fresh, _ = PD.make_det_model(device="cpu", pillar=PPillar(**GRID), **TOY)
    state = PD.init_det_params(fresh, torch.Generator().manual_seed(0))
    assert torch.equal(state["heat.bias"], torch.full((1,), -2.19))
    assert not state["reg.bias"].any() and state["conv.weight"].std() > 0


def test_train_step_loss_and_gradients_match_jax(nets):
    jm, jc, params, pm, pc, _ = nets
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, N)
    valid = rng.uniform(size=N) > 0.2
    targets = JD.render_targets(_boxes(6, 8), jc)
    assert targets["mask"].sum() >= 4

    def jax_loss(p):
        hl, rp = jm.apply(p, pts, valid)
        return JD.detection_loss(hl, rp, {k: jnp.asarray(v) for k, v in targets.items()})

    (loss, aux), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    pm.zero_grad(set_to_none=True)
    got, got_aux = PD.det_loss(pm, _t(pts)[None], _t(valid)[None],
                               *(_t(targets[k])[None] for k in ("heat", "reg", "mask")))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in ("focal", "reg_l1"):
        np.testing.assert_allclose(float(got_aux[k].detach()), float(aux[k]), rtol=1e-5)
    want = det_flax_to_torch(_numpy(grads), jc)
    named = dict(pm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    pm.zero_grad(set_to_none=True)


def test_decode_boxes_takes_ties_in_index_order():
    """Peaks quantised to a few levels tie by the dozen; the same K = 32
    peaks in the same order as ``jax.lax.top_k``, and the boxes within
    1e-5. Also a flat map (every score equal) and a single plateau."""
    cfg_j = JD.DetNetConfig(pillar=JPillar(**GRID))
    cfg_p = PD.DetNetConfig(pillar=PPillar(**GRID))
    rng = np.random.default_rng(7)
    reg = rng.normal(0, 0.5, (64, 64, 8)).astype(np.float32)
    quant = (rng.integers(0, 4, (64, 64)) - 2.0).astype(np.float32)
    plateau = np.full((64, 64), -3.0, np.float32)
    plateau[10:20, 30:40] = 1.0
    for logits in (quant, np.zeros((64, 64), np.float32), plateau,
                   rng.normal(size=(64, 64)).astype(np.float32)):
        heat = jax.nn.sigmoid(jnp.asarray(logits))
        hmax = jax.lax.reduce_window(heat, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
        peaks = jnp.where(heat >= hmax, heat, 0.0).reshape(-1)
        want_s, want_i = jax.lax.top_k(peaks, 32)
        got_s, got_i = PD.top_k(_t(np.asarray(peaks)), 32)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        jb, js = JD.decode_boxes(jnp.asarray(logits), jnp.asarray(reg), cfg_j)
        pb, ps = PD.decode_boxes(_t(logits), _t(reg), cfg_p)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-5)
    assert len(set(np.asarray(quant).ravel().tolist())) == 4


def test_training_frames_follow_the_reference(nets, det_data, monkeypatch):
    """JAX's jitted step is wrapped to record the frames it is given; the
    port's frames in its permutation order are the same, bitwise."""
    import himo_tpu.data.dataset  # noqa: F401 - imported before jax.jit is wrapped
    import himo_tpu.eval.pipeline  # noqa: F401

    jm, _, params, _, pc, _ = nets
    real_jit = jax.jit
    seen = []

    def recording_jit(fn, *args, **kwargs):
        if fn.__name__ != "step":
            return real_jit(fn, *args, **kwargs)

        def step(p, opt_state, *frame):
            seen.append([np.asarray(a) for a in frame])
            return p, opt_state, 0.0

        return step

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(JD, "init_det_params", lambda model, key, n: params)
    JD.train_detector(str(det_data), model=jm, num_points=N, epochs=2, seed=4, verbose=False)
    monkeypatch.setattr(jax, "jit", real_jit)

    frames = PD.det_train_frames(str(det_data), pc, N)
    order = []
    rng = np.random.default_rng(4)
    for _ in range(2):
        order += [frames[int(i)] for i in rng.permutation(len(frames))]
    assert len(order) == len(seen) == 2 * 6
    for (pts, valid, targets), want in zip(order, seen):
        got = [pts, valid, targets["heat"], targets["reg"], targets["mask"]]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_det_h5_on_the_cpu(det_data, tmp_path, capsys):
    """``cli.det_h5`` both ways with ``device=cpu`` on a copy of the
    scenes: the geometric detector's results equal the reference CLI's;
    the learned one trains an epoch on the 0.8 m grid and scores finite
    numbers, ``gt`` de-skewing with the GT flow; the model builder refuses
    the GPU default without CUDA."""
    from himo_tpu.cli import det_h5 as jcli
    from himo_tpu_torch.cli import det_h5

    root = tmp_path / "av2"
    shutil.copytree(det_data, root)
    got = det_h5.main(data_dir=str(root), flow_modes=["raw", "perfect"])
    assert got == jcli.main(data_dir=str(root), flow_modes=["raw", "perfect"])
    learned = det_h5.main(data_dir=str(root), flow_modes=["raw", "gt"], detector="learned",
                          epochs=1, num_points=N, voxel=0.8, device="cpu")
    assert all(np.isfinite(v) for r in learned.values() for v in r.values())
    out = capsys.readouterr().out
    assert "[det] epoch 0: loss" in out and "[learned/gt]" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.make_det_model()
