"""The port's downstream segmentation (``himo_tpu_torch/downstream/
segmentation.py``, ``eval/seg.py``, ``cli/seg_h5.py``, ``cli/eval_seg.py``)
against the JAX package on the CPU, at the toy size of
``tests/test_downstream.py``: a 0.8 m grid over +-25.6 m (64 x 64),
depths (16, 32), feature width 8. JAX's weights come across through
``utils/convert.seg_flax_to_torch``; inputs come from seeded numpy.

Tolerances, each with its reason:

- ``SegNet`` logits within 1e-4 (float32 convolutions and GroupNorm
  statistics summed in another order; measured about 2e-6).
- One train step's loss within 1e-5 relative; each parameter's gradient
  within rtol 1e-4 plus 1e-4 of the tensor's largest component (float32
  sums in another order; a component near 0 has no relative scale). The
  pillar max's gradient differs between the two by design where points
  tie at a pillar's max (JAX's CPU ``segment_max`` splits the cotangent,
  the port gives each tied winner all of it): at these inputs the only
  ties are ReLU zeros, whose gradient through the ReLU is 0 on both sides,
  so no tie carries gradient.
- The training loop's inputs (frame order, skipped frames, the
  ``deskew_gt`` points, labels, masks) bitwise; its losses: step 1 within
  1e-5 relative (the same weights), every later step within 1e-3
  relative (measured at most 9e-6 over the 14 steps). Adam's first update
  moves each parameter by about ``lr * sign(g)``, so a gradient component
  near 0 that rounds to the other sign moves a weight by 2 lr: the runs
  part by rounding after step 1, not by a fault.
- ``segment_dataset``'s labels equal JAX's wherever the port's top-two
  logit margin exceeds 1e-4; every other dataset keeps its bytes.
- ``evaluate_segmentation``'s dict and printed text equal JAX's.
"""

import contextlib
import io
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from himo_tpu.downstream import segmentation as JS
from himo_tpu.ops.voxelize import PillarConfig as JPillar
from himo_tpu_torch.downstream import segmentation as PS
from himo_tpu_torch.ops.voxelize import PillarConfig as PPillar
from himo_tpu_torch.utils.convert import seg_flax_to_torch

GRID = dict(x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(0.8, 0.8))
TOY = dict(depths=(16, 32), point_feat_dim=8, base_channels=8)
N = 2048


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """JAX's toy SegNet, its initial weights (flax's init, jitted: the same
    values as ``init_seg_params``' eager init) and the port's net holding
    them."""
    jm, jc = JS.make_seg_model(pillar=JPillar(**GRID), **TOY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((N, 3)), jnp.ones((N,), bool))
    state = seg_flax_to_torch(_numpy(params), jc)
    pm, _ = PS.make_seg_model(device="cpu", pillar=PPillar(**GRID), **TOY)
    pm.load_state_dict(state)
    return jm, jc, params, pm, state


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    """2 scenes x 4 frames of 2,000 points with a ``perfect`` method flow;
    the last frame of each scene lacks ``perfect`` (as a scene's last
    sweep lacks a saved flow) and one frame lacks
    ``flow_category_indices`` (an unlabelled frame)."""
    from himo_tpu_torch.data.synthetic import make_dataset

    root = tmp_path_factory.mktemp("seg") / "av2_seg"
    make_dataset(root, num_scenes=2, num_frames=4, seed=21, num_background=1200,
                 method_flows={"perfect": 0.0})
    for scene in ("scene_000", "scene_001"):
        with h5py.File(root / f"{scene}.h5", "a") as f:
            del f[sorted(f.keys())[-1]]["perfect"]
    with h5py.File(root / "scene_001.h5", "a") as f:
        del f[sorted(f.keys())[1]]["flow_category_indices"]
    return root


def _cloud(seed, n=N):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)  # some past the grid
    pts[:, 2] = rng.uniform(-4, 4, n)  # some past the z range
    return pts, rng.uniform(size=n) > 0.1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_segnet_logits_match_jax(nets):
    jm, _, params, pm, _ = nets
    pts, valid = _cloud(1)
    pts[100:120] = pts[:20]  # duplicated points tie at their pillar's max
    want = np.asarray(jax.jit(jm.apply)(params, pts, valid))
    with torch.no_grad():
        got = pm(_t(pts)[None], _t(valid)[None])[0].numpy()
    assert got.shape == (N, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def _jax_seg_loss(jm, params, pts, valid, labels):
    """The loss of ``himo_tpu.downstream.segmentation.train_segmentation``'s
    step."""
    logits = jm.apply(params, pts, valid)
    raw = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    w = jnp.where(labels > 0, 10.0, 1.0) * valid
    return jnp.sum(raw * w) / jnp.maximum(jnp.sum(w), 1.0)


def _assert_grads(model, want: dict):
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, p in grads.items():
        g = p.grad.numpy()
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_train_step_loss_and_gradients_match_jax(nets):
    jm, jc, params, pm, _ = nets
    pts, valid = _cloud(2)
    labels = np.random.default_rng(3).integers(0, 3, N).astype(np.int32)
    labels[np.random.default_rng(4).uniform(size=N) < 0.7] = 0  # mostly background
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_seg_loss(jm, p, jnp.asarray(pts), jnp.asarray(valid),
                                jnp.asarray(labels))))(params)
    pm.zero_grad(set_to_none=True)
    got = PS.seg_loss(pm, _t(pts)[None], _t(valid)[None], _t(labels)[None])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _assert_grads(pm, seg_flax_to_torch(_numpy(grads), jc))
    pm.zero_grad(set_to_none=True)


def test_training_inputs_and_losses_follow_jax(nets, seg_data, monkeypatch):
    """Both loops from the same weights, 2 epochs with ``deskew_gt``: JAX's
    jitted step is wrapped to record what it is given and its loss."""
    import himo_tpu.data.dataset  # noqa: F401 - imported before jax.jit is wrapped
    import himo_tpu.eval.pipeline  # noqa: F401
    import himo_tpu.eval.seg  # noqa: F401

    jm, _, params, _, state = nets
    real_jit = jax.jit
    seen = []

    def recording_jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if fn.__name__ != "step":
            return compiled

        def step(p, opt_state, pts, valid, labels):
            out = compiled(p, opt_state, pts, valid, labels)
            seen.append((np.asarray(pts), np.asarray(valid), np.asarray(labels), float(out[2])))
            return out

        return step

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(JS, "init_seg_params", lambda model, key, n: params)
    JS.train_segmentation(str(seg_data), model=jm, num_points=N, epochs=2, seed=5,
                          verbose=False, deskew_gt=True)
    monkeypatch.setattr(jax, "jit", real_jit)

    got = []
    make = PS.make_seg_step

    def recording_make(model, optimizer):
        step = make(model, optimizer)

        def rec(pts, valid, labels):
            loss = step(pts, valid, labels)
            got.append((pts[0].numpy(), valid[0].numpy(), labels[0].numpy(), float(loss)))
            return loss

        return rec

    monkeypatch.setattr(PS, "make_seg_step", recording_make)
    monkeypatch.setattr(PS, "init_seg_params", lambda model, gen: model.load_state_dict(state))
    pm, _ = PS.make_seg_model(device="cpu", pillar=PPillar(**GRID), **TOY)
    PS.train_segmentation(str(seg_data), model=pm, num_points=N, epochs=2, seed=5,
                          verbose=False, deskew_gt=True)

    assert len(got) == len(seen) == 2 * 7  # 8 frames an epoch, one unlabelled
    for (gp, gv, gl, _), (wp, wv, wl, _) in zip(got, seen):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gl, wl)
    # The de-skewed points are not the raw ones.
    frames = [f for _, f, _, _ in PS.seg_train_frames(str(seg_data), N, 1, seed=5)]
    assert not all(np.array_equal(a, b[0]) for a, b in zip(frames, got))
    losses, want = np.array([g[3] for g in got]), np.array([s[3] for s in seen])
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(losses, want, rtol=1e-3)


def _datasets(path):
    with h5py.File(path, "r") as f:
        return {k: {n: f[k][n][()] for n in f[k]} for k in f}


@pytest.mark.parametrize("flow_mode", ["perfect", "gt"])
def test_segment_dataset_write_back_matches_jax(nets, seg_data, tmp_path, flow_mode):
    """Both packages write the same labels into copies of the same scenes
    (JAX with h5py in append mode, the port with one rewrite a scene), at
    1,024 points a frame: the rest of each 2,000-point frame is labelled 0.
    ``perfect`` falls back to raw on the frames that lack it."""
    jm, _, params, pm, state = nets
    jroot, proot = tmp_path / "j" / "av2", tmp_path / "p" / "av2"
    shutil.copytree(seg_data, jroot)
    shutil.copytree(seg_data, proot)
    before = {p.name: _datasets(p) for p in sorted(seg_data.glob("*.h5"))}
    n_points = 1024
    assert JS.segment_dataset(str(jroot), jm, params, flow_mode=flow_mode,
                              num_points=n_points, verbose=False) == 8
    assert PS.segment_dataset(str(proot), pm, state, flow_mode=flow_mode,
                              num_points=n_points, verbose=False) == 8

    from himo_tpu_torch.data.dataset import SceneFlowDataset

    dataset = SceneFlowDataset(proot, vis_name=flow_mode)
    key = f"seg_{flow_mode}"
    checked = 0
    for i in range(len(dataset)):
        data = dataset[i]
        pts, valid, n = PS.seg_inputs(data, "av2", flow_mode, n_points)
        with torch.no_grad():
            logits = pm(_t(pts)[None], _t(valid)[None])[0].numpy()[:n]
        top2 = np.sort(logits, axis=1)[:, -2:]
        sure = np.zeros(n, bool)
        sure[: min(n, n_points)] = (top2[:, 1] - top2[:, 0])[: min(n, n_points)] > 1e-4
        name, group = f"{data['scene_id']}.h5", str(data["timestamp"])
        got = _datasets(proot / name)[group]
        want = _datasets(jroot / name)[group]
        assert set(got) == set(want) == set(before[name][group]) | {key, "seg_valid"}
        for ds, arr in before[name][group].items():
            assert got[ds].dtype == arr.dtype and got[ds].tobytes() == arr.tobytes(), ds
        assert got[key].dtype == want[key].dtype == np.uint8 and got[key].shape == (n,)
        np.testing.assert_array_equal(got[key][sure], want[key][sure])
        assert not got[key][n_points:].any() and not want[key][n_points:].any()
        np.testing.assert_array_equal(got["seg_valid"], want["seg_valid"])
        assert got["seg_valid"].dtype == np.uint8
        checked += int(sure.sum())
    assert checked > 0.5 * 8 * n_points


def test_segment_dataset_falls_back_to_raw_for_a_missing_flow(nets, seg_data, tmp_path):
    _, _, _, pm, state = nets
    root = tmp_path / "av2"
    shutil.copytree(seg_data, root)
    for mode in ("raw", "nosuchflow"):
        PS.segment_dataset(str(root), pm, state, flow_mode=mode, num_points=1024,
                           verbose=False)
    for path in sorted(root.glob("*.h5")):
        for group in _datasets(path).values():
            np.testing.assert_array_equal(group["seg_nosuchflow"], group["seg_raw"])


def _jax_eval_seg(root, names, mask_only):
    from himo_tpu.cli.eval_seg import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(data_dir=str(root), res_names=names, mask_only=mask_only)
    return out, buf.getvalue()


def _port_eval_seg(root, names, mask_only):
    from himo_tpu_torch.cli.eval_seg import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(data_dir=str(root), res_names=names, mask_only=mask_only)
    return out, buf.getvalue()


@pytest.mark.parametrize("mask_only", [False, True])
def test_evaluate_segmentation_equals_jax(seg_data, tmp_path, mask_only):
    """Scores and printed block of ``cli.eval_seg``: a GT copy, all
    background, random categories (a missing key warns), with ``seg_valid``
    dropping a third of the points."""
    root = tmp_path / "av2"
    shutil.copytree(seg_data, root)
    rng = np.random.default_rng(6)
    for path in sorted(root.glob("*.h5")):
        with h5py.File(path, "a") as f:
            for k, g in f.items():
                n = len(g["lidar"])
                cats = g["flow_category_indices"][()] if "flow_category_indices" in g else None
                if cats is not None:
                    g.create_dataset("seg_gtcopy", data=cats)
                g.create_dataset("seg_zero", data=np.zeros(n, np.uint8))
                if k != sorted(f.keys())[0]:
                    g.create_dataset("seg_rand", data=rng.integers(0, 30, n).astype(np.uint8))
                g.create_dataset("seg_valid", data=(rng.uniform(size=n) > 0.33).astype(np.uint8))
    names = ["seg_gtcopy", "seg_zero", "seg_rand"]
    want, want_text = _jax_eval_seg(root, names, mask_only)
    got, got_text = _port_eval_seg(root, names, mask_only)
    assert got == want
    assert got_text == want_text
    assert "[Warning]: No seg_rand" in got_text and "[Warning]: No flow_category_indices" in got_text
    assert got["seg_gtcopy"]["miou"] == pytest.approx(1.0)


def test_iou_evaluator_and_remap_equal_jax():
    from himo_tpu.eval import seg as JE
    from himo_tpu_torch.eval import seg as PE

    rng = np.random.default_rng(7)
    pred, gt = rng.integers(0, 3, 5000), rng.integers(0, 3, 5000)
    for ignore in ((), (0,)):
        j, p = JE.IoUEvaluator(3, ignore), PE.IoUEvaluator(3, ignore)
        for ev in (j, p):
            ev.add_batch(pred, gt)
            ev.add_batch(pred[:100], gt[100:200])
        np.testing.assert_array_equal(p.confusion, j.confusion)
        (pm, pc), (jm, jc) = p.iou(), j.iou()
        assert pm == jm and np.array_equal(pc, jc)
    cats = rng.integers(0, 31, 1000)
    np.testing.assert_array_equal(PE.remap_to_three_classes(cats),
                                  JE.remap_to_three_classes(cats))
    three = rng.integers(0, 3, 100)
    np.testing.assert_array_equal(PS._expand_labels(three), JS._expand_labels(three))
    for path in ("/d/av2_x", "/d/scania_y", "/d/other"):
        assert PS._dataset_name(path) == JS._dataset_name(path)


def test_seg_h5_and_eval_seg_on_the_cpu(seg_data, tmp_path, capsys):
    """The CLIs end to end with ``device=cpu``: train one epoch and save a
    checkpoint, segment from it, segment in smoke mode, score; the model
    builders refuse the GPU default without CUDA."""
    from himo_tpu_torch.cli import eval_seg, seg_h5
    from himo_tpu_torch.training.checkpoints import load_checkpoint

    root = tmp_path / "av2"
    shutil.copytree(seg_data, root)
    toy = dict(pillar=PPillar(**GRID), **TOY)
    ckpt = tmp_path / "seg_ckpt"
    assert seg_h5.main(path_dataset=str(root), train=True, epochs=1, ckpt=str(ckpt),
                       num_points=1024, device="cpu", **toy) == 8
    assert set(load_checkpoint(ckpt)["params"]) == set(PS.SegNet(PS.SegConfig(**toy))
                                                       .state_dict())
    assert seg_h5.main(path_dataset=str(root), ckpt=str(ckpt), flow_mode="perfect",
                       num_points=1024, device="cpu", **toy) == 8
    assert seg_h5.main(path_dataset=str(root), flow_mode="gt", num_points=1024,
                       device="cpu", **toy) == 8
    out = capsys.readouterr().out
    assert "[seg] epoch 0: loss" in out and "smoke mode" in out
    res = eval_seg.main(data_dir=str(root), res_names=["seg_raw", "seg_perfect", "seg_gt"])
    assert all(np.isfinite(r["miou"]) for r in res.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PS.make_seg_model()
