"""The port's training loop against the JAX package's, on the CPU.

- ``split_train_val`` and ``batch_iterator``: the same splits and the same
  numpy batches, bit for bit, drawing from one generator in the same order
  (two epochs, then the val batches with GT);
- ``train()`` on the CPU (``device="cpu"``): metrics, checkpoints kept by
  ``val_total`` beside the latest one, and a resumed run;
- a JAX toy ``train()`` checkpoint converted by ``scripts/orbax_to_torch.py``:
  the port's val step on a batch within 1e-5 relative of JAX's (float32
  sums in another order), and one further train step within the tolerances
  of ``tests/test_torch_train.py::test_train_step_matches_jax`` (metrics
  1e-5 relative; parameters within 0.1 of the learning rate, all but 0.1 %
  of them within 1e-3 of it).

Inputs are float32 / int32 / bool, as the scene files hold them:
``tests/conftest.py`` enables JAX x64."""

import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from himo_tpu.data.dataset import SceneFlowDataset as JDataset
from himo_tpu.data.synthetic import make_dataset as j_make_dataset
from himo_tpu.models import feedforward as JF
from himo_tpu.parallel.mesh import make_mesh
from himo_tpu.training import checkpoints as JCk
from himo_tpu.training import trainer as JT
from himo_tpu_torch.cli import train as cli_train
from himo_tpu_torch.data import h5
from himo_tpu_torch.data import schema as PS
from himo_tpu_torch.data.dataset import SceneFlowDataset as PDataset
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.training import checkpoints as PCk
from himo_tpu_torch.training import trainer as PT

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import orbax_to_torch  # noqa: E402

TOY = {
    "pillar.voxel_size": (0.8, 0.8),
    "pillar.x_range": (-25.6, 25.6),
    "pillar.y_range": (-25.6, 25.6),
    "depths": (16, 32),
    "point_feat_dim": 8,
    "base_channels": 8,
    "dtype": "float32",
}
LOOP_CFG = dict(batch_size=4, num_points=1024, loss_points=256, log_every=1, lr=1e-3)
SSL_KEYS = ("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The toy runs are many small ops: on a test host whose cores are all
    busy (parallel test workers), intra-op threads only wait on each
    other. The setting is restored after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("batch_size", [1, 4, 8])
def test_split_train_val_matches_jax(batch_size):
    for n in range(0, 90):
        for fraction in (0.0, 0.1, 0.25, 0.5):
            jt, jv = JT.split_train_val(n, batch_size, fraction)
            pt, pv = PT.split_train_val(n, batch_size, fraction)
            assert jt.dtype == pt.dtype and jv.dtype == pv.dtype
            np.testing.assert_array_equal(pt, jt)
            np.testing.assert_array_equal(pv, jv)


def _with_ssl_labels(path, seed):
    """Rewrite a scene through the port's writer with the trainer's SSL
    extras on every frame (the port's writer writes whole files)."""
    rng = np.random.default_rng(seed)
    with h5.File(path) as f:
        frames = [PS.read_frame(f, key) for key in f.keys()]
    with h5.File(path, "w") as f:
        for frame in frames:
            n = frame.num_points
            frame.extras = {
                "ssl_dynamic": frame.flow_instance_id > 0,
                "ssl_cluster": frame.flow_instance_id.astype(np.int32),
                "ssl_prior": rng.normal(0, 0.1, (n, 3)).astype(np.float32),
                "ssl_prior_valid": rng.random(n) < 0.05,
            }
            PS.write_frame(f, frame)
    return frames


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two JAX-written scenes of 9 frames, 1,100 points each (more than the
    1,024-point budget), SSL labels on the second."""
    root = tmp_path_factory.mktemp("loop") / "av2_loop"
    j_make_dataset(root, num_scenes=2, num_frames=9, seed=5, num_background=300)
    _with_ssl_labels(root / "scene_001.h5", 0)
    return root


def _datasets(root):
    kw = dict(with_pc1=True, with_history=True, extra_keys=SSL_KEYS,
              next_keys=("ssl_dynamic",))
    return JDataset(root, **kw), PDataset(root, **kw)


def _assert_same_batches(jbatches, pbatches):
    assert len(jbatches) == len(pbatches) > 0
    for jb, pb in zip(jbatches, pbatches):
        assert set(jb) == set(pb)
        for k in jb:
            assert jb[k].dtype == pb[k].dtype and jb[k].shape == pb[k].shape, k
            assert jb[k].tobytes() == pb[k].tobytes(), k


def test_batch_iterator_matches_jax(scenes):
    jds, pds = _datasets(scenes)
    jcfg, pcfg = JT.TrainConfig(**LOOP_CFG), PT.TrainConfig(**LOOP_CFG)
    train_idx, val_idx = PT.split_train_val(len(pds), pcfg.batch_size, pcfg.val_fraction)
    assert len(train_idx) == 14 and len(val_idx) == 4
    jrng, prng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):  # two epochs from one generator each side
        jb = list(JT.batch_iterator(jds, jcfg, 3, jrng, indices=train_idx))
        pb = list(PT.batch_iterator(pds, pcfg, 3, prng, indices=train_idx))
        _assert_same_batches(jb, pb)
        assert any(b["dynamic0"].any() for b in pb) and any(b["prior_valid0"].any() for b in pb)
    assert jrng.random() == prng.random()  # the generators end in one state
    val = dict(indices=val_idx, extra_keys=("gt",))
    jb = list(JT.batch_iterator(jds, jcfg, 3, np.random.default_rng(1234), **val))
    pb = list(PT.batch_iterator(pds, pcfg, 3, np.random.default_rng(1234), **val))
    _assert_same_batches(jb, pb)
    assert pb[0]["gt_valid"].any()
    # Unshuffled, all frames, no loss samples: whole-frame arrays.
    full = dataclasses.replace(pcfg, loss_points=0)
    jb = list(JT.batch_iterator(jds, dataclasses.replace(jcfg, loss_points=0), 3, None))
    _assert_same_batches(jb, list(PT.batch_iterator(pds, full, 3, None)))


def test_batch_iterator_raises_producer_errors_and_stops_early(scenes):
    _, pds = _datasets(scenes)
    cfg = PT.TrainConfig(**LOOP_CFG)

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise OSError(f"frame {i} unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(PT.batch_iterator(Broken(), cfg, 3, np.random.default_rng(0)))
    rng = np.random.default_rng(0)
    it = PT.batch_iterator(pds, cfg, 3, rng)
    next(it)
    it.close()  # the producer stops and is joined: no later draws
    state = rng.bit_generator.state
    time.sleep(0.2)
    assert rng.bit_generator.state == state


def _run(root, run_dir, epochs, **kw):
    cfg = PT.TrainConfig(**{**LOOP_CFG, "epochs": epochs, "val_every": 1,
                            "keep_checkpoints": 1, **kw})
    return PT.train(str(root), cfg, run_dir=str(run_dir), model_overrides=TOY, device="cpu")


def test_train_on_the_cpu_checkpoints_and_resumes(scenes, tmp_path):
    run = tmp_path / "run"
    first = _run(scenes, run, epochs=2)
    assert set(first) == {"params", "steps", "seconds", "final_metrics"}
    assert first["steps"] == 2 * 3  # 14 train frames -> 3 batches of 4 an epoch
    fm = first["final_metrics"]
    assert all(np.isfinite(v) for v in fm.values())
    assert {"total", "lr", "val_total", "val_epe"} <= set(fm)
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if "train/total" in x] == list(range(1, 7))
    vals = {x["step"]: x["val/val_total"] for x in lines if "val/val_total" in x}
    assert sorted(vals) == [3, 6]
    assert any("ckpt/drain_s" in x for x in lines)
    best = min(vals, key=lambda s: (vals[s], -s))
    assert PCk.CheckpointManager(run / "ckpts").all_steps() == [best]
    assert PCk.CheckpointManager(run / "ckpts_latest").all_steps() == [6]
    step, tree = PCk.CheckpointManager(run / "ckpts_latest").restore_latest()
    assert step == tree["step"] == 6 and tree["opt_state"]["count"] == 6
    for k, v in first["params"].items():
        assert torch.equal(tree["params"][k], v), k

    # A finished run resumes to a no-op; more epochs continue at the saved
    # step and epoch.
    assert _run(scenes, run, epochs=2)["steps"] == 6
    more = _run(scenes, run, epochs=3)
    assert more["steps"] == 9
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if "train/total" in x][-3:] == [7, 8, 9]
    assert PCk.CheckpointManager(run / "ckpts_latest").all_steps() == [9]
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["device"] == "cpu" and cfg["epochs"] == 3


def test_cli_trains_on_the_cpu_without_a_validation_split(scenes, tmp_path):
    run = tmp_path / "run"
    out = cli_train.main(dataset_path=str(scenes), run_dir=str(run), epochs=1, batch_size=4,
                         num_points=1024, loss_points=256, val_fraction=0.0,
                         keep_checkpoints=2, device="cpu", **TOY)
    assert out["steps"] == 4 and "val_total" not in out["final_metrics"]
    assert PCk.CheckpointManager(run / "ckpts").all_steps() == [4]
    assert not (run / "ckpts_latest").exists()
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["batch_size"] == 4 and cfg["val_fraction"] == 0.0 and cfg["lr"] == 6e-5


@pytest.mark.parametrize("entry", ["train", "cli"])
def test_training_needs_cuda_unless_the_cpu_is_asked_for(scenes, tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "train":
            PT.train(str(scenes), PT.TrainConfig(**LOOP_CFG), run_dir=str(tmp_path / "r"),
                     model_overrides=TOY)
        else:
            cli_train.main(dataset_path=str(scenes), run_dir=str(tmp_path / "r"), **TOY)
    assert not (tmp_path / "r" / "ckpts").exists()


def test_checkpoint_manager_retention_and_async_saves(tmp_path):
    best = PCk.CheckpointManager(tmp_path / "best", keep=2, best_metric="val_total")
    for step, v in {1: 5.0, 2: 1.0, 3: 4.0, 4: 0.5, 5: 3.0}.items():
        best.save(step, {"params": {"w": torch.full((2,), float(step))}},
                  metrics={"val_total": v})
    best.close()
    assert best.all_steps() == [2, 4]  # the two best, as JAX's manager keeps
    latest = PCk.CheckpointManager(tmp_path / "latest", keep=2)
    live = torch.arange(1000, dtype=torch.float32)
    for step in (10, 20, 30):
        timing = latest.save(step, {"params": {"w": live}, "step": step})
        assert set(timing) == {"drain_s", "dispatch_s"}
        live.add_(1.0)  # an in-place update after dispatch must not reach the save
    step, tree = latest.restore_latest()
    latest.close()
    assert latest.all_steps() == [20, 30] and step == 30 and tree["step"] == 30
    assert torch.equal(tree["params"]["w"], torch.arange(1000, dtype=torch.float32) + 2)
    assert PCk.load_checkpoint(tmp_path / "latest")["step"] == 30
    assert PCk.load_checkpoint(tmp_path / "latest" / "20")["step"] == 20
    PCk.save_checkpoint(tmp_path / "one", {"x": torch.ones(3), "n": 4})
    assert PCk.load_checkpoint(tmp_path / "one")["n"] == 4
    broken = PCk.CheckpointManager(tmp_path / "broken")
    broken.save(1, {"fn": lambda: 0})  # cannot be pickled: the error surfaces
    with pytest.raises(Exception):
        broken.close()
    assert broken.all_steps() == []
    assert PCk.CheckpointManager(tmp_path / "empty").restore_latest() == (None, None)


@pytest.fixture(scope="module")
def jax_run(scenes, tmp_path_factory):
    """One epoch (3 steps) of JAX's ``train()`` at the toy size on a
    one-device mesh."""
    run = tmp_path_factory.mktemp("jax_run")
    cfg = JT.TrainConfig(**{**LOOP_CFG, "epochs": 1})
    out = JT.train(str(scenes), cfg, run_dir=str(run), mesh=make_mesh(1),
                   model_overrides=TOY)
    assert out["steps"] == 3
    return run, cfg


def test_converted_jax_checkpoint_matches_jax_steps(scenes, jax_run, tmp_path):
    run, jcfg = jax_run
    pcfg = PT.TrainConfig(**{**LOOP_CFG, "epochs": 1})
    step = orbax_to_torch.convert_checkpoint(run / "ckpts_latest", tmp_path / "ckpts_latest",
                                             **TOY)
    assert step == 3
    _, ptree = PCk.CheckpointManager(tmp_path / "ckpts_latest").restore_latest()
    assert ptree["opt_state"]["count"] == 3
    assert all(float(s["step"]) == 3.0 for s in ptree["opt_state"]["adam"]["state"].values())

    jm, _ = JF.make_model("seflowpp", **TOY)
    jopt, jsched = JT.make_optimizer(jcfg, 3)
    init = JF.init_params(jm, jax.random.PRNGKey(0), jcfg.num_points)
    jtree = JCk.load_checkpoint(run / "ckpts_latest",
                                target={"params": init, "opt_state": jopt.init(init), "step": 0})
    model, cfg = PF.make_model("seflowpp", device="cpu", **TOY)
    model.load_state_dict(ptree["params"])
    popt, psched = PT.make_optimizer(model.parameters(), pcfg, 3)
    popt.load_state_dict(ptree["opt_state"])

    jds, _ = _datasets(scenes)
    train_idx, val_idx = JT.split_train_val(len(jds), jcfg.batch_size, jcfg.val_fraction)
    val_batch = list(JT.batch_iterator(
        jds, jcfg, 3, np.random.default_rng(1234), indices=val_idx, extra_keys=("gt",)))[0]
    jval = JT.make_val_step(jm, jcfg)(jtree["params"], val_batch)
    pval = PT.make_val_step(model, pcfg)(PT.to_device(val_batch, torch.device("cpu")))
    for k in jval:
        np.testing.assert_allclose(float(pval[k]), float(jval[k]), rtol=1e-5, err_msg=k)
    assert float(jval["epe_count"]) > 0

    batch = list(JT.batch_iterator(jds, jcfg, 3, np.random.default_rng(9), indices=train_idx))[0]
    jparams, _, jmetrics = JT.make_train_step(jm, jcfg, jopt)(
        jtree["params"], jtree["opt_state"], batch)
    pmetrics = PT.make_train_step(model, pcfg, popt)(PT.to_device(batch, torch.device("cpu")))
    assert set(pmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(pmetrics[k]), float(v), rtol=1e-5, err_msg=k)
    lr = psched(3)
    assert lr == pytest.approx(float(jsched(3))) and lr > 0
    from himo_tpu_torch.utils.convert import flax_to_torch

    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    got = model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=0.1 * lr, rtol=0,
                                   err_msg=k)
    diffs = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
    assert float((diffs > 1e-3 * lr).float().mean()) < 1e-3
    moved = max(float((got[k] - ptree["params"][k]).abs().max()) for k in got)
    assert moved > 0.5 * lr
    # The converted run resumes in the port's own loop.
    port_run = tmp_path / "port_run"
    port_run.mkdir()
    (tmp_path / "ckpts_latest").rename(port_run / "ckpts_latest")
    out = PT.train(str(scenes), dataclasses.replace(pcfg, epochs=2), run_dir=str(port_run),
                   model_overrides=TOY, device="cpu")
    assert out["steps"] == 6
