"""The port's data parallelism (``himo_tpu_torch/parallel/mesh.py``,
``multihost.py``, the sharded step, ``train()`` and ``fleet_save`` across
ranks, ``entry.dryrun_multichip``) against the JAX package's and against
one process, on the CPU.

Two ranks run as two processes of ``tests/torch_parallel_worker.py`` (gloo,
one torch thread each, the rendezvous through a ``file://`` in the test's
directory with a time limit; each waited for with a time limit and killed
past it); they run every two-rank case in one start, while this process
computes the references.

Tolerances:
- the two ranks' parameters bitwise equal after each step;
- step 1's reduced gradients within 1e-5 relative of one process's, plus
  1e-5 of the largest gradient of any parameter (sums in another order; a
  gradient that is zero in exact arithmetic, such as a bias before a
  GroupNorm, is rounding noise on both sides), and within 1e-4 (the same
  form) of JAX's ``value_and_grad`` of the frame-mean loss on the global
  batch; the loss terms within 1e-5 relative of both;
- two-rank ``train()``'s logged losses and validation metrics within 1e-4
  relative of one-rank ``train()``'s over 6 steps (Adam divides by the
  gradients' root mean square, so rounding in the sums moves the
  parameters by up to ~1e-7 of the learning rate a step);
- ``batch_iterator``'s rows of the two ranks, joined, bitwise the
  batches of one process;
- two-rank ``fleet_save``'s flows within 1e-5 m of one rank's.

Inputs are float32 / int32 / bool: ``tests/conftest.py`` enables JAX x64."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_runner import TINY
from test_torch_train_loop import LOOP_CFG, SSL_KEYS, TOY, scenes  # noqa: F401 - a fixture

from himo_tpu.models import feedforward as JF
from himo_tpu.ops.voxelize import PillarConfig as JPillarConfig
from himo_tpu.parallel import mesh as JM
from himo_tpu.parallel import multihost as JMH
from himo_tpu.training import trainer as JT
from himo_tpu_torch import entry
from himo_tpu_torch.data.dataset import SceneFlowDataset as PDataset
from himo_tpu_torch.data.synthetic import make_dataset
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.parallel import fleet as PFL
from himo_tpu_torch.parallel import mesh as PM
from himo_tpu_torch.parallel import multihost as PMH
from himo_tpu_torch.training import checkpoints as PCk
from himo_tpu_torch.training import trainer as PT
from himo_tpu_torch.utils.convert import flax_to_torch

WORKER = Path(__file__).parent / "torch_parallel_worker.py"
WORLD = 2
RANKS_TIMEOUT_S = 240
# tests/multihost_train_worker.py's toy step.
STEP_CFG = dict(model="seflowpp", batch_size=8, num_points=512, loss_points=256, lr=1e-3)
STEP_MODEL = {"pillar.x_range": (-25.6, 25.6), "pillar.y_range": (-25.6, 25.6),
              "pillar.voxel_size": (1.6, 1.6), "depths": (8, 16), "point_feat_dim": 8,
              "base_channels": 8}
FLEET_POINTS = 1024
STEP_RTOL, JAX_RTOL, LOOP_RTOL, FLEET_ATOL_M = 1e-5, 1e-4, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step_batch():
    """``tests/multihost_train_worker.py``'s global batch."""
    rng = np.random.default_rng(7)
    gb, n, k = STEP_CFG["batch_size"], STEP_CFG["num_points"], STEP_CFG["loss_points"]
    return {
        "pc0": rng.normal(scale=10, size=(gb, n, 3)).astype(np.float32),
        "pc1": rng.normal(scale=10, size=(gb, n, 3)).astype(np.float32),
        "valid0": np.ones((gb, n), bool),
        "valid1": np.ones((gb, n), bool),
        "dynamic0": np.zeros((gb, n), bool),
        "dynamic1": np.ones((gb, n), bool),
        "cluster0": np.zeros((gb, n), np.int32),
        "prior0": np.zeros((gb, n, 3), np.float32),
        "prior_valid0": np.zeros((gb, n), bool),
        "loss_idx0": np.tile(np.arange(k, dtype=np.int32), (gb, 1)),
        "loss_idx1": np.tile(np.arange(k, dtype=np.int32), (gb, 1)),
        "pc_hist": rng.normal(scale=10, size=(gb, n, 3)).astype(np.float32),
        "valid_hist": np.ones((gb, n), bool),
    }


class Ranks:
    """The two worker processes; :meth:`result` waits for them (killing
    both past the time limit) and loads each rank's outputs."""

    def __init__(self, workdir: Path):
        self.workdir = workdir
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(WORLD), str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
        self.outputs = None

    def result(self):
        if self.outputs is None:
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            logs = []
            try:
                for p in self.procs:
                    out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
                    logs.append(out.decode())
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self.outputs = [torch.load(self.workdir / f"out_{r}.pt", weights_only=False)
                            for r in range(WORLD)]
        return self.outputs


@pytest.fixture(scope="module")
def ranks(scenes, tmp_path_factory):  # noqa: F811 - the imported fixture
    """Writes the two ranks' inputs and starts them; yields the state the
    tests share."""
    work = tmp_path_factory.mktemp("ranks")
    jm, jcfg = JF.make_model("seflowpp", pillar=JPillarConfig(
        x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), voxel_size=(1.6, 1.6)),
        depths=(8, 16), point_feat_dim=8, base_channels=8)
    n = STEP_CFG["num_points"]
    zeros = tuple(jnp.zeros((n, 3), jnp.float32) for _ in range(3))
    ones = tuple(jnp.ones((n,), bool) for _ in range(3))
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jm.init(k, zeros, ones, None))(jax.random.PRNGKey(0)))
    _, pcfg = PF.make_model("seflowpp", device="cpu", **STEP_MODEL)
    torch.save(flax_to_torch(jparams, pcfg), work / "step.pt")
    np.savez(work / "step_batch.npz", **_step_batch())

    fleet_root = work / "av2_fleet"
    make_dataset(fleet_root, num_scenes=2, num_frames=5, seed=9, num_background=700)
    one_root = work / "av2_fleet_one"
    shutil.copytree(fleet_root, one_root)
    fleet_model, _ = PF.make_model("seflowpp", device="cpu", **TINY)
    torch.save(PF.init_params(fleet_model, torch.Generator().manual_seed(0)), work / "fleet.pt")

    spec = dict(
        tasks=["basics", "step", "train", "fleet"],
        step_model=STEP_MODEL, step_weights=str(work / "step.pt"), step_config=STEP_CFG,
        step_batch=str(work / "step_batch.npz"),
        scenes=str(scenes), run_dir=str(work / "run2"), train_model=TOY,
        train_config=dict(LOOP_CFG, val_every=1, keep_checkpoints=1), ssl_keys=SSL_KEYS,
        fleet_root=str(fleet_root), fleet_weights=str(work / "fleet.pt"), fleet_model=TINY,
        fleet_config=dict(num_points=FLEET_POINTS, batch_per_device=3))
    torch.save(spec, work / "spec.pt")
    yield dict(ranks=Ranks(work), work=work, jm=jm, jcfg=jcfg, jparams=jparams, pcfg=pcfg,
               spec=spec, one_root=one_root)


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("n_devices,model_parallel", [(3, 2), (5, 2), (8, 3), (6, 4), (1, 1)])
def test_make_mesh_matches_jax(n_devices, model_parallel):
    """The same divisibility ``ValueError`` as JAX's, and the trivial mesh's
    shape."""
    try:
        want = dict(JM.make_mesh(n_devices, model_parallel).shape)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            PM.make_mesh(n_devices, model_parallel, devices=["cpu"] * 8)
        return
    mesh = PM.make_mesh(n_devices, model_parallel, devices=["cpu"] * 8)
    assert mesh.shape == want and mesh.group is None and mesh.device == torch.device("cpu")
    assert (JM.DATA_AXIS, JM.MODEL_AXIS) == (PM.DATA_AXIS, PM.MODEL_AXIS)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        PM.make_mesh(2, devices=["cpu"] * 8)


@pytest.mark.parametrize("global_batch", [1, 4, 8])
def test_host_local_batch_slice_matches_jax(global_batch):
    assert PMH.host_local_batch_slice(global_batch) == \
        JMH.host_local_batch_slice(global_batch) == slice(0, global_batch)


@pytest.mark.parametrize("rank,data,model,batch,rows", [
    (0, 1, 1, 8, slice(0, 8)), (1, 2, 1, 8, slice(4, 8)), (3, 4, 1, 8, slice(6, 8)),
    (1, 1, 2, 4, slice(0, 4)), (3, 2, 2, 8, slice(4, 8)), (1, 2, 1, 9, None)])
def test_shard_batch_rows(rank, data, model, batch, rows):
    """Each rank's rows (by its data index, rank // model) on its device;
    an indivisible batch raises."""
    mesh = PM.Mesh(rank=rank, data=data, model=model, device=torch.device("cpu"))
    full = {"x": np.arange(batch * 3, dtype=np.float32).reshape(batch, 3),
            "t": torch.arange(batch)}
    if rows is None:
        with pytest.raises(ValueError, match="not divisible by the data axis"):
            PM.shard_batch(mesh, full)
        return
    got = PM.shard_batch(mesh, full)
    assert isinstance(got["x"], torch.Tensor) and torch.equal(got["x"],
                                                             torch.from_numpy(full["x"][rows]))
    assert torch.equal(got["t"], full["t"][rows])
    assert PM.batch_rows(mesh, batch) == rows


def test_initialize_single_process_and_no_fallback(monkeypatch, capsys):
    """No address and no torchrun environment: one process (printed);
    several processes without an address, or NCCL on CPU ranks, raise."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    PMH.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert "single-process mode" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs a coordinator_address"):
        PMH.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        PMH.initialize("localhost:1", 2, 0, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PMH.initialize(num_processes=2)
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------- two ranks


def test_two_ranks_mesh_slices_and_global_sum(ranks):
    outs = [o["basics"] for o in ranks["ranks"].result()]
    full = np.arange(8, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    for r, out in enumerate(outs):
        assert out["shape"] == {"data": 2, "model": 1}
        assert out["slice"] == slice(4 * r, 4 * r + 4)
        assert out["sum"] == 84.0
        np.testing.assert_array_equal(out["rows"], full[4 * r:4 * r + 4])
        assert out["errors"] == [
            "global_batch=9 not divisible by process_count=2; pad or resize the batch",
            "global_batch=9 not divisible by the data axis (2); pad or resize the batch"]
        assert out["model_axis"] == dict(JM.make_mesh(2, 2).shape) == {"data": 1, "model": 2}
        assert "needs 1 ranks" in out["one_device_error"]


def _flat(state, names):
    return np.concatenate([state[k].reshape(-1) for k in names])


def test_sharded_step_matches_one_process_and_jax(ranks):
    """Step 1's reduced gradients and loss terms against one process's port
    step and JAX's on the global batch; the parameters equal across the
    ranks after both steps (step 2 moves them)."""
    s = ranks
    batch = _step_batch()
    # JAX: value_and_grad of the frame-mean loss, as make_train_step takes it.
    jcfg = JT.TrainConfig(**STEP_CFG)

    def loss(p, b):
        losses = jax.vmap(lambda f: JT._frame_flow_and_loss(s["jm"], jcfg, p, f)[1])(b)
        mean = {k: jnp.mean(v) for k, v in losses.items()}
        return mean["total"], mean

    (_, jmetrics), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        s["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    jgrad = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrad), s["pcfg"])
    # One process, the port.
    model, _ = PF.make_model("seflowpp", device="cpu", **STEP_MODEL)
    model.load_state_dict(torch.load(s["work"] / "step.pt", weights_only=True))
    terms = PT.mean_losses(model, PT.TrainConfig(**STEP_CFG),
                           PT.to_device(batch, torch.device("cpu")))
    terms["total"].backward()
    names = [k for k, _ in model.named_parameters()]
    one = {k: p.grad.numpy() for k, p in model.named_parameters()}

    outs = [o["step"] for o in s["ranks"].result()]
    for out in outs[1:]:
        assert out["digests"] == outs[0]["digests"]
        np.testing.assert_array_equal(out["bucket"], outs[0]["bucket"])
        assert out["metrics"] == outs[0]["metrics"]
    assert outs[0]["digests"][0] == outs[0]["digests"][1] != outs[0]["digests"][2]
    bucket = outs[0]["bucket"]
    assert bucket[-len(names):].tolist() == [1.0] * len(names)  # every parameter had one
    scale = max(float(np.abs(g).max()) for g in one.values())
    offset = 0
    for k in names:
        size = one[k].size
        got = bucket[offset:offset + size].reshape(one[k].shape)
        offset += size
        for want, rtol in ((one[k], STEP_RTOL), (jgrad[k].numpy(), JAX_RTOL)):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=k)
    for k, v in outs[0]["metrics"][0].items():
        np.testing.assert_allclose(v, float(terms[k]), rtol=STEP_RTOL, err_msg=k)
        np.testing.assert_allclose(v, float(jmetrics[k]), rtol=STEP_RTOL, err_msg=k)


def _logged(run_dir):
    lines = [json.loads(x) for x in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in x.items() if k.startswith(("train/", "val/"))} | {"step": x["step"]}
            for x in lines if any(k.startswith(("train/", "val/")) for k in x)]


def test_two_rank_train_matches_one_rank(ranks, scenes, tmp_path):  # noqa: F811
    """Two-rank ``train()`` (an epoch, then resumed for a second) logs what
    one rank logs, within the tolerance above; rank 0 alone writes each
    checkpoint once; the resumed run continues at step 3."""
    s = ranks
    one_dir = tmp_path / "run1"
    for epochs in (1, 2):
        cfg = PT.TrainConfig(**{**s["spec"]["train_config"], "epochs": epochs})
        one = PT.train(str(scenes), cfg, run_dir=str(one_dir), model_overrides=TOY,
                       device="cpu")
    outs = [o["train"] for o in s["ranks"].result()]
    assert [r["steps"] for r in outs[0]["runs"]] == [3, 6] == [r["steps"] for r in outs[1]["runs"]]
    assert [r["digest"] for r in outs[0]["runs"]] == [r["digest"] for r in outs[1]["runs"]]
    run2 = Path(s["spec"]["run_dir"])
    # Rank 0 writes ckpts/3, ckpts_latest/3, ckpts/6, ckpts_latest/6; rank 1 nothing.
    assert [Path(w).relative_to(run2).as_posix() for w in outs[0]["writes"]] == [
        "ckpts/3", "ckpts_latest/3", "ckpts/6", "ckpts_latest/6"]
    assert outs[1]["writes"] == []
    assert PCk.CheckpointManager(run2 / "ckpts_latest").all_steps() == [6]
    cfg = json.loads((run2 / "config.json").read_text())
    assert cfg["mesh"] == str({"data": 2, "model": 1}) and cfg["device"] == "cpu"
    got, want = _logged(run2), _logged(one_dir)
    assert [x["step"] for x in got] == [x["step"] for x in want] == [1, 2, 3, 3, 4, 5, 6, 6]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOOP_RTOL, err_msg=f"{k} step {w['step']}")
    for k, v in one["final_metrics"].items():
        np.testing.assert_allclose(outs[1]["runs"][1]["final"][k], v, rtol=LOOP_RTOL, err_msg=k)


def test_rank_rows_join_into_one_process_batches(ranks, scenes):  # noqa: F811
    """The two ranks' rows of an epoch, joined, are ``batch_iterator``'s
    batches of one process, bitwise."""
    cfg = PT.TrainConfig(**ranks["spec"]["train_config"])
    ds = PDataset(scenes, with_pc1=True, with_history=True, extra_keys=SSL_KEYS,
                  next_keys=("ssl_dynamic",))
    train_idx, _ = PT.split_train_val(len(ds), cfg.batch_size, cfg.val_fraction)
    want = list(PT.batch_iterator(ds, cfg, 3, np.random.default_rng(3), indices=train_idx))
    parts = [o["train"]["batches"] for o in ranks["ranks"].result()]
    assert len(want) == len(parts[0]) == len(parts[1]) == 3
    for w, a, b in zip(want, *parts):
        assert w.keys() == a.keys() == b.keys()
        for k in w:
            joined = np.concatenate([a[k], b[k]])
            assert joined.dtype == w[k].dtype and joined.tobytes() == w[k].tobytes(), k


def test_two_rank_fleet_matches_one_rank(ranks):
    """Each rank rewrites its whole scenes once; the flows are one rank's
    within 1e-5 m; the stats sum the frames and points over the ranks."""
    s = ranks
    spec = s["spec"]
    stats = PFL.fleet_save(
        str(s["one_root"]), model="seflowpp",
        params=torch.load(spec["fleet_weights"], weights_only=True), output_key="fleet_ranks",
        config=PFL.FleetConfig(**spec["fleet_config"]), model_overrides=TINY, verbose=False,
        device="cpu")
    outs = [o["fleet"] for o in s["ranks"].result()]
    assert sorted(outs[0]["written"] + outs[1]["written"]) == ["scene_000", "scene_001"]
    assert all(len(o["written"]) == 1 for o in outs)
    assert stats["mesh_shards"] == 1 and stats["frames"] == 10
    for o in outs:
        st = o["stats"]
        assert st["mesh_shards"] == 2 and st["frames"] == 10
        assert st["points"] == stats["points"] == 10 * FLEET_POINTS
        assert st["points_per_sec"] == st["points"] / st["seconds"]
        assert o["stats"] == outs[0]["stats"]
    flows = 0
    for path in sorted(Path(s["one_root"]).glob("*.h5")):
        with h5py.File(path, "r") as one, h5py.File(Path(spec["fleet_root"]) / path.name,
                                                   "r") as two:
            for key in one:
                if "fleet_ranks" not in one[key]:
                    assert "fleet_ranks" not in two[key]
                    continue
                got, want = two[key]["fleet_ranks"][()], one[key]["fleet_ranks"][()]
                assert got.shape == want.shape and got.dtype == np.float32
                np.testing.assert_allclose(got, want, rtol=0, atol=FLEET_ATOL_M)
                flows += 1
    assert flows == 10


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    results = entry.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in results] == [0, 1]
    assert all(np.isfinite(r["total"]) for r in results)
    assert results[0]["total"] == results[1]["total"]  # the global batch's loss
    assert all(r["backend"] == "gloo" and r["mesh"] == {"data": 2, "model": 1} for r in results)
    assert capsys.readouterr().out.count("grid=32x32 points=1024") == 2


def test_dryrun_multichip_needs_a_gpu_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 GPUs"):
        entry.dryrun_multichip(2)
