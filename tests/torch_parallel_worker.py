"""One rank of ``tests/test_torch_parallel.py``'s two-rank runs (gloo on
the CPU, one torch thread):

    python tests/torch_parallel_worker.py RANK WORLD WORKDIR

It joins the group through ``WORKDIR/rendezvous`` (``file://``, with a
time limit), runs the tasks that ``WORKDIR/spec.pt`` names, in order, and
saves what each returns into ``WORKDIR/out_RANK.pt``:

- ``basics``: the global mesh, each rank's batch slice, a global sum, the
  indivisible batch's ``ValueError`` and the model axis's mesh;
- ``step``: two sharded train steps at ``tests/multihost_train_worker.py``'s
  toy config from the given weights: the reduced gradient bucket and the
  metrics of step 1, a digest of the parameters after each step;
- ``train``: ``train()`` for one epoch, then resumed for a second, with
  the checkpoint writes counted; then this rank's rows of an epoch of
  ``batch_iterator``;
- ``fleet``: ``fleet_save`` of the given scenes, the scene files written
  counted.

It imports no JAX: the test holds the results against JAX and against
one process."""

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from himo_tpu_torch.parallel import mesh as M  # noqa: E402
from himo_tpu_torch.parallel import multihost  # noqa: E402
from himo_tpu_torch.training import trainer as PT  # noqa: E402

RENDEZVOUS_TIMEOUT_S = 120.0


def digest(model) -> str:
    """SHA-256 of every parameter's bytes, in order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def task_basics(spec, mesh):
    out = {"shape": mesh.shape, "slice": multihost.host_local_batch_slice(8)}
    full = np.arange(8, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    local = multihost.make_global_batch(mesh, {"x": full[out["slice"]]})["x"]
    total = local.sum().reshape(1)
    torch.distributed.all_reduce(total)
    out["sum"] = float(total)
    out["rows"] = M.shard_batch(mesh, {"x": full})["x"].numpy()
    errors = []
    for fn, arg in ((multihost.host_local_batch_slice, 9), (M.batch_rows, 9)):
        try:
            fn(arg) if fn is multihost.host_local_batch_slice else fn(mesh, arg)
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    out["model_axis"] = M.make_mesh(devices=["cpu"] * 2, model_parallel=2).shape
    try:
        M.make_mesh(n_devices=1, devices=["cpu"] * 2)
    except ValueError as exc:
        out["one_device_error"] = str(exc)
    return out


def task_step(spec, mesh):
    from himo_tpu_torch.models.feedforward import make_model

    model, _ = make_model("seflowpp", device="cpu", **spec["step_model"])
    model.load_state_dict(torch.load(spec["step_weights"], weights_only=True))
    config = PT.TrainConfig(**spec["step_config"])
    optimizer, _ = PT.make_optimizer(model.parameters(), config, steps_per_epoch=1)
    buckets = []
    reduce = PT.reduce_gradients

    def recorded(params, mesh):
        buckets.append(reduce(params, mesh).clone())
        return buckets[-1]

    PT.reduce_gradients = recorded
    step = PT.make_train_step(model, config, optimizer, mesh)
    with np.load(spec["step_batch"]) as f:
        full = {k: f[k] for k in f}
    batch = M.shard_batch(mesh, full)
    out = {"digests": [digest(model)], "metrics": []}
    for _ in range(2):
        out["metrics"].append({k: float(v) for k, v in step(batch).items()})
        out["digests"].append(digest(model))
    PT.reduce_gradients = reduce
    out["bucket"] = buckets[0].numpy()
    return out


def task_train(spec, mesh):
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.training import checkpoints

    writes = []
    write = checkpoints._write

    def counted(directory, tree, metrics):
        writes.append(str(directory))
        write(directory, tree, metrics)

    checkpoints._write = counted
    runs = []
    for epochs in (1, 2):
        config = PT.TrainConfig(**{**spec["train_config"], "epochs": epochs})
        result = PT.train(spec["scenes"], config, run_dir=spec["run_dir"], mesh=mesh,
                          model_overrides=spec["train_model"])
        runs.append({"steps": result["steps"], "final": result["final_metrics"],
                     "digest": hashlib.sha256(b"".join(
                         v.numpy().tobytes() for v in result["params"].values())).hexdigest()})
    checkpoints._write = write
    config = PT.TrainConfig(**spec["train_config"])
    dataset = SceneFlowDataset(spec["scenes"], with_pc1=True, with_history=True,
                               extra_keys=tuple(spec["ssl_keys"]), next_keys=("ssl_dynamic",))
    train_idx, _ = PT.split_train_val(len(dataset), config.batch_size, config.val_fraction)
    batches = list(PT.batch_iterator(dataset, config, 3, np.random.default_rng(3),
                                     indices=train_idx,
                                     rows=M.batch_rows(mesh, config.batch_size)))
    return {"runs": runs, "writes": writes, "batches": batches}


def task_fleet(spec, mesh):
    from himo_tpu_torch.data import schema
    from himo_tpu_torch.parallel import fleet

    written = []
    write = schema.write_method_flows

    def counted(data_dir, scene_id, key, flows):
        written.append(scene_id)
        write(data_dir, scene_id, key, flows)

    schema.write_method_flows = counted
    stats = fleet.fleet_save(
        spec["fleet_root"], model="seflowpp",
        params=torch.load(spec["fleet_weights"], weights_only=True),
        output_key="fleet_ranks", mesh=mesh,
        config=fleet.FleetConfig(**spec["fleet_config"]),
        model_overrides=spec["fleet_model"], verbose=False)
    schema.write_method_flows = write
    return {"stats": stats, "written": written}


def main(rank: int, world: int, workdir: Path) -> None:
    torch.set_num_threads(1)
    spec = torch.load(workdir / "spec.pt", weights_only=False)
    multihost.initialize((workdir / "rendezvous").as_uri(), world, rank, device="cpu",
                         timeout=RENDEZVOUS_TIMEOUT_S)
    mesh = multihost.global_mesh(device="cpu")
    out = {}
    for task in spec["tasks"]:
        out[task] = globals()[f"task_{task}"](spec, mesh)
    torch.save(out, workdir / f"out_{rank}.pt")
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: {', '.join(spec['tasks'])} OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
