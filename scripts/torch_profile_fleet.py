"""Stage costs of the PyTorch port's fleet path (``scripts/profile_fleet.py``'s
counterpart), each stage timed on its own over the JAX bench's e2e
dataset (12 scenes x 5 frames x 64,000 background points, ``seflowpp``
bf16 with seeded random weights, batches of 8 at 65,536 points):

    python3 scripts/torch_profile_fleet.py [--root $TMPDIR/himo_fleet_bench] [--device cuda]

Stages: the scene-file decode (``dataset[i]``), ``rigid_flow``,
``frame_to_arrays`` (padding and masks), ``stack_fleet_batch`` (the native
packer), the pinned ``non_blocking`` upload plus the step's launch, the
synchronize plus the readback, and the write-back. On a GPU it then traces
one more pass over the batches (``chip_smoke.traced``, the script run
alone) and prints the device's busy ms a batch beside them. ``--device`` defaults to the GPU and
raises without CUDA. The dataset is written into ``--root`` unless it is
there already.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NUM_POINTS = 65536
BATCH = 8
SCENES = dict(num_scenes=12, num_frames=5, num_background=64000, seed=0)
BATCH_LABEL = "fleet batch"


def profile(root, device=None, num_points: int = NUM_POINTS, batch_size: int = BATCH,
            model_overrides=None, scenes=None, busy=None) -> dict:
    """Runs every stage over ``root``'s frames and prints the table;
    returns ``{"totals": {stage: s}, "counts": {stage: calls}, "frames",
    "batches", "busy_ms"}``. ``busy(run)``, where given, traces ``run()``
    (one more pass over the batches, each in a ``BATCH_LABEL`` profiler
    range) and returns the device's busy ms inside those ranges;
    ``busy_ms`` is that a batch, None without ``busy``."""
    import torch

    from himo_tpu_torch.core.transforms import rigid_flow
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.schema import write_method_flow
    from himo_tpu_torch.data.synthetic import make_dataset
    from himo_tpu_torch.models.feedforward import init_params, make_model, resolve_device
    from himo_tpu_torch.parallel import fleet
    from himo_tpu_torch.parallel.mesh import batch_rows, make_mesh, replicated, shard_batch
    from himo_tpu_torch.utils.profiling import Timer

    device = resolve_device(device)
    root = Path(root)
    if not (root / "index_eval.pkl").exists():
        make_dataset(root, **(scenes or SCENES))
    overrides = {"dtype": "bfloat16", **(model_overrides or {})}
    model, _ = make_model("seflowpp", device=device, **overrides)
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    config = fleet.FleetConfig(num_points=num_points, batch_per_device=batch_size)
    mesh = make_mesh(devices=[device])
    replicated(mesh, model)
    step = fleet.make_fleet_step(model, config)
    dataset = SceneFlowDataset(root, with_pc1=True, with_history=True)

    timer = Timer()
    n = len(dataset)
    print(f"{n} frames, {num_points} pts budget, mesh {mesh.shape}, device {device}")

    # --- per-frame host stages (sequential, so each cost is clean) ---
    frames = []
    for i in range(n):
        with timer("h5_decode(dataset[i])"):
            data = dataset[i]
        with timer("rigid_flow"):
            rigid_flow(data["pc0"][:, :3].astype(np.float32), data["pose0"], data["pose1"])
        with timer("frame_to_arrays"):
            frames.append(fleet.frame_to_arrays(data, num_points, with_history=True))

    # --- batch assembly + device round trips ---
    batches = []
    for b in range(0, n - batch_size + 1, batch_size):
        with timer("stack_fleet_batch"):
            batches.append(fleet.stack_fleet_batch(frames[b:b + batch_size], num_points))
    rows = batch_rows(mesh, batch_size)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # Warm cuDNN and cuBLAS outside the timers.
    warm = step(shard_batch(mesh, batches[0]))
    {k: v.cpu().numpy() for k, v in warm.items()}

    for batch in batches:
        with timer("upload+step_launch"):
            out = step(fleet._to_device({k: v[rows] for k, v in batch.items()}, device))
        with timer("synchronize+readback"):
            sync()
            out = {k: v.cpu().numpy() for k, v in out.items()}

    busy_ms = None
    if busy is not None:
        from torch.profiler import record_function

        def traced_pass():
            for batch in batches:
                with record_function(BATCH_LABEL):
                    out = step(fleet._to_device({k: v[rows] for k, v in batch.items()}, device))
                    {k: v.cpu() for k, v in out.items()}
            sync()

        busy_ms = busy(traced_pass) / max(len(batches), 1)

    # --- write-back (the volume fleet_save writes) ---
    ix = dataset.data_index
    for i in range(n):
        with timer("h5_write_back"):
            write_method_flow(root, ix[i][0], ix[i][1], "profile_bench",
                              np.zeros((num_points, 3), np.float32))

    timer.print_summary()
    total = sum(timer.totals.values())
    pts = n * num_points
    print(f"\nsequential-sum total {total:.2f}s over {n} frames "
          f"({pts / total / 1e6:.3f} Mpts/s if nothing overlapped)")
    dev = timer.totals["synchronize+readback"]
    print(f"device share {dev:.2f}s -> host overhead {total - dev:.2f}s "
          f"({(total - dev) / total * 100:.0f}%)")
    per_batch = {k: 1e3 * timer.totals[k] / max(len(batches), 1)
                 for k in ("upload+step_launch", "synchronize+readback")}
    busy_text = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms"
    print(f"per batch: upload+step_launch {per_batch['upload+step_launch']:.3f} ms, "
          f"synchronize+readback {per_batch['synchronize+readback']:.3f} ms, "
          f"device busy {busy_text}")
    return {"totals": dict(timer.totals), "counts": dict(timer.counts), "frames": n,
            "batches": len(batches), "busy_ms": busy_ms}


def traced_busy_ms(run) -> float:
    """The device's busy ms inside ``run()``'s ``BATCH_LABEL`` ranges,
    traced by ``chip_smoke.traced`` (``chip_smoke.py`` passes its own)."""
    import chip_smoke as cs

    _, events = cs.traced(run)
    return cs.window_busy(events, BATCH_LABEL)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(tempfile.gettempdir()) / "himo_fleet_bench"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without CUDA)")
    args = ap.parse_args(argv)
    from himo_tpu_torch.models.feedforward import resolve_device

    device = resolve_device(args.device)
    return profile(args.root, device, busy=traced_busy_ms if device.type == "cuda" else None)


if __name__ == "__main__":
    main()
