"""Fleet-scale de-distortion: many scenes, batched on each GPU, overlapped
IO (port of ``himo_tpu/parallel/fleet.py``).

Replaces the reference's sequential per-frame loops (eval.py:281,
save_zip.py:112) with a batch pipeline:

- frames pad to a fixed point budget and stack into batches of
  ``batch_per_device`` frames (the native threaded packer where the
  library is built, :mod:`himo_tpu_torch.native`);
- one batched step (flow inference + fused de-skew) runs on the device;
- a scene-parallel producer prepares and pads the next batches while the
  device computes, and each step's outputs are copied back while the next
  step runs.

One CUDA stream runs everything, in the order it is queued: a copy of step
k's outputs queued after step k+1 would wait for step k+1 too. So each
step's readback is queued right behind it (``non_blocking`` into pinned
host memory, with an event), the next step is queued, and only then does
the host wait on step k's event and consume its outputs. Inputs go up from
pinned memory the same way, so queuing a step never waits for the one
before it.

Across ranks (a ``mesh``, :mod:`himo_tpu_torch.parallel.mesh`) the dataset
splits by whole scenes, balanced by frame count (:func:`split_scenes`),
and each rank runs its scenes on its own device: every scene file is then
rewritten once, by one rank. (JAX splits each step's frames over the
devices instead; split that way, two ranks would rewrite one file.)

Used by the batched ``save`` path (``cli.save fleet=true``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from himo_tpu_torch import native
from himo_tpu_torch.core.transforms import relative_pose, rigid_flow, transform_points
from himo_tpu_torch.parallel.mesh import make_mesh, process_count, rank_device, replicated


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    num_points: int = 65536
    batch_per_device: int = 1
    prefetch: int = 2
    sensor_dt: float = 0.1
    # Zero residual flow below this magnitude (m/frame). Static points' true
    # compensation is identically zero, but a feed-forward net trained on
    # few frames carries static noise that smears backgrounds at de-skew
    # time. The HiMo eval only scores instances >= 3 m/s (0.3 m/frame), so
    # a 0.15-0.2 m gate cannot touch a scored object. 0 = off.
    static_gate: float = 0.0
    # Host-prep worker threads. Frame prep is cheap until the prior-
    # conditioned hybrid (seflowpp_trust) turns it into a per-frame host
    # clustering and matching (PERF.md §5 has its time on the card's
    # host), far above the per-frame device time. Prep parallelizes across
    # SCENES (the velocity-continuity tracker is a per-scene sequential
    # dependency) with a bounded lookahead window so memory stays
    # ~(window x frames/scene x 5 MB).
    prep_threads: int = 8
    # Where prior-conditioned models get their cluster prior:
    # - 'auto': reuse on-disk ssl_prior when the label writers ran (their
    #   priors include the scene-start BACKCAST repair, which reads future
    #   frames — training-consistent but NON-CAUSAL), else compute fresh;
    # - 'fresh': always compute the CAUSAL per-pair prior in the producer
    #   (ignores ssl_prior) — the honest deployment/eval setting;
    # - 'disk': require ssl_prior (raise when absent) — offline labeling.
    prior_source: str = "auto"


def _pad(arr: np.ndarray, n: int, fill=0):
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    k = min(len(arr), n)
    out[:k] = arr[:k]
    return out, k


# Heavy float32 keys whose pad+stack defers to the native threaded packer
# at batch-assembly time (everything else is cheap bools/scalars).
_PACK_KEYS = ("pc0", "pc1", "dt0", "dt1", "pc_hist", "prior")


def frame_to_arrays(
    data: Dict,
    num_points: int,
    with_history: bool,
    defer_pack: bool = False,
    with_prior: bool = False,
    tracker=None,
    prior_source: str = "auto",
    with_dts: bool = False,
) -> Dict:
    """One dataset frame -> fixed-size arrays for the fleet step.

    ``defer_pack=True`` leaves the float32 keys UNPADDED (raw ``(n, C)``
    arrays); :func:`stack_fleet_batch` then pads+stacks them in one
    multithreaded pass through ``native.pack_frames``.

    pc0 ships RAW with the (4, 4) relative ego pose, and the step derives
    the pose flow on the device — one fewer (N, 3) float32 upload per
    frame. The host-side ``rigid_flow`` is only computed when the prior
    path needs the compensated cloud for clustering."""
    xyz0 = data["pc0"][:, :3].astype(np.float32)
    xyz1 = data["pc1"][:, :3].astype(np.float32)
    rel_pose = relative_pose(data["pose0"], data["pose1"]).astype(np.float32)
    lidar_dt = data["lidar_dt"].astype(np.float32)
    dt0 = lidar_dt.max() - lidar_dt

    fit = (lambda a: (a[:num_points], min(len(a), num_points))) if defer_pack \
        else (lambda a: _pad(a, num_points))
    p0, n0 = fit(xyz0)
    p1, n1 = fit(xyz1)
    v0 = np.zeros(num_points, bool)
    v0[:n0] = ~data["gm0"][:n0]
    v1 = np.zeros(num_points, bool)
    v1[:n1] = ~data["gm1"][:n1]
    out = {
        "pc0": p0,
        "pc1": p1,
        "valid0": v0,
        "valid1": v1,
        "rel_pose": rel_pose,
        "dt0": fit(dt0)[0],
        "num_real": n0,
        "num_total": len(xyz0),  # original cloud size (may exceed the budget)
    }
    if with_dts:
        # pc1 capture times for the refine head's de-smeared matching
        # (ops/refine.py); pc0's come free — the device inverts dt0 back
        # (lidar_dt = dt0.max() - dt0), so only ONE extra (N,) f32 ships.
        dt1_raw = data.get("lidar_dt1")
        if dt1_raw is None:
            dt1_raw = np.zeros(len(xyz1), np.float32)
        out["dt1"] = fit(np.asarray(dt1_raw, np.float32))[0]
    if with_history:
        xyzp = data["pc_prev"][:, :3].astype(np.float32)
        rel = relative_pose(data["pose_prev"], data["pose1"])
        ph, nh = fit(transform_points(xyzp, rel).astype(np.float32))
        vh = np.zeros(num_points, bool)
        vh[:nh] = ~data["gm_prev"][:nh]
        out["pc_hist"] = ph
        out["valid_hist"] = vh
    if with_prior:
        use_disk = prior_source in ("auto", "disk") and "ssl_prior" in data
        if prior_source == "disk" and "ssl_prior" not in data:
            raise ValueError(
                "prior_source='disk' but the frame carries no ssl_prior — "
                "run the label writers first or use 'auto'/'fresh'"
            )
        if use_disk:
            # Training data already carries the label writer's priors —
            # including the measured-velocity slow-mover recovery and the
            # scene-start backcast repair (which reads FUTURE frames:
            # training-consistent but non-causal; use prior_source='fresh'
            # for causal evaluation) — so the host clustering is skipped.
            prior_full = np.asarray(data["ssl_prior"], np.float32)
            if "ssl_prior_valid" in data:
                pv = np.asarray(data["ssl_prior_valid"], bool)
                prior_full = np.where(pv[:, None], prior_full, 0.0)
        else:
            # Fresh data: the verified cluster translation prior, computed
            # at FULL resolution (host clustering in the prefetch thread)
            # with the same de-smeared matcher + per-scene velocity-
            # continuity tracker the label writers use (min_norm=0: the
            # flagship's residual composition wants slow movers too, unlike
            # the optimization seeds that only need what chamfer can't
            # reach).
            from himo_tpu_torch.models.nsfp import cluster_prior_flow

            pflow = rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
            comp_full = xyz0 + pflow
            prior_full = cluster_prior_flow(
                comp_full, xyz1, ~np.asarray(data["gm0"], bool),
                ~np.asarray(data["gm1"], bool),
                min_norm=0.0,
                dt0=np.asarray(lidar_dt),
                dt1=data.get("lidar_dt1"),
                tracker=tracker,
                pose1=data.get("pose1"),
            ).numpy()
        out["prior"] = fit(prior_full.astype(np.float32))[0]
    return out


def stack_fleet_batch(frames: List[Dict], num_points: int) -> Dict:
    """Stack per-frame dicts into batch arrays; float32 keys go through the
    native threaded packer when the frames were built with
    ``defer_pack=True`` (raw arrays), numpy otherwise."""
    out = {}
    for k in frames[0]:
        if k in ("num_real", "num_total"):
            continue
        vals = [f[k] for f in frames]
        if (
            k in _PACK_KEYS
            and native.available()
            and any(len(v) != num_points for v in vals)
        ):
            flat = [v.reshape(len(v), -1) for v in vals]
            packed, _ = native.pack_frames(flat, num_points)
            out[k] = packed.reshape((len(vals), num_points) + vals[0].shape[1:])
        else:
            out[k] = np.stack(vals)
    return out


def make_fleet_step(model, config: FleetConfig, outputs=None):
    """Batched step on the model's device: flow inference + de-skew ->
    comp_dis, refined (and flow), each (B, N, 3) float32.

    ``outputs`` (subset of {"comp_dis", "refined", "flow"}, None = all)
    trims what comes back to the host: ``fleet_save`` only consumes
    ``flow``."""
    num_frames = model.config.num_frames
    refine = getattr(model.config, "refine_head", False)

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # Pose flow on the device from the (4, 4) relative ego pose: pc0
        # ships raw. A float32 matmul (TF32 is off package-wide: it would
        # cost ~0.2 m on ~50 m coordinates), as the reference forces
        # HIGHEST precision.
        rel = batch["rel_pose"]
        xyz0 = batch["pc0"]
        pose_flow = (
            torch.matmul(xyz0, rel[:, :3, :3].transpose(1, 2))
            + rel[:, None, :3, 3]
            - xyz0
        )
        pc0_comp = xyz0 + pose_flow
        sweeps = [pc0_comp, batch["pc1"]]
        valids = [batch["valid0"], batch["valid1"]]
        if num_frames >= 3:
            sweeps.append(batch["pc_hist"])
            valids.append(batch["valid_hist"])
        dts = None
        if refine and "dt1" in batch:
            # dt0 ships as compensation weights (max - capture time);
            # invert per frame — padded rows are 0 and never raise the max.
            dt0 = batch["dt0"]
            dts = (dt0.amax(dim=1, keepdim=True) - dt0, batch["dt1"])
        residual = model(tuple(sweeps), tuple(valids), batch.get("prior"), dts=dts)
        if config.static_gate > 0:
            mag = torch.linalg.vector_norm(residual, dim=-1, keepdim=True)
            residual = torch.where(mag >= config.static_gate, residual,
                                   torch.zeros_like(residual))
        comp_dis = residual * (batch["dt0"] / config.sensor_dt)[..., None]
        comp_dis = torch.where(batch["valid0"][..., None], comp_dis,
                               torch.zeros_like(comp_dis))
        # The de-skewed cloud lives in the ORIGINAL ego0 frame:
        # xyz0 + comp_dis — matching core.deskew / reference refine_pts.
        out = {
            "comp_dis": comp_dis,
            "refined": xyz0 + comp_dis,
            "flow": pose_flow + residual,
        }
        if outputs is not None:
            out = {k: v for k, v in out.items() if k in outputs}
        return out

    return step


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


def _to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A stacked batch on ``device``; to a GPU through pinned host memory
    with ``non_blocking`` copies, so queuing them never waits for the
    device (PyTorch's pinned allocator keeps each buffer until its copy
    has run)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in arrays.items()}


def _readback(out: Dict[str, torch.Tensor]):
    """Queue the copy of a step's outputs to the host right behind the step;
    returns ``(host tensors, event)``. The host tensors hold the values once
    the event has completed (None: already complete, off a GPU)."""
    first = next(iter(out.values()))
    if first.device.type != "cuda":
        return {k: v.cpu() for k, v in out.items()}, None
    host = {}
    for k, v in out.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def scene_runs(dataset) -> List[List[int]]:
    """The dataset's frame indices as contiguous per-scene runs, in dataset
    order."""
    ix = dataset.eval_index if dataset.eval_index is not None else dataset.data_index
    scenes: List[List[int]] = []
    for i in range(len(dataset)):
        if scenes and ix[scenes[-1][-1]][0] == ix[i][0]:
            scenes[-1].append(i)
        else:
            scenes.append([i])
    return scenes


def split_scenes(scenes: List[List[int]], n: int, index: int) -> List[List[int]]:
    """Shard ``index`` of ``n`` of whole scenes, balanced by frame count:
    the largest scenes first (ties in dataset order), each to the shard
    with the fewest frames so far (ties to the lower shard). The shard's
    scenes keep dataset order."""
    load = [0] * n
    owner = {}
    for s in sorted(range(len(scenes)), key=lambda s: (-len(scenes[s]), s)):
        k = min(range(n), key=lambda k: (load[k], k))
        owner[s] = k
        load[k] += len(scenes[s])
    return [scene for s, scene in enumerate(scenes) if owner[s] == index]


def _reduce_stats(mesh, stats: Dict[str, float], sums, maxes) -> Dict[str, float]:
    """``stats`` with ``sums`` summed and ``maxes`` maximized over the data
    axis (this rank's alone without a group)."""
    if mesh.group is None:
        return stats
    import torch.distributed as dist

    out = dict(stats)
    for keys, op in ((sums, dist.ReduceOp.SUM), (maxes, dist.ReduceOp.MAX)):
        t = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64,
                         device=mesh.device)
        dist.all_reduce(t, op=op, group=mesh.group)
        if op == dist.ReduceOp.SUM and mesh.model > 1:
            t /= mesh.model
        out.update(zip(keys, t.tolist()))
    return out


def run_fleet(
    dataset,
    model,
    config: FleetConfig = FleetConfig(),
    consumer: Optional[Callable[[int, Dict, Dict], None]] = None,
    outputs=None,
    mesh=None,
) -> Dict[str, float]:
    """De-distort every frame of ``dataset`` on the model's device.

    ``consumer(frame_index, host_arrays, outputs)`` receives per-frame
    results (already trimmed to real points, numpy) for writing; ``None``
    measures throughput only. ``outputs`` restricts which arrays come back
    from the device (see :func:`make_fleet_step`). With ``mesh`` (default:
    every rank of the process group, 1 x 1 without one) this rank runs
    only its whole scenes (:func:`split_scenes` over the data axis) on the
    model's device, which must be the mesh's.

    Returns the reference's stats (``frames``, ``points``, ``seconds``,
    ``points_per_sec``, ``mesh_shards``: the data axis) and the host's
    share: ``prep_s`` (the producer's frame preparation, summed over its
    worker threads), ``stack_s`` (batch stacking and the upload's queuing
    on the main thread), ``wait_s`` (the main thread waiting for a batch)
    and ``drain_s`` (waiting for a step's readback, and the consumer).
    Across ranks ``frames`` and ``points`` are summed, the seconds are the
    slowest rank's, and ``points_per_sec`` comes from those."""
    device = next(model.parameters()).device
    mesh = mesh or make_mesh(devices=[device] * process_count())
    if mesh.device != device:
        raise ValueError(f"the model is on {device}, the mesh's device is {mesh.device}")
    per_step = config.batch_per_device
    with_history = model.config.num_frames >= 3
    step = make_fleet_step(model, config, outputs=outputs)

    q: "queue.Queue" = queue.Queue(maxsize=config.prefetch)
    done = threading.Event()
    stop = object()
    defer_pack = native.available()
    with_prior = bool(getattr(model.config, "prior_feat", False))
    with_dts = bool(getattr(model.config, "refine_head", False))
    ix = dataset.eval_index if dataset.eval_index is not None else dataset.data_index
    scenes = split_scenes(scene_runs(dataset), mesh.data, mesh.data_index)
    prep_s = [0.0]
    prep_lock = threading.Lock()

    def put(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def prep_scene(idxs: List[int]) -> List[Tuple[int, Dict]]:
        """One worker owns a whole scene: the h5 file is touched by a
        single thread, io_uring pre-warms it, and the velocity-continuity
        tracker sees the scene's frames in order."""
        start = time.perf_counter()
        if defer_pack:
            native.preload_files([dataset.directory / f"{ix[idxs[0]][0]}.h5"])
        tracker = None
        out = []
        for i in idxs:
            if done.is_set():
                break
            data = dataset[i]
            if (
                with_prior
                and tracker is None
                and (config.prior_source == "fresh" or "ssl_prior" not in data)
            ):
                from himo_tpu_torch.models.icp_flow import ClusterTracker

                tracker = ClusterTracker()
            out.append((i, frame_to_arrays(
                data, config.num_points, with_history,
                defer_pack=defer_pack, with_prior=with_prior,
                tracker=tracker, prior_source=config.prior_source,
                with_dts=with_dts,
            )))
        with prep_lock:
            prep_s[0] += time.perf_counter() - start
        return out

    def producer():
        try:
            n_workers = max(1, int(config.prep_threads))
            window = n_workers + 2  # bounded lookahead (memory cap)
            buf: List[Tuple[int, Dict]] = []
            with ThreadPoolExecutor(n_workers) as ex:
                pending = [ex.submit(prep_scene, s) for s in scenes[:window]]
                next_scene = len(pending)
                while pending:
                    fut = pending.pop(0)
                    if next_scene < len(scenes):
                        pending.append(ex.submit(prep_scene, scenes[next_scene]))
                        next_scene += 1
                    for item in fut.result():
                        buf.append(item)
                        if len(buf) == per_step:
                            if not put(buf):
                                return
                            buf = []
            if buf:
                # Pad the final partial batch by repeating its last frame.
                while len(buf) < per_step:
                    buf.append((-1, buf[-1][1]))
                if not put(buf):
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised by the consumer
            put(_Failed(exc))
            return
        put(stop)

    frames = 0
    points = 0
    stack_s = wait_s = drain_s = 0.0

    def drain(pending) -> None:
        """Wait for one step's readback and consume it (called AFTER the
        next step is queued, so the device computes batch k+1 while batch
        k's results cross to the host)."""
        nonlocal frames, points
        item, host, event = pending
        if event is not None:
            event.synchronize()
        if consumer is not None:
            out = {k: v.numpy() for k, v in host.items()}
            for b, (i, arrays) in enumerate(item):
                if i < 0:
                    continue
                n = arrays["num_real"]
                consumer(i, arrays, {k: v[b][:n] for k, v in out.items()})
        for i, arrays in item:
            if i >= 0:
                frames += 1
                points += arrays["num_real"]

    thread = threading.Thread(target=producer, name="fleet_producer", daemon=True)
    start = time.perf_counter()
    thread.start()
    try:
        pending = None
        while True:
            t0 = time.perf_counter()
            item = q.get()
            t1 = time.perf_counter()
            wait_s += t1 - t0
            if item is stop:
                break
            if isinstance(item, _Failed):
                raise item.error
            batch = _to_device(
                stack_fleet_batch([f for _, f in item], config.num_points), device)
            stack_s += time.perf_counter() - t1
            host, event = _readback(step(batch))
            if pending is not None:
                t2 = time.perf_counter()
                drain(pending)
                drain_s += time.perf_counter() - t2
            pending = (item, host, event)
        if pending is not None:
            t2 = time.perf_counter()
            drain(pending)
            drain_s += time.perf_counter() - t2
    finally:
        done.set()
        thread.join()
    elapsed = time.perf_counter() - start
    stats = _reduce_stats(mesh, {
        "frames": frames,
        "points": points,
        "seconds": elapsed,
        "prep_s": prep_s[0],
        "stack_s": stack_s,
        "wait_s": wait_s,
        "drain_s": drain_s,
    }, sums=("frames", "points"), maxes=("seconds", "prep_s", "stack_s", "wait_s", "drain_s"))
    stats["frames"], stats["points"] = int(stats["frames"]), int(stats["points"])
    stats["points_per_sec"] = stats["points"] / max(stats["seconds"], 1e-9)
    stats["mesh_shards"] = mesh.data
    return stats


def fleet_save(
    data_dir,
    model: str = "seflowpp",
    checkpoint: Optional[str] = None,
    params=None,
    output_key: Optional[str] = None,
    mesh=None,
    config: FleetConfig = FleetConfig(),
    model_overrides: Optional[Dict] = None,
    verbose: bool = True,
    device: torch.device | str | None = None,
) -> Dict[str, float]:
    """Batched ``save.py``: feed-forward inference with the total flow
    written back under ``output_key`` (CLI: ``python -m
    himo_tpu_torch.cli.save fleet=true``). ``params`` is a state dict;
    ``checkpoint`` a trainer checkpoint directory or a state-dict file
    (``models/feedforward.load_params``). The model runs on ``device``
    (default: the GPU; raises without CUDA), or on the ``mesh``'s device
    (default: every rank of the process group, each on ``device``), its
    parameters broadcast from rank 0; each rank runs its whole scenes
    (:func:`run_fleet`). Each scene file is rewritten once, after the run,
    by the rank that ran it, with every frame's flow zero-padded to the
    frame's points. The stats add ``write_s``, the write-back's seconds
    (the slowest rank's)."""
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.schema import write_method_flows
    from himo_tpu_torch.models.feedforward import load_params, make_model, resolve_device

    if mesh is None:
        mesh = make_mesh(devices=[resolve_device(device)] * process_count())
    elif device is not None and rank_device(device) != mesh.device:
        raise ValueError(f"device={device} but the mesh's device is {mesh.device}")
    net, net_cfg = make_model(model, device=mesh.device, **(model_overrides or {}))
    if params is None:
        if checkpoint is None:
            raise ValueError("fleet_save needs checkpoint= or params=")
        params = load_params(checkpoint, mesh.device)
    net.load_state_dict(params)
    replicated(mesh, net)
    net.eval()
    output_key = output_key or model
    dataset = SceneFlowDataset(
        data_dir, with_pc1=True, with_history=net_cfg.num_frames >= 3,
        # Prior-conditioned flagships reuse on-disk SSL priors when the
        # label writers ran (training-consistent; see frame_to_arrays) and
        # need the successor sweep times for the de-smeared matcher when
        # they didn't.
        extra_keys=("ssl_prior", "ssl_prior_valid"),
        next_keys=("lidar_dt",),
    )
    # (scene_id, timestamp) per frame, matching run_fleet's iteration order.
    index = dataset.eval_index if dataset.eval_index is not None else dataset.data_index

    # Buffer flows and write AFTER the run: the producer threads read the
    # same scene files, and each scene is rewritten whole, once.
    pending: Dict[str, Dict[str, np.ndarray]] = {}

    def consumer(i, host, out):
        flow = out["flow"]
        n = int(host["num_total"])
        if n > len(flow):
            flow = np.concatenate([flow, np.zeros((n - len(flow), 3), np.float32)])
        scene_id, timestamp = index[i]
        pending.setdefault(scene_id, {})[timestamp] = flow[:n]

    stats = run_fleet(
        dataset, net, config=config, consumer=consumer,
        outputs=("flow",),  # the write-back needs nothing else off-device
        mesh=mesh,
    )
    start = time.perf_counter()
    for scene_id, flows in pending.items():
        write_method_flows(data_dir, scene_id, output_key, flows)
    stats = _reduce_stats(mesh, {**stats, "write_s": time.perf_counter() - start},
                          sums=(), maxes=("write_s",))
    if verbose and mesh.rank == 0:
        print(
            f"{output_key}: {stats['frames']} frames, {stats['points']} points "
            f"across {stats['mesh_shards']} shards in {stats['seconds']:.2f}s "
            f"({stats['points_per_sec'] / 1e6:.2f} M pts/s), write-back {stats['write_s']:.2f}s"
        )
    return stats
