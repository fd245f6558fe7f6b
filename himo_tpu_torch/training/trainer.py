"""The SSL training loop (port of ``himo_tpu/training/trainer.py``).

- :class:`TrainConfig`: the same fields and defaults as the JAX config;
- :func:`build_frame_arrays`: one frame -> fixed-size numpy training arrays,
  the same output for the same ``np.random.Generator`` state;
- :func:`split_train_val` and :func:`batch_iterator`: the same held-out
  split and the same numpy batches as JAX's, drawing from the generator in
  the same order (below);
- :func:`make_optimizer`: Adam under a linear warmup and StepLR, after a
  global-norm clip, with optax's semantics (below);
- :func:`make_train_step` / :func:`make_val_step` / :func:`run_validation`;
- :func:`train`: the whole run over a directory of scene files, on the GPU
  unless the caller asks for the CPU, with torch-format checkpoints
  (:mod:`himo_tpu_torch.training.checkpoints`).

The generator's order, which keeps the batches equal to JAX's: ``train``
makes one ``np.random.default_rng(config.seed)``; each epoch's
``batch_iterator`` draws its permutation at its first batch, then its
producer thread draws every ``loss_points`` sample of the epoch, frame by
frame; the next epoch's permutation comes only after that thread is done.

A batch is a dict of (B, ...) tensors on the model's device, with the keys
``build_frame_arrays`` emits. The loss is the mean over frames of the
per-frame terms (the reference ``vmap``s the frame loss and takes
``jnp.mean`` of each term), not a mean pooled over the batch's points.

What optax does that ``torch.optim`` would do otherwise:

- ``optax.linear_schedule(0, lr, warmup)`` gives lr 0 at the first update,
  so the first step leaves the parameters unchanged;
- the warmup is ``min(warmup_steps, max(total_steps // 10, 1))`` steps;
- ``join_schedules`` calls StepLR with ``step - warmup``, so the decay
  boundaries ``e * steps_per_epoch`` count from the end of the warmup, and
  ``piecewise_constant_schedule`` scales once ``count >= boundary``;
- ``clip_by_global_norm`` leaves gradients alone below the max norm and
  otherwise takes ``g / norm * max``: no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``.

``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root)
computes optax's ``adam`` update.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from himo_tpu_torch.core.transforms import relative_pose, rigid_flow, transform_points
from himo_tpu_torch.data.dataset import SceneFlowDataset
from himo_tpu_torch.models.feedforward import init_params, make_model, resolve_device
from himo_tpu_torch.training.checkpoints import CheckpointManager
from himo_tpu_torch.training.losses import (
    SSLLossWeights,
    dyn_image_loss,
    seflowpp_loss,
    seflowpp_loss_sampled,
)
from himo_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Same fields and defaults as the JAX ``TrainConfig``."""

    model: str = "seflowpp"
    batch_size: int = 8
    epochs: int = 12
    lr: float = 6e-5
    step_lr_epochs: int = 3
    step_lr_gamma: float = 0.5
    warmup_steps: int = 100  # linear lr warmup from 0 (capped at run/10)
    grad_clip: float = 2.0  # global-norm clip, 0 = off
    num_points: int = 65536  # fixed per-frame point budget
    loss_points: int = 16384  # chamfer-term sample size (0 = full cloud)
    num_clusters: int = 64
    max_dist: float = 2.0
    dynamic_max_dist: Optional[float] = 5.0
    weights: SSLLossWeights = SSLLossWeights()
    seed: int = 0
    keep_checkpoints: int = 3
    log_every: int = 10
    val_every: int = 3  # epochs
    val_fraction: float = 0.1  # held-out frames when no val_dir is given


# ----------------------------------------------------------------- batches


def build_frame_arrays(
    data: Dict,
    num_points: int,
    num_frames: int,
    loss_points: int = 0,
    rng: Optional[np.random.Generator] = None,
    with_gt: bool = False,
) -> Dict:
    """One frame -> fixed-size training arrays (host, numpy).

    ``with_gt=True`` additionally emits the ground-truth RESIDUAL flow
    (``flow`` minus the pose-induced rigid flow) and its validity mask when
    the frame carries GT, for the validation step's EPE."""

    def fit(arr, fill=0):
        out = np.full((num_points,) + arr.shape[1:], fill, dtype=arr.dtype)
        n = min(len(arr), num_points)
        out[:n] = arr[:n]
        return out, n

    xyz0 = data["pc0"][:, :3].astype(np.float32)
    xyz1 = data["pc1"][:, :3].astype(np.float32)
    pflow = rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
    pc0_comp = xyz0 + pflow

    p0, n0 = fit(pc0_comp)
    p1, n1 = fit(xyz1)
    v0 = np.zeros(num_points, bool)
    v0[:n0] = ~data["gm0"][:n0]
    v1 = np.zeros(num_points, bool)
    v1[:n1] = ~data["gm1"][:n1]

    dyn0 = np.zeros(num_points, bool)
    if "ssl_dynamic" in data:
        dyn0[:n0] = data["ssl_dynamic"][:n0]
    cl0 = np.zeros(num_points, np.int32)
    if "ssl_cluster" in data:
        cl0[:n0] = data["ssl_cluster"][:n0]
    # pc1's dynamic mask = the successor frame's pc0-side SSL labels; when
    # absent every valid pc1 point stays a correspondence candidate.
    dyn1 = v1.copy()
    if "ssl_dynamic1" in data:
        dyn1 = np.zeros(num_points, bool)
        dyn1[:n1] = data["ssl_dynamic1"][:n1]
        dyn1 &= v1
    prior0 = np.zeros((num_points, 3), np.float32)
    prior_valid0 = np.zeros(num_points, bool)
    if "ssl_prior" in data:
        prior0[:n0] = data["ssl_prior"][:n0]
        prior_valid0[:n0] = data["ssl_prior_valid"][:n0]

    out = {
        "pc0": p0,
        "pc1": p1,
        "valid0": v0,
        "valid1": v1,
        "dynamic0": dyn0,
        "dynamic1": dyn1,
        "cluster0": cl0,
        "prior0": prior0,
        "prior_valid0": prior_valid0,
    }
    if loss_points and loss_points < num_points:
        rng = rng or np.random.default_rng(0)

        def sample(valid):
            pool = np.flatnonzero(valid)
            if len(pool) == 0:
                pool = np.array([0])
            return rng.choice(pool, size=loss_points, replace=len(pool) < loss_points).astype(
                np.int32
            )

        out["loss_idx0"] = sample(v0)
        out["loss_idx1"] = sample(v1)
    if with_gt:
        gt_res = np.zeros((num_points, 3), np.float32)
        gt_valid = np.zeros(num_points, bool)
        if "flow" in data:
            res = data["flow"][:, :3].astype(np.float32) - pflow
            g, ng = fit(res)
            gt_res = g
            gt_valid[:ng] = v0[:ng]
            if "flow_is_valid" in data:
                gt_valid[:ng] &= data["flow_is_valid"][:ng].astype(bool)
        out["gt_flow"] = gt_res
        out["gt_valid"] = gt_valid
    if num_frames >= 3:
        xyzp = data["pc_prev"][:, :3].astype(np.float32)
        # History sweep into the pc1 frame (prev -> next ego motion).
        rel = relative_pose(data["pose_prev"], data["pose1"])
        ph, nh = fit(transform_points(xyzp, rel).astype(np.float32))
        vh = np.zeros(num_points, bool)
        vh[:nh] = ~data["gm_prev"][:nh]
        out["pc_hist"] = ph
        out["valid_hist"] = vh
    return out


def split_train_val(num_items: int, batch_size: int, val_fraction: float):
    """Deterministic held-out split: every k-th frame goes to val (spread
    across scenes), sized to at least one batch when the dataset allows."""
    if val_fraction <= 0 or num_items < 2 * batch_size:
        return np.arange(num_items), np.array([], dtype=np.int64)
    n_val = max(batch_size, int(round(num_items * val_fraction)))
    n_val -= n_val % batch_size  # whole batches only
    stride = max(num_items // n_val, 2)
    val = np.arange(0, num_items, stride)[:n_val]
    train = np.setdiff1d(np.arange(num_items), val)
    return train, val


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


def batch_iterator(
    dataset: SceneFlowDataset,
    config: TrainConfig,
    num_frames: int,
    rng: Optional[np.random.Generator],
    prefetch: int = 2,
    indices: Optional[np.ndarray] = None,
    extra_keys: tuple = (),
) -> Iterator[Dict]:
    """Shuffled, threaded batch producer of stacked numpy frame arrays.

    The permutation is drawn at the first batch; one producer thread reads
    and builds the batches in order, ``prefetch`` ahead, and draws each
    frame's samples from ``rng``. An error in the producer is raised here.
    Closing the iterator early stops the producer and waits for it, so
    ``rng`` is never drawn from by two threads. (JAX's producer also warms
    the page cache for the next batch's scene files through its native
    io_uring reader when that library is built; that is not ported.)"""
    pool = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    order = pool[rng.permutation(len(pool))] if rng is not None else pool
    n_batches = len(order) // config.batch_size
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    done = threading.Event()
    stop = object()

    def put(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in range(n_batches):
                idxs = order[b * config.batch_size : (b + 1) * config.batch_size]
                frames = [
                    build_frame_arrays(
                        dataset[int(i)],
                        config.num_points,
                        num_frames,
                        loss_points=config.loss_points,
                        rng=rng,
                        with_gt="gt" in extra_keys,
                    )
                    for i in idxs
                ]
                if not put({k: np.stack([f[k] for f in frames]) for k in frames[0]}):
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised by the consumer
            put(_Failed(exc))
            return
        put(stop)

    thread = threading.Thread(target=worker, name="batch_iterator", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item
    finally:
        done.set()
        thread.join()


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# -------------------------------------------------------------- train step


def _frame_flow_and_loss(model, config: TrainConfig, b: Dict):
    """Model flow + per-frame SSL loss terms (each (B,)) for a batch."""
    num_frames = model.config.num_frames
    sweeps = [b["pc0"], b["pc1"]]
    valids = [b["valid0"], b["valid1"]]
    if num_frames >= 3:
        sweeps.append(b["pc_hist"])
        valids.append(b["valid_hist"])
    # The prior presets see the stored translation prior where it is valid.
    prior_in = None
    if model.config.prior_feat and "prior0" in b:
        prior_in = torch.where(b["prior_valid0"][..., None], b["prior0"],
                               torch.zeros_like(b["prior0"]))
    gate_logit = None
    dyn_logit = None
    if model.config.gate_head:
        # soft_gate: training differentiates THROUGH the sigmoid gate; the
        # refine head is off (refine defaults to not soft_gate).
        flow, aux = model(tuple(sweeps), tuple(valids), prior_in, with_aux=True,
                          soft_gate=True)
        gate_logit = aux.get("gate_logit")
        dyn_logit = aux.get("dyn_logit")
    else:
        flow = model(tuple(sweeps), tuple(valids), prior_in)
    common = dict(
        num_clusters=config.num_clusters,
        weights=config.weights,
        max_dist=config.max_dist,
        dynamic_max_dist=config.dynamic_max_dist,
        prior0=b.get("prior0"),
        prior_valid0=b.get("prior_valid0"),
        gate_logit0=gate_logit,
    )
    args = (flow, b["pc0"], b["pc1"], b["valid0"], b["valid1"], b["dynamic0"],
            b.get("dynamic1", b["valid1"]), b["cluster0"])
    if "loss_idx0" in b:
        losses = seflowpp_loss_sampled(*args, b["loss_idx0"], b["loss_idx1"], **common)
    else:
        losses = seflowpp_loss(*args, **common)
    if dyn_logit is not None:
        obj_pos = b["dynamic0"]
        if "prior_valid0" in b:
            obj_pos = obj_pos | b["prior_valid0"]
        dl = dyn_image_loss(dyn_logit, b["pc0"], b["valid0"], obj_pos, model.config.pillar)
        losses["dyn_img_loss"] = dl
        losses["total"] = losses["total"] + config.weights.dyn_img_loss * dl
    return flow, losses


def mean_losses(model, config: TrainConfig, batch: Dict) -> Dict[str, torch.Tensor]:
    """Each loss term averaged over the batch's frames (0-d tensors)."""
    _, losses = _frame_flow_and_loss(model, config, batch)
    return {k: v.mean() for k, v in losses.items()}


class ClippedAdam:
    """Adam under ``schedule`` after optax's global-norm clip; the
    parameters' ``.grad`` are scaled in place by the clip.
    ``last_grad_norm`` is the global norm before the clip at the latest
    step (a 0-d tensor)."""

    def __init__(self, params, schedule, grad_clip: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.last_grad_norm = None
        self.adam = torch.optim.Adam(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8
        )

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
        self.last_grad_norm = norm
        if self.grad_clip > 0:
            clip = torch.tensor(self.grad_clip, dtype=torch.float32, device=norm.device)
            trigger = norm < clip
            for g in grads:
                g.copy_(torch.where(trigger, g, g / norm.to(g.dtype) * clip.to(g.dtype)))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> Dict:
        """The Adam moments and steps (``torch.optim.Adam``'s state dict)
        and the schedule's ``count``."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_schedule(config: TrainConfig, steps_per_epoch: int):
    """The learning rate at optimizer step ``count`` (0 at the first
    update), as optax's joined warmup + piecewise-constant schedule."""
    spe = max(steps_per_epoch, 1)
    boundaries = [e * spe for e in range(config.step_lr_epochs, config.epochs,
                                         config.step_lr_epochs)]
    warmup = min(config.warmup_steps, max(spe * config.epochs // 10, 1))

    def step_lr(count: int) -> float:
        lr = config.lr
        for bound in boundaries:
            if count >= bound:
                lr *= config.step_lr_gamma
        return lr

    def schedule(count: int) -> float:
        if warmup <= 0:
            return step_lr(count)
        if count < warmup:
            return config.lr * count / warmup
        return step_lr(count - warmup)

    return schedule


def make_optimizer(params, config: TrainConfig, steps_per_epoch: int):
    """Adam + StepLR(step_lr_epochs, step_lr_gamma) with the capped linear
    warmup and, when ``grad_clip > 0``, the global-norm clip. Returns
    ``(optimizer, schedule)``."""
    schedule = make_schedule(config, steps_per_epoch)
    return ClippedAdam(params, schedule, config.grad_clip), schedule


def make_train_step(model, config: TrainConfig, optimizer: ClippedAdam):
    """``train_step(batch) -> metrics``: one optimizer step on the batch;
    metrics are the frame-mean loss terms (detached 0-d tensors)."""

    def train_step(batch: Dict) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        mean = mean_losses(model, config, batch)
        mean["total"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in mean.items()}

    return train_step


def make_val_step(model, config: TrainConfig):
    """``val_step(batch) -> sums``: SSL loss and EPE against the batch's
    ``gt_flow`` / ``gt_valid``, as per-batch SUMS so a caller can take an
    exact mean over several batches. No gradient: the chamfer terms run
    the min-only kernel."""

    @torch.no_grad()
    def val_step(batch: Dict) -> Dict[str, torch.Tensor]:
        flow, losses = _frame_flow_and_loss(model, config, batch)
        err = torch.linalg.vector_norm(flow - batch["gt_flow"], dim=-1)
        gt_v = batch["gt_valid"]
        total = losses["total"]
        return {
            "total_sum": total.sum(),
            "frames": torch.tensor(float(total.shape[0]), device=total.device),
            "epe_sum": torch.where(gt_v, err, torch.zeros_like(err)).sum(),
            "epe_count": gt_v.to(torch.float32).sum(),
        }

    return val_step


def run_validation(val_step, dataset, val_indices, config: TrainConfig, num_frames: int,
                   device: torch.device) -> Dict:
    """Mean SSL loss + EPE over the val split (a fixed rng, so comparable
    across epochs). The JAX function also takes the parameters and the
    mesh; the port's ``val_step`` holds its model, and ``device`` is where
    the batches go."""
    sums = {"total_sum": 0.0, "frames": 0.0, "epe_sum": 0.0, "epe_count": 0.0}
    for batch in batch_iterator(
        dataset,
        config,
        num_frames,
        rng=np.random.default_rng(1234),
        indices=val_indices,
        extra_keys=("gt",),
    ):
        out = val_step(to_device(batch, device))
        for k in sums:
            sums[k] += float(out[k])
    return {
        "val_total": sums["total_sum"] / max(sums["frames"], 1.0),
        "val_epe": sums["epe_sum"] / max(sums["epe_count"], 1.0),
    }


# -------------------------------------------------------------------- loop


def train(
    data_dir: str,
    config: TrainConfig = TrainConfig(),
    run_dir: str = "runs/seflowpp",
    wandb_mode: str = "disabled",
    model_overrides: Optional[dict] = None,
    resume: bool = True,
    device: torch.device | str | None = None,
) -> Dict:
    """Full training run; returns the final parameters (the model's state
    dict) and summary stats, as JAX's ``train`` does.

    The model is built on ``device`` (default: the GPU; without CUDA this
    raises unless ``device="cpu"`` is passed) with the port's
    ``init_params`` drawn from ``config.seed``. ``resume=True`` restores the
    latest checkpoint in ``{run_dir}/ckpts_latest`` (or ``{run_dir}/ckpts``)
    and continues from its step and epoch. Validation and a checkpoint come
    every ``val_every`` epochs and at the end; with a val split the ``keep``
    best checkpoints by ``val_total`` stay in ``ckpts`` and the latest in
    ``ckpts_latest``. Multi-GPU data parallelism (the JAX ``mesh``) is not
    ported."""
    device = resolve_device(device)
    model, model_config = make_model(config.model, device=device, **(model_overrides or {}))
    num_frames = model_config.num_frames
    dataset = SceneFlowDataset(
        data_dir,
        with_pc1=True,
        with_history=num_frames >= 3,
        extra_keys=("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid"),
        next_keys=("ssl_dynamic",),
    )
    if len(dataset) < config.batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} frames < batch_size {config.batch_size}"
        )

    rng = np.random.default_rng(config.seed)
    train_idx, val_idx = split_train_val(
        len(dataset), config.batch_size, config.val_fraction
    )
    steps_per_epoch = len(train_idx) // config.batch_size
    init_params(model, torch.Generator().manual_seed(config.seed))
    optimizer, schedule = make_optimizer(model.parameters(), config, steps_per_epoch)
    train_step = make_train_step(model, config, optimizer)

    logger = MetricsLogger(
        run_dir,
        wandb_mode=wandb_mode,
        config={**dataclasses.asdict(config), "device": str(device)},
    )
    has_val = len(val_idx) >= config.batch_size
    ckpts = CheckpointManager(
        f"{run_dir}/ckpts",
        keep=config.keep_checkpoints,
        best_metric="val_total" if has_val else None,
    )
    # Best-metric retention prunes non-best steps, so the resume point lives
    # in a separate recency-kept manager.
    ckpts_latest = (
        CheckpointManager(f"{run_dir}/ckpts_latest", keep=1) if has_val else ckpts
    )
    val_step = make_val_step(model, config) if has_val else None

    step = 0
    start_epoch = 0
    if resume:
        latest_step, tree = ckpts_latest.restore_latest()
        if tree is None and ckpts_latest is not ckpts:
            latest_step, tree = ckpts.restore_latest()
        if tree is not None:
            model.load_state_dict(tree["params"])
            optimizer.load_state_dict(tree["opt_state"])
            step = int(latest_step)
            # Resumed runs train the REMAINING epochs, not all of them again.
            start_epoch = min(step // max(steps_per_epoch, 1), config.epochs)
            print(
                f"[train] resumed from step {step} (epoch {start_epoch}) "
                f"in {run_dir}/ckpts"
            )
    last_metrics: Dict[str, float] = {}
    val_metrics: Dict[str, float] = {}
    t0 = time.time()

    def validate_and_save():
        nonlocal val_metrics
        tree = {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                "step": step}
        if val_step is not None:
            val_metrics = run_validation(
                val_step, dataset, val_idx, config, num_frames, device
            )
            logger.log(val_metrics, step, prefix="val/")
            logger.print(val_metrics, step, prefix="val ")
            timing = ckpts.save(step, tree, metrics=dict(val_metrics))
            timing2 = ckpts_latest.save(step, tree)
            timing["drain_s"] += timing2["drain_s"]
            timing["dispatch_s"] += timing2["dispatch_s"]
        else:
            timing = ckpts.save(step, tree)
        logger.log(timing, step, prefix="ckpt/")

    for epoch in range(start_epoch, config.epochs):
        for batch in batch_iterator(dataset, config, num_frames, rng, indices=train_idx):
            metrics = train_step(to_device(batch, device))
            step += 1
            if step % config.log_every == 0 or step == 1:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                last_metrics["lr"] = float(schedule(step))
                logger.log(last_metrics, step, prefix="train/")
                logger.print(last_metrics, step, prefix=f"epoch {epoch} ")
        if (epoch + 1) % config.val_every == 0 and epoch != config.epochs - 1:
            validate_and_save()
    validate_and_save()
    ckpts.close()
    if ckpts_latest is not ckpts:
        ckpts_latest.close()
    logger.close()
    return {
        "params": model.state_dict(),
        "steps": step,
        "seconds": time.time() - t0,
        "final_metrics": {**last_metrics, **val_metrics},
    }
