"""The SSL train and validation steps (port of the step-level parts of
``himo_tpu/training/trainer.py``).

- :class:`TrainConfig`: the same fields and defaults as the JAX config;
- :func:`build_frame_arrays`: one frame -> fixed-size numpy training arrays,
  the same output for the same ``np.random.Generator`` state;
- :func:`make_optimizer`: Adam under a linear warmup and StepLR, after a
  global-norm clip, with optax's semantics (below);
- :func:`make_train_step` / :func:`make_val_step`.

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
from typing import Dict, Optional

import numpy as np
import torch

from himo_tpu_torch.core.transforms import relative_pose, rigid_flow, transform_points
from himo_tpu_torch.training.losses import (
    SSLLossWeights,
    dyn_image_loss,
    seflowpp_loss,
    seflowpp_loss_sampled,
)


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


# -------------------------------------------------------------- train step


def _frame_flow_and_loss(model, config: TrainConfig, b: Dict):
    """Model flow + per-frame SSL loss terms (each (B,)) for a batch."""
    num_frames = model.config.num_frames
    sweeps = [b["pc0"], b["pc1"]]
    valids = [b["valid0"], b["valid1"]]
    if num_frames >= 3:
        sweeps.append(b["pc_hist"])
        valids.append(b["valid_hist"])
    gate_logit = None
    dyn_logit = None
    if model.config.gate_head:
        # soft_gate: training differentiates THROUGH the sigmoid gate; the
        # refine head is off (refine defaults to not soft_gate).
        flow, aux = model(tuple(sweeps), tuple(valids), with_aux=True, soft_gate=True)
        gate_logit = aux.get("gate_logit")
        dyn_logit = aux.get("dyn_logit")
    else:
        flow = model(tuple(sweeps), tuple(valids))
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
