"""Learned 3-D detection head, CenterPoint-style on the pillar image (port
of ``himo_tpu/downstream/det_net.py``).

The reference's detection downstream runs OpenPCDet TransFusion-L over raw
and compensated clouds. This is the learned equivalent (beside the
geometric cluster-fit harness of :mod:`himo_tpu_torch.downstream.detection`):

- the pillar encoder and UNet backbone of the flow networks
  (``models/feedforward``);
- a center heatmap head (penalty-reduced focal loss on gaussian-splatted GT
  centers, CenterNet-style) and a per-pillar box regression head
  (sub-voxel offset, z0, log-extent, sin/cos yaw), both 1x1 convolutions;
- top-K peak decoding: a 3x3 max-pool padded with -inf as NMS, then the K
  highest peaks, the lower flat index first among equal scores (as
  ``jax.lax.top_k``; a stable descending sort, since ``torch.topk``'s
  order among ties is unspecified).

Experimental contract as the reference's tables: train on undistorted
(GT-compensated) clouds, detect on raw and method-compensated ones, score
with rotated BEV IoU. One frame is one call (batch 1). On the default 256x256
grid at 32,768 points the pillar max takes the resident route (K3 max);
its backward is plain indexing. The model is built on the GPU unless
``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from himo_tpu_torch.models.feedforward import (
    PointFeatureNet,
    UNet,
    _conv_same,
    _torch_dtype,
    init_params,
    resolve_device,
)
from himo_tpu_torch.ops.voxelize import PillarConfig, scatter_max, voxelize_pillars

HEAT_BIAS = -2.19  # the heat head's initial bias: sigmoid(-2.19) ~ 0.1


@dataclasses.dataclass(frozen=True)
class DetNetConfig:
    pillar: PillarConfig = PillarConfig(
        x_range=(-51.2, 51.2), y_range=(-51.2, 51.2), voxel_size=(0.4, 0.4)
    )
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: Tuple[int, ...] = (64, 128)
    max_detections: int = 32
    score_threshold: float = 0.3
    dtype: str = "float32"


class DetNet(nn.Module):
    """Pillar-UNet center-point detector: (B, N, 3) points and (B, N) valid
    -> heatmap logits (B, H, W) and box regression maps (B, H, W, 8), both
    float32."""

    def __init__(self, config: DetNetConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = _torch_dtype(cfg.dtype)
        self.pfn = PointFeatureNet(cfg.point_feat_dim, self.dtype)
        self.unet = UNet(cfg.point_feat_dim, cfg.depths, cfg.base_channels * 2, self.dtype)
        self.conv = nn.Conv2d(cfg.base_channels * 2, cfg.base_channels, 3)
        self.heat = nn.Conv2d(cfg.base_channels, 1, 1)
        self.reg = nn.Conv2d(cfg.base_channels, 8, 1)

    def forward(self, points: torch.Tensor, valid: torch.Tensor):
        dtype = self.dtype
        grid = voxelize_pillars(points, valid, self.config.pillar)
        feat = self.pfn(points, grid.centers_offset)
        feat = torch.where(grid.in_range[..., None], feat, torch.zeros_like(feat))
        image = scatter_max(feat, grid).to(dtype)
        x = self.unet(image.permute(0, 3, 1, 2))
        x = F.relu(_conv_same(self.conv, x, 1, dtype))
        heat = _conv_same(self.heat, x, 1, torch.float32)[:, 0]
        reg = _conv_same(self.reg, x, 1, torch.float32).permute(0, 2, 3, 1)
        return heat, reg


def make_det_model(device: torch.device | str | None = None, **overrides):
    """``(DetNet, DetNetConfig)`` on ``device`` (default: the GPU; raises
    without CUDA). Parameters hold PyTorch's default init until
    :func:`init_det_params` or ``load_state_dict``."""
    config = DetNetConfig(**overrides)
    return DetNet(config).to(resolve_device(device)), config


def init_det_params(model: DetNet, generator: torch.Generator) -> dict:
    """flax's initialisation drawn from ``generator`` (a CPU generator), the
    heat head's bias at ``HEAT_BIAS``. Returns the state dict."""
    init_params(model, generator)
    nn.init.constant_(model.heat.bias, HEAT_BIAS)
    return model.state_dict()


# ------------------------------------------------------------------ targets


def _gaussian_radius(l_pix: float, w_pix: float, min_overlap: float = 0.5) -> int:
    """CenterNet-style radius so a center shifted by r still overlaps."""
    r = 0.5 * min(l_pix, w_pix) * (1.0 - min_overlap) / (1.0 + min_overlap) + 1.0
    return max(int(r), 1)


def render_targets(
    boxes: List[np.ndarray], config: DetNetConfig
) -> Dict[str, np.ndarray]:
    """GT boxes (x, y, z0, l, w, h, yaw) -> heatmap + regression targets."""
    h, w = config.pillar.grid_shape
    vx, vy = config.pillar.voxel_size
    x0, y0 = config.pillar.x_range[0], config.pillar.y_range[0]
    heat = np.zeros((h, w), np.float32)
    reg = np.zeros((h, w, 8), np.float32)
    mask = np.zeros((h, w), bool)
    for box in boxes:
        x, y, z0, l, wd, hh, yaw = [float(v) for v in box[:7]]
        fx = (x - x0) / vx
        fy = (y - y0) / vy
        ix, iy = int(np.floor(fx)), int(np.floor(fy))
        if not (0 <= ix < w and 0 <= iy < h):
            continue
        radius = _gaussian_radius(max(l / vx, 1.0), max(wd / vy, 1.0))
        ys, xs = np.ogrid[-radius : radius + 1, -radius : radius + 1]
        gauss = np.exp(-(xs * xs + ys * ys) / (2 * (radius / 3 + 1e-6) ** 2))
        t, b = max(iy - radius, 0), min(iy + radius + 1, h)
        lft, r = max(ix - radius, 0), min(ix + radius + 1, w)
        heat[t:b, lft:r] = np.maximum(
            heat[t:b, lft:r],
            gauss[
                t - iy + radius : b - iy + radius,
                lft - ix + radius : r - ix + radius,
            ],
        )
        heat[iy, ix] = 1.0
        reg[iy, ix] = [
            fx - ix - 0.5,
            fy - iy - 0.5,
            z0,
            np.log(max(l, 0.1)),
            np.log(max(wd, 0.1)),
            np.log(max(hh, 0.1)),
            np.sin(yaw),
            np.cos(yaw),
        ]
        mask[iy, ix] = True
    return {"heat": heat, "reg": reg, "mask": mask}


# -------------------------------------------------------------------- loss


def detection_loss(heat_logits, reg_pred, targets, reg_weight: float = 1.0):
    """Penalty-reduced focal loss (CenterNet) + masked L1 regression, on
    tensors: ``targets`` holds ``heat`` (H, W), ``reg`` (H, W, 8) and
    ``mask`` (H, W) bool, with any leading batch axes."""
    heat_t = targets["heat"]
    p = torch.sigmoid(heat_logits)
    pos = heat_t >= 0.999
    eps = 1e-6
    pos_loss = -torch.where(pos, ((1 - p) ** 2) * torch.log(p + eps), 0.0)
    neg_loss = -torch.where(
        ~pos, ((1 - heat_t) ** 4) * (p ** 2) * torch.log(1 - p + eps), 0.0
    )
    n_pos = torch.clamp(torch.sum(pos.to(torch.float32)), min=1.0)
    focal = (torch.sum(pos_loss) + torch.sum(neg_loss)) / n_pos
    mask = targets["mask"][..., None]
    l1 = torch.sum(torch.abs(reg_pred - targets["reg"]) * mask) / torch.clamp(
        torch.sum(mask) * 8.0, min=1.0
    )
    return focal + reg_weight * l1, {"focal": focal, "reg_l1": l1}


# ------------------------------------------------------------------- decode


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of a 1-D tensor in
    descending order, the lower index first among equal values (as
    ``jax.lax.top_k``)."""
    scores, idx = torch.sort(values, descending=True, stable=True)
    return scores[:k], idx[:k]


def decode_boxes(heat_logits, reg, config: DetNetConfig):
    """Top-K peak decoding of one frame's (H, W) heat logits and (H, W, 8)
    regression: (K, 7) boxes + (K,) scores."""
    h, w = config.pillar.grid_shape
    vx, vy = config.pillar.voxel_size
    x0, y0 = config.pillar.x_range[0], config.pillar.y_range[0]
    heat = torch.sigmoid(heat_logits)
    # 'SAME' 3x3 max-pool: max_pool2d's padding reads -inf.
    hmax = F.max_pool2d(heat[None, None], 3, stride=1, padding=1)[0, 0]
    peaks = torch.where(heat >= hmax, heat, 0.0)
    scores, idx = top_k(peaks.reshape(-1), config.max_detections)
    iy = idx // w
    ix = idx % w
    r = reg.reshape(h * w, 8)[idx]
    cx = x0 + (ix.to(torch.float32) + 0.5 + r[:, 0]) * vx
    cy = y0 + (iy.to(torch.float32) + 0.5 + r[:, 1]) * vy
    yaw = torch.atan2(r[:, 6], r[:, 7])
    boxes = torch.stack(
        [cx, cy, r[:, 2], torch.exp(r[:, 3]), torch.exp(r[:, 4]), torch.exp(r[:, 5]), yaw],
        dim=1,
    )
    return boxes, scores


# ----------------------------------------------------------------- training


def det_loss(model: DetNet, pts, valid, heat, reg, mask):
    """:func:`detection_loss` of the network's maps on one batch."""
    hl, rp = model(pts, valid)
    return detection_loss(hl, rp, {"heat": heat, "reg": reg, "mask": mask})


def make_det_step(model: DetNet, optimizer: torch.optim.Optimizer):
    """``step(pts, valid, heat, reg, mask) -> loss``: one optimizer step on
    a (1, N, 3) frame and its (1, H, W[, 8]) targets."""

    def step(pts, valid, heat, reg, mask):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = det_loss(model, pts, valid, heat, reg, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def det_train_frames(data_dir: str, config: DetNetConfig, num_points: int = 32768,
                     min_points: int = 15) -> list:
    """The training frames as the reference builds them, in dataset order:
    ``(pts (num_points, 3) float32, valid (num_points,) bool, targets)``
    for each eval frame whose GT-compensated dynamic, non-ground points
    (the focus) fit at least one instance box; ``targets`` from
    :func:`render_targets`."""
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.downstream.detection import gt_boxes_from_instances
    from himo_tpu_torch.downstream.segmentation import _dataset_name
    from himo_tpu_torch.eval.pipeline import prepare_frame

    dataset = SceneFlowDataset(data_dir, eval=True)
    name = _dataset_name(data_dir)
    frames = []
    for i in range(len(dataset)):
        data = dataset[i]
        frame = prepare_frame(data, name, res_name=None)
        gt_comp = (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
        pts = frame["xyz"] + gt_comp
        inst = np.asarray(data["flow_instance_id"])
        gm = np.asarray(data["gm0"], bool)
        focus = (inst > 0) & ~gm
        boxes = gt_boxes_from_instances(pts[focus], inst[focus], min_points)
        if not boxes:
            continue
        targets = render_targets(boxes, config)
        sel = pts[focus].astype(np.float32)
        pts_p = np.zeros((num_points,) + sel.shape[1:], sel.dtype)
        pts_p[: min(len(sel), num_points)] = sel[:num_points]
        valid = np.zeros(num_points, bool)
        valid[: min(int(focus.sum()), num_points)] = True
        frames.append((pts_p, valid, targets))
    return frames


def train_detector(
    data_dir: str,
    model: Optional[DetNet] = None,
    num_points: int = 32768,
    epochs: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    min_points: int = 15,
    verbose: bool = True,
    device: torch.device | str | None = None,
    **model_overrides,
) -> dict:
    """Train on GT-compensated clouds with boxes fitted to GT instances
    (labels-as-boxes, as the geometric harness's GT); returns the state
    dict (the model is trained in place). ``model`` defaults to
    :func:`make_det_model` on ``device``; its weights are drawn anew from
    ``torch.Generator().manual_seed(seed)``. One Adam step a frame (optax's
    defaults), frames in ``np.random.default_rng(seed).permutation`` order
    each epoch."""
    if model is None:
        model, _ = make_det_model(device=device, **model_overrides)
    config = model.config
    dev = next(model.parameters()).device
    frames = det_train_frames(data_dir, config, num_points, min_points)
    init_det_params(model, torch.Generator().manual_seed(seed))
    model.train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_det_step(model, optimizer)

    def on_device(a):
        return torch.from_numpy(a).to(dev)[None]

    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        losses = []
        for i in rng.permutation(len(frames)):
            pts_p, valid, targets = frames[int(i)]
            loss = step(on_device(pts_p), on_device(valid), on_device(targets["heat"]),
                        on_device(targets["reg"]), on_device(targets["mask"]))
            losses.append(float(loss))
        if verbose:
            print(f"[det] epoch {epoch}: loss {np.mean(losses):.4f}")
    return model.state_dict()


# --------------------------------------------------------------- evaluation


def make_infer(model: DetNet, params: Optional[dict] = None):
    """``infer(pts, valid) -> (boxes, scores)`` for (1, N, 3) and (1, N)
    tensors on the model's device, with ``params`` loaded first when
    given; no gradient."""
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    config = model.config

    @torch.inference_mode()
    def infer(pts, valid):
        hl, rp = model(pts, valid)
        return decode_boxes(hl[0], rp[0], config)

    return infer


def detect_frame_learned(
    model: DetNet,
    params: Optional[dict],
    points: np.ndarray,
    num_points: int = 32768,
    infer=None,
) -> List[np.ndarray]:
    """Boxes above the score threshold for one (focus-filtered) cloud."""
    config = model.config
    if infer is None:
        infer = make_infer(model, params)
    dev = next(model.parameters()).device
    pts = np.zeros((num_points, 3), np.float32)
    n = min(len(points), num_points)
    pts[:n] = points[:n, :3]
    valid = np.zeros(num_points, bool)
    valid[:n] = True
    boxes, scores = infer(torch.from_numpy(pts).to(dev)[None],
                          torch.from_numpy(valid).to(dev)[None])
    boxes, scores = boxes.cpu().numpy(), scores.cpu().numpy()
    keep = scores >= config.score_threshold
    return [boxes[i] for i in np.flatnonzero(keep)]


def evaluate_detection_learned(
    data_dir: str,
    model: DetNet,
    params: Optional[dict],
    flow_mode: str = "raw",
    num_points: int = 32768,
    iou_threshold: float = 0.3,
    min_points: int = 15,
    dynamic_only: bool = True,
    verbose: bool = True,
) -> Dict[str, float]:
    """The geometric harness's protocol with the learned detector: detect on
    raw or de-skewed clouds, score against GT-compensated instance boxes;
    ``gt`` de-skews with the GT motion flow (the upper-bound control)."""
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.downstream.detection import gt_boxes_from_instances, match_detections
    from himo_tpu_torch.downstream.segmentation import _dataset_name
    from himo_tpu_torch.eval.pipeline import prepare_frame

    dataset = SceneFlowDataset(
        data_dir, vis_name=flow_mode if flow_mode != "raw" else "", eval=True
    )
    name = _dataset_name(data_dir)
    infer = make_infer(model, params)
    totals = {"tp": 0, "fp": 0, "fn": 0}
    ious = []
    for i in range(len(dataset)):
        data = dataset[i]
        res = None if flow_mode == "gt" else flow_mode
        frame = prepare_frame(data, name, res_name=res)
        pts = frame["xyz"]
        motion = frame["gt_flow"] if flow_mode == "gt" else frame["est_flow"]
        comp = (motion / 0.1) * frame["dt0"][:, None]
        det_pts = pts + comp
        gt_comp = (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
        gt_pts = pts + gt_comp
        inst = np.asarray(data["flow_instance_id"])
        gm = np.asarray(data["gm0"], bool)
        focus = ((inst > 0) & ~gm) if dynamic_only else ~gm
        dets = detect_frame_learned(model, None, det_pts[focus], num_points, infer=infer)
        gts = gt_boxes_from_instances(gt_pts[focus], inst[focus], min_points)
        # A grid detector sees only its range: GT centers outside the pillar
        # grid are left out, as range-filtered evaluations do.
        pil = model.config.pillar
        gts = [
            g
            for g in gts
            if pil.x_range[0] <= g[0] <= pil.x_range[1]
            and pil.y_range[0] <= g[1] <= pil.y_range[1]
        ]
        m = match_detections(dets, gts, iou_threshold)
        for k in ("tp", "fp", "fn"):
            totals[k] += m[k]
        if m["tp"]:
            ious.append(m["mean_iou"])
    precision = totals["tp"] / max(totals["tp"] + totals["fp"], 1)
    recall = totals["tp"] / max(totals["tp"] + totals["fn"], 1)
    result = {
        **totals,
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / max(precision + recall, 1e-9),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
    }
    if verbose:
        print(
            f"[learned/{flow_mode}] P {precision:.3f} R {recall:.3f} "
            f"F1 {result['f1']:.3f} meanIoU {result['mean_iou']:.3f}"
        )
    return result
