"""Downstream semantic segmentation on (compensated) point clouds (port of
``himo_tpu/downstream/segmentation.py``).

The reference's downstream segmentation runs WaffleIron's ``eval_h5.py``
over raw and compensated clouds and writes per-point label keys
``seg_{flow_mode}`` into the .h5 scenes, which ``cli.eval_seg`` scores:

- :class:`SegNet`, a pillar-UNet point classifier on the flow networks'
  encoder and backbone (``models/feedforward``): PFN, the pillar max-pool
  (``ops/voxelize.scatter_max``), the UNet, the pillar gather and a
  two-layer per-point head;
- :func:`segment_dataset`, the ``eval_h5`` surface: de-skew each cloud
  with a stored flow first (``flow_mode``), run the network, write
  ``seg_valid`` and ``seg_{flow_mode}`` back, one rewrite a scene
  (``data/schema.rewrite_scene``) after its last frame is read;
- :func:`train_segmentation`, supervised training against the GT
  ``flow_category_indices``: one Adam step a frame, frames in the order of
  ``np.random.default_rng(seed).permutation`` each epoch.

One frame is one call (batch 1), as in the reference. On the default
512x512 grid at 32,768 points the pillar max takes the table route (K1
max), its backward K5, and the gather's backward K1 sum. The model is
built on the GPU unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from himo_tpu_torch.models.feedforward import (
    PointFeatureNet,
    UNet,
    _linear,
    _torch_dtype,
    init_params,
    resolve_device,
)
from himo_tpu_torch.ops.voxelize import (
    PillarConfig,
    gather_pillars,
    scatter_max,
    voxelize_pillars,
)


@dataclasses.dataclass(frozen=True)
class SegConfig:
    pillar: PillarConfig = PillarConfig()
    num_classes: int = 3  # {ignore, car, other_vehicle}
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: tuple = (64, 128, 256)
    dtype: str = "float32"


class SegNet(nn.Module):
    """Pillar-UNet per-point classifier: (B, N, 3) points and (B, N) valid
    -> (B, N, num_classes) float32 logits."""

    def __init__(self, config: SegConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = _torch_dtype(cfg.dtype)
        hidden = cfg.base_channels * 2
        self.pfn = PointFeatureNet(cfg.point_feat_dim, self.dtype)
        self.unet = UNet(cfg.point_feat_dim, cfg.depths, hidden, self.dtype)
        self.dense0 = nn.Linear(hidden + cfg.point_feat_dim, hidden)
        self.dense1 = nn.Linear(hidden, cfg.num_classes)

    def forward(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        grid = voxelize_pillars(points, valid, self.config.pillar)
        feat = self.pfn(points, grid.centers_offset)
        feat = torch.where(grid.in_range[..., None], feat, torch.zeros_like(feat))
        image = scatter_max(feat, grid).to(dtype)
        out_img = self.unet(image.permute(0, 3, 1, 2))
        pillar_feat = gather_pillars(out_img.permute(0, 2, 3, 1), grid).to(dtype)
        x = torch.cat([pillar_feat, feat], dim=-1)
        x = F.relu(_linear(self.dense0, x, dtype))
        return _linear(self.dense1, x, torch.float32)


def make_seg_model(device: torch.device | str | None = None, **overrides):
    """``(SegNet, SegConfig)`` on ``device`` (default: the GPU; raises
    without CUDA). Parameters hold PyTorch's default init until
    :func:`init_seg_params` or ``load_state_dict``."""
    config = SegConfig(**overrides)
    return SegNet(config).to(resolve_device(device)), config


def init_seg_params(model: SegNet, generator: torch.Generator) -> dict:
    """flax's initialisation drawn from ``generator`` (a CPU generator):
    lecun-normal Dense and Conv kernels, zero biases, GroupNorm scale 1 and
    bias 0. Returns the state dict."""
    return init_params(model, generator)


def seg_loss(model: SegNet, pts: torch.Tensor, valid: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Class-weighted cross-entropy of one batch: weight 10 where the label
    is a vehicle (> 0), 1 elsewhere, times ``valid``; the weighted sum over
    the sum of weights (at least 1)."""
    logits = model(pts, valid)
    raw = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long(), reduction="none")
    w = torch.where(labels > 0, 10.0, 1.0).reshape(-1) * valid.reshape(-1)
    return torch.sum(raw * w) / torch.clamp(torch.sum(w), min=1.0)


def make_seg_step(model: SegNet, optimizer: torch.optim.Optimizer):
    """``step(pts, valid, labels) -> loss``: one optimizer step on a
    (1, N, 3) frame, its (1, N) mask and (1, N) int32 labels."""

    def step(pts, valid, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = seg_loss(model, pts, valid, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _fit(arr: np.ndarray, num_points: int, fill=0) -> Tuple[np.ndarray, int]:
    out = np.full((num_points,) + arr.shape[1:], fill, dtype=arr.dtype)
    n = min(len(arr), num_points)
    out[:n] = arr[:n]
    return out, n


def seg_train_frames(
    data_dir: str, num_points: int, epochs: int, seed: int = 0, deskew_gt: bool = False
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """The training inputs in the reference's order: ``(epoch, pts (N, 3)
    float32, valid (N,) bool, labels (N,) int32)`` for each frame of each
    epoch, frames in ``np.random.default_rng(seed).permutation`` order
    (a new permutation each epoch), frames without
    ``flow_category_indices`` skipped. ``deskew_gt`` moves each point by
    its GT motion flow over its sweep time (``flow / 0.1 * dt0``)."""
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.eval.pipeline import prepare_frame
    from himo_tpu_torch.eval.seg import remap_to_three_classes

    dataset = SceneFlowDataset(data_dir)
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        for i in rng.permutation(len(dataset)):
            data = dataset[int(i)]
            if "flow_category_indices" not in data:
                continue
            xyz = data["pc0"][:, :3].astype(np.float32)
            if deskew_gt and "flow" in data:
                frame = prepare_frame(data, _dataset_name(data_dir), res_name=None)
                xyz = xyz + (frame["gt_flow"] / 0.1) * frame["dt0"][:, None]
            pts, n = _fit(xyz, num_points)
            valid = np.zeros(num_points, bool)
            valid[:n] = True
            labels, _ = _fit(
                remap_to_three_classes(data["flow_category_indices"]).astype(np.int32),
                num_points,
            )
            yield epoch, pts, valid, labels


def train_segmentation(
    data_dir: str,
    model: Optional[SegNet] = None,
    num_points: int = 32768,
    epochs: int = 5,
    lr: float = 1e-3,
    seed: int = 0,
    verbose: bool = True,
    deskew_gt: bool = False,
    device: torch.device | str | None = None,
    **model_overrides,
) -> dict:
    """Supervised 3-class training against GT categories; returns the state
    dict (the model is trained in place). ``model`` defaults to
    :func:`make_seg_model` on ``device``; its weights are drawn anew from
    ``torch.Generator().manual_seed(seed)``. Adam at ``lr`` with optax's
    defaults (betas 0.9, 0.999; eps 1e-8).

    ``deskew_gt=True`` trains on GT-compensated (undistorted) clouds, the
    WaffleIron role: the reference's net is trained on undistorted data, so
    method-compensated inputs match its distribution while raw skewed ones
    do not."""
    if model is None:
        model, _ = make_seg_model(device=device, **model_overrides)
    dev = next(model.parameters()).device
    init_seg_params(model, torch.Generator().manual_seed(seed))
    model.train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_seg_step(model, optimizer)
    losses = {}
    for epoch, pts, valid, labels in seg_train_frames(data_dir, num_points, epochs, seed,
                                                      deskew_gt):
        loss = step(*(torch.from_numpy(a).to(dev)[None] for a in (pts, valid, labels)))
        losses.setdefault(epoch, []).append(float(loss))
    if verbose:
        for epoch in range(epochs):
            print(f"[seg] epoch {epoch}: loss {np.mean(losses.get(epoch, [])):.4f}")
    return model.state_dict()


def seg_inputs(data: dict, data_name: str, flow_mode: str, num_points: int,
               sensor_dt: float = 0.1) -> Tuple[np.ndarray, np.ndarray, int]:
    """One frame's network input as :func:`segment_dataset` makes it:
    ``(pts (num_points, 3) float32, valid (num_points,) bool, n)`` with
    ``n`` the frame's point count. ``gt`` de-skews with the GT motion flow
    (the on-distribution upper bound for ``deskew_gt``-trained nets); a
    method flow the frame lacks (each scene's last sweep has no successor)
    falls back to raw."""
    from himo_tpu_torch.eval.pipeline import prepare_frame

    res = flow_mode
    if flow_mode == "gt" or (flow_mode != "raw" and flow_mode not in data):
        res = None
    frame = prepare_frame(data, data_name, res_name=res)
    pts = frame["xyz"]
    motion = None
    if flow_mode == "gt":
        motion = frame["gt_flow"]
    elif res is not None and flow_mode != "raw":
        motion = frame["est_flow"]
    if motion is not None:
        # De-skew before segmenting: the HiMo downstream hypothesis.
        pts = pts + (motion / sensor_dt) * frame["dt0"][:, None]
    n = len(pts)
    padded = np.zeros((num_points, 3), np.float32)
    padded[: min(n, num_points)] = pts[:num_points]
    valid = np.zeros(num_points, bool)
    valid[: min(n, num_points)] = True
    return padded, valid, n


def segment_dataset(
    data_dir: str,
    model: SegNet,
    params: Optional[dict] = None,
    flow_mode: str = "raw",
    num_points: int = 32768,
    sensor_dt: float = 0.1,
    verbose: bool = True,
) -> int:
    """Run segmentation over every frame, de-skewing with ``flow_mode``
    first (:func:`seg_inputs`), with ``params`` loaded into ``model`` when
    given. Writes ``seg_{flow_mode}`` (the predicted 3-class id of each
    point as a representative AV2 category index, uint8; points past
    ``num_points`` get 0) and ``seg_valid`` (ones, uint8) into each frame
    group: the WaffleIron ``eval_h5.py`` write-back. Each scene file is
    rewritten once, after its last frame is read. Returns the frames
    written."""
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.schema import rewrite_scene

    dataset = SceneFlowDataset(data_dir, vis_name=flow_mode if flow_mode != "raw" else "")
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    dev = next(model.parameters()).device
    name = _dataset_name(data_dir)
    last = {scene: i for i, (scene, _) in enumerate(dataset.data_index)}
    pending: dict = {}
    written = 0
    for i in range(len(dataset)):
        data = dataset[i]
        pts, valid, n = seg_inputs(data, name, flow_mode, num_points, sensor_dt)
        with torch.inference_mode():
            logits = model(torch.from_numpy(pts).to(dev)[None],
                           torch.from_numpy(valid).to(dev)[None])
            pred = torch.argmax(logits[0], dim=-1).cpu().numpy()[:n]
        if n > num_points:
            pred = np.concatenate([pred, np.zeros(n - num_points, pred.dtype)])
        scene = data["scene_id"]
        pending.setdefault(scene, {})[str(data["timestamp"])] = {
            f"seg_{flow_mode}": _expand_labels(pred),
            "seg_valid": np.ones(n, np.uint8),
        }
        written += 1
        if last[scene] == i:
            rewrite_scene(Path(dataset.directory) / f"{scene}.h5", pending.pop(scene))
    if verbose:
        print(f"Segmented ({flow_mode}) {data_dir}: {written} frames")
    return written


def _expand_labels(three_class: np.ndarray) -> np.ndarray:
    """3-class ids -> representative AV2 category indices so eval_seg's
    remap recovers them (1 -> REGULAR_VEHICLE, 2 -> TRUCK)."""
    from himo_tpu_torch.core.categories import CATEGORY_TO_INDEX

    out = np.zeros(len(three_class), dtype=np.uint8)
    out[three_class == 1] = CATEGORY_TO_INDEX["REGULAR_VEHICLE"]
    out[three_class == 2] = CATEGORY_TO_INDEX["TRUCK"]
    return out


def _dataset_name(data_dir: str) -> str:
    from himo_tpu_torch.core.dataset_id import infer_dataset_name

    try:
        return infer_dataset_name(str(data_dir))
    except ValueError:
        return "av2"
