"""Downstream semantic-segmentation IoU evaluation (port of
``himo_tpu/eval/seg.py``, the same numpy).

A confusion-matrix IoU evaluator plus the AV2 -> {ignore, car,
other_vehicle} 3-class remapping used to score the ``seg_*`` prediction keys
that the segmentation network writes into the .h5 scenes
(``downstream/segmentation.segment_dataset``). The confusion matrix
accumulates through one bincount. The printed block is the reference's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from himo_tpu_torch.core.categories import CAR, CATEGORY_TO_INDEX, OTHER_VEHICLES

CAR_INDICES = np.array([CATEGORY_TO_INDEX[c] for c in CAR])
OTHER_INDICES = np.array([CATEGORY_TO_INDEX[c] for c in OTHER_VEHICLES])
VEHICLE_INDICES = np.concatenate([CAR_INDICES, OTHER_INDICES])

CLASS_NAMES = {0: "ignore", 1: "car", 2: "other_vehicle"}


class IoUEvaluator:
    """Streaming confusion-matrix mIoU (rows = pred, cols = gt)."""

    def __init__(self, n_classes: int = 3, ignore: Sequence[int] = ()):
        self.n_classes = n_classes
        self.ignore = np.array(list(ignore), dtype=np.int64)
        self.include = np.array(
            [c for c in range(n_classes) if c not in self.ignore], dtype=np.int64
        )
        self.reset()

    def reset(self) -> None:
        self.confusion = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    def add_batch(self, pred: np.ndarray, target: np.ndarray) -> None:
        pred = np.asarray(pred, dtype=np.int64).reshape(-1)
        target = np.asarray(target, dtype=np.int64).reshape(-1)
        if pred.shape != target.shape:
            raise ValueError(f"shape mismatch: {pred.shape} vs {target.shape}")
        flat = pred * self.n_classes + target
        counts = np.bincount(flat, minlength=self.n_classes * self.n_classes)
        self.confusion += counts.reshape(self.n_classes, self.n_classes)

    def stats(self):
        conf = self.confusion.astype(np.float64)
        if len(self.ignore):
            conf[:, self.ignore] = 0
        tp = np.diag(conf)
        fp = conf.sum(axis=1) - tp
        fn = conf.sum(axis=0) - tp
        return tp, fp, fn

    def iou(self):
        tp, fp, fn = self.stats()
        union = tp + fp + fn + 1e-15
        per_class = tp / union
        mean = float((tp[self.include] / union[self.include]).mean())
        return mean, per_class


def remap_to_three_classes(labels: np.ndarray) -> np.ndarray:
    """AV2 category indices -> {0: ignore, 1: car, 2: other_vehicle}."""
    out = np.zeros_like(labels, dtype=np.int64)
    out[np.isin(labels, CAR_INDICES)] = 1
    out[np.isin(labels, OTHER_INDICES)] = 2
    return out


def evaluate_segmentation(
    dataset, res_names: Sequence[str], mask_only: bool = False
) -> Dict[str, dict]:
    """Score each ``seg_*`` key against GT ``flow_category_indices``.

    ``mask_only=True`` restricts scoring to points flagged by ``seg_valid``
    (the paper's "Mask only" rows); the default scores all points, as the
    reference's shipped configuration does.
    """
    evaluators = {name: IoUEvaluator(n_classes=3, ignore=[]) for name in res_names}
    for i in range(len(dataset)):
        data = dataset[i]
        if "flow_category_indices" not in data:
            print(
                f"[Warning]: No flow_category_indices in {data['scene_id']} "
                f"at {data['timestamp']}, check the data."
            )
            continue
        if mask_only and "seg_valid" in data:
            valid = np.asarray(data["seg_valid"], dtype=bool)
        else:
            valid = np.ones(len(data["flow_category_indices"]), dtype=bool)
        gt = remap_to_three_classes(np.asarray(data["flow_category_indices"])[valid])
        for name in res_names:
            if name not in data:
                print(
                    f"[Warning]: No {name} in {data['scene_id']} at "
                    f"{data['timestamp']}, check the data."
                )
                continue
            pred = remap_to_three_classes(np.asarray(data[name])[valid])
            evaluators[name].add_batch(pred, gt)

    results: Dict[str, dict] = {}
    print("\n  ========================== RESULTS ==========================  ")
    for name in res_names:
        _, per_class = evaluators[name].iou()
        m_iou = float(per_class[1:].mean())
        results[name] = {
            "miou": m_iou,
            "per_class": {CLASS_NAMES[i]: float(per_class[i]) for i in range(3)},
        }
        print(f"{name} val:\nIoU avg {m_iou * 100:.3f}")
        for i in (1, 2):
            print(f"IoU class {i} [{CLASS_NAMES[i]}] = {per_class[i] * 100:.3f}")
        print("-" * 20)
    return results
