"""Scene-flow bucketed metrics: EPE three-way + AccS/AccR (port of
``himo_tpu/eval/flow_metrics.py``, the same numpy).

The reference repo's local eval (eval.py:30-36) scores the
HiMo CDE/MPE instance metrics; the standard scene-flow numbers (EPE, AccS,
AccR, three-way split) live in its absent OpenSceneFlow submodule (the AV2
scene-flow-challenge definitions; the reference consumes them through
``model=seflowpp`` training logs, README.md:50-53). This module provides
them:

- three-way split per point: Foreground Dynamic / Foreground Static /
  Background Static (foreground = labeled category, dynamic = GT motion
  displacement > ``DYNAMIC_THRESHOLD`` per sweep);
- EPE = mean ||est_flow - gt_flow|| per class;
- AccS / AccR on Foreground Dynamic: fraction with error < 0.05 m (resp.
  0.1 m) or < 5% (resp. 10%) relative to the GT motion magnitude.

All flows here are MOTION flows (pose/ego component removed), matching the
challenge convention.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

DYNAMIC_THRESHOLD = 0.05  # m of GT motion per sweep


class FlowMetrics:
    """Streaming accumulator over frames."""

    CLASSES = ("FD", "FS", "BS")

    def __init__(self):
        self._err_sum = {c: 0.0 for c in self.CLASSES}
        self._count = {c: 0 for c in self.CLASSES}
        self._accs = 0
        self._accr = 0
        self._frames = 0

    def step(
        self,
        est_flow: np.ndarray,  # (N, 3) motion flow estimate
        gt_flow: np.ndarray,  # (N, 3) GT motion flow
        foreground: np.ndarray,  # (N,) bool — labeled category points
        mask: Optional[np.ndarray] = None,  # eval mask (close range, non-ground)
    ) -> None:
        if mask is None:
            mask = np.ones(len(gt_flow), bool)
        err = np.linalg.norm(est_flow - gt_flow, axis=1)
        gt_mag = np.linalg.norm(gt_flow, axis=1)
        dynamic = gt_mag > DYNAMIC_THRESHOLD
        classes = {
            "FD": mask & foreground & dynamic,
            "FS": mask & foreground & ~dynamic,
            "BS": mask & ~foreground & ~dynamic,
        }
        for c, m in classes.items():
            self._err_sum[c] += float(err[m].sum())
            self._count[c] += int(m.sum())
        fd = classes["FD"]
        if fd.any():
            rel = err[fd] / np.maximum(gt_mag[fd], 1e-9)
            self._accs += int(((err[fd] < 0.05) | (rel < 0.05)).sum())
            self._accr += int(((err[fd] < 0.10) | (rel < 0.10)).sum())
        self._frames += 1

    def summary(self) -> Dict[str, float]:
        out = {}
        present = []
        for c in self.CLASSES:
            out[f"EPE_{c}"] = self._err_sum[c] / max(self._count[c], 1)
            if self._count[c]:
                present.append(out[f"EPE_{c}"])
        # Classes with no points are EXCLUDED from the three-way mean —
        # averaging in a silent 0.0 would deflate the headline (e.g. no
        # static foreground exists on the synthetic benchmark).
        out["EPE_3way"] = float(np.mean(present)) if present else 0.0
        fd = max(self._count["FD"], 1)
        out["AccS"] = self._accs / fd
        out["AccR"] = self._accr / fd
        out["frames"] = self._frames
        return out


def evaluate_flow_metrics(
    data_dir: str,
    res_name: str,
    verbose: bool = True,
    scene_filter: str = "",
) -> Dict[str, float]:
    """EPE/Acc metrics for a stored method flow over a dataset's eval index.

    ``scene_filter`` restricts to frames whose scene id contains the
    substring (e.g. ``"scene_adv"`` scores only the adversarial tranche)."""
    from himo_tpu_torch.core.dataset_id import infer_dataset_name
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.eval.pipeline import prepare_frame

    data_name = infer_dataset_name(str(data_dir))
    dataset = SceneFlowDataset(
        data_dir, vis_name=res_name if res_name != "raw" else "", eval=True
    )
    metrics = FlowMetrics()
    for i in range(len(dataset)):
        data = dataset[i]
        if scene_filter and scene_filter not in str(data["scene_id"]):
            continue
        frame = prepare_frame(data, data_name, res_name=res_name)
        foreground = np.asarray(data["flow_category_indices"]) > 0
        metrics.step(
            frame["est_flow"], frame["gt_flow"], foreground, frame["mask_eval"]
        )
    out = metrics.summary()
    if verbose:
        print(
            f"[{res_name}] EPE 3-way {out['EPE_3way']:.4f} "
            f"(FD {out['EPE_FD']:.4f} FS {out['EPE_FS']:.4f} "
            f"BS {out['EPE_BS']:.4f})  AccS {out['AccS']:.3f} "
            f"AccR {out['AccR']:.3f}  [{out['frames']} frames]"
        )
    return out
