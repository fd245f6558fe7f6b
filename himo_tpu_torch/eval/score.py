"""Standalone leaderboard scoring: GT zip vs prediction zip (port of
``himo_tpu/eval/score.py``).

Functional equivalent of the reference's Codabench program
(tools/test/score.py:200-667). Differences from
:class:`InstanceMetrics`: inputs are compensation distances read from
feather archives (not .h5 flow fields), bucketing is velocity-only, and the
MPE is computed directly between comp_dis vectors (score.py:299-300) while
Chamfer uses the refined clouds when pc0 columns are present.

Keeps eval.py-compatible aggregation: weighted mean within each velocity
bucket per frame, nanmean across buckets, point-weighted across frames.
The table prints through :func:`~himo_tpu_torch.eval.instance_metrics.fancy_grid`
(tabulate's ``fancy_grid`` text); no progress bar is shown.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from himo_tpu_torch.core.categories import BUCKETED_METACATAGORIES, CATEGORY_TO_INDEX
from himo_tpu_torch.eval.chamfer import chamfer_distance_host, mean_point_error
from himo_tpu_torch.eval.instance_metrics import (
    RANGES,
    TARGET_CATEGORIES,
    _bucket,
    _safe_average,
    _safe_std,
    fancy_grid,
)
from himo_tpu_torch.io.submission import list_sweep_uuids, read_submission_frame


class ScoreMetrics:
    """Velocity-bucketed per-instance scoring over submission archives."""

    def __init__(self) -> None:
        self.frame_cnt = 0
        self.data: Dict[str, dict] = {
            cat: {
                "vel": {r: {"num_pts": [], "mpe": [], "cham": []} for r in RANGES},
                "mean": {
                    "num_pts": [],
                    "mpe": [],
                    "cham": [],
                    "std_mpe": [],
                    "std_cham": [],
                },
            }
            for cat in TARGET_CATEGORIES
        }

    def step(
        self,
        gt_dis: np.ndarray,
        est_dis: np.ndarray,
        eval_mask: np.ndarray,
        category: Optional[np.ndarray] = None,
        instance: Optional[np.ndarray] = None,
        gt_flow_norm: Optional[np.ndarray] = None,
        pc0: Optional[np.ndarray] = None,
        sensor_dt: float = 0.1,
        data_name: str = "av2",
    ) -> None:
        self.frame_cnt += 1
        m = eval_mask.astype(bool)
        gt_dis, est_dis = gt_dis[m], est_dis[m]
        if category is None or instance is None:
            return
        category, instance = category[m], instance[m]
        gt_flow_norm = gt_flow_norm[m] if gt_flow_norm is not None else None
        pc0 = pc0[m] if pc0 is not None else None
        min_vel = 1.5 if data_name == "scania" else 3.0

        frame = {
            cat: {r: {"num_pts": [], "mpe": [], "cham": []} for r in RANGES}
            for cat in TARGET_CATEGORIES
        }
        for cat in TARGET_CATEGORIES:
            ids = np.array([CATEGORY_TO_INDEX[c] for c in BUCKETED_METACATAGORIES[cat]])
            cls = np.isin(category, ids)
            if not np.any(cls):
                continue
            inst_cls = instance[cls]
            gt_cls, est_cls = gt_dis[cls], est_dis[cls]
            norm_cls = gt_flow_norm[cls] if gt_flow_norm is not None else None
            pc_cls = pc0[cls] if pc0 is not None else None
            for inst in np.unique(inst_cls):
                im = inst_cls == inst
                num_pts = int(np.sum(im))
                if num_pts < 10:
                    continue
                if norm_cls is not None:
                    vel = float(np.mean(norm_cls[im]) / sensor_dt)
                    if vel < min_vel:
                        continue
                else:
                    vel = min_vel + 1.0  # no norm column: skip the filter
                mpe = mean_point_error(gt_cls[im], est_cls[im])
                if pc_cls is not None:
                    cham = chamfer_distance_host(
                        pc_cls[im] + gt_cls[im], pc_cls[im] + est_cls[im]
                    )
                else:
                    cham = chamfer_distance_host(gt_cls[im], est_cls[im])
                rng = _bucket(vel)
                if rng is None:
                    continue
                frame[cat][rng]["num_pts"].append(num_pts)
                frame[cat][rng]["mpe"].append(mpe)
                frame[cat][rng]["cham"].append(cham)

        for cat in frame:
            totals, mpes, chams = [], [], []
            for rng in RANGES:
                slot = frame[cat][rng]
                if not slot["num_pts"]:
                    continue
                weights = slot["num_pts"]
                g = self.data[cat]["vel"][rng]
                g["num_pts"] += weights
                g["mpe"] += slot["mpe"]
                g["cham"] += slot["cham"]
                mpes.append(float(np.average(slot["mpe"], weights=weights)))
                chams.append(float(np.average(slot["cham"], weights=weights)))
                totals.append(int(np.sum(weights)))
            if sum(totals) == 0:
                continue
            mean = self.data[cat]["mean"]
            mean["num_pts"].append(int(sum(totals)))
            mean["mpe"].append(float(np.nanmean(mpes)))
            mean["cham"].append(float(np.nanmean(chams)))
            mean["std_mpe"].append(float(np.nanstd(mpes)))
            mean["std_cham"].append(float(np.nanstd(chams)))

    # ------------------------------------------------------------- summaries

    def compute_scores(self) -> dict:
        """Flat leaderboard keys + nested per-category detail."""
        per_cat: Dict[str, dict] = {}
        for cat in TARGET_CATEGORIES:
            mean = self.data[cat]["mean"]
            vel = self.data[cat]["vel"]
            if not mean["num_pts"]:
                per_cat[cat] = {
                    "mpe_mean": 0.0,
                    "mpe_std": 0.0,
                    "cham_mean": 0.0,
                    "cham_std": 0.0,
                    "num_pts": 0,
                    "num_objs": 0,
                    "velocity": {
                        r: {"mpe": 0.0, "cd": 0.0, "num_pts": 0, "num_obj": 0}
                        for r in RANGES
                    },
                }
                continue
            per_cat[cat] = {
                "mpe_mean": _safe_average(mean["mpe"], mean["num_pts"]),
                "mpe_std": _safe_std(mean["std_mpe"]),
                "cham_mean": _safe_average(mean["cham"], mean["num_pts"]),
                "cham_std": _safe_std(mean["std_cham"]),
                "num_pts": int(np.sum(mean["num_pts"])),
                "num_objs": len(mean["num_pts"]),
                "velocity": {
                    r: {
                        "mpe": _safe_average(vel[r]["mpe"], vel[r]["num_pts"]),
                        "cd": _safe_average(vel[r]["cham"], vel[r]["num_pts"]),
                        "num_pts": int(np.sum(vel[r]["num_pts"]))
                        if vel[r]["num_pts"]
                        else 0,
                        "num_obj": len(vel[r]["num_pts"]),
                    }
                    for r in RANGES
                },
            }

        mpes, chams, weights = [], [], []
        for cat in TARGET_CATEGORIES:
            mean = self.data[cat]["mean"]
            mpes += mean["mpe"]
            chams += mean["cham"]
            weights += mean["num_pts"]
        return {
            "mpe": _safe_average(mpes, weights),
            "chamfer": _safe_average(chams, weights),
            "num_frames": self.frame_cnt,
            "num_instances": len(weights),
            "total_points": int(np.sum(weights)) if weights else 0,
            "car_cde": per_cat["CAR"]["cham_mean"],
            "car_mpe": per_cat["CAR"]["mpe_mean"],
            "car_num_objs": per_cat["CAR"]["num_objs"],
            "car_num_pts": per_cat["CAR"]["num_pts"],
            "others_cde": per_cat["OTHER_VEHICLES"]["cham_mean"],
            "others_mpe": per_cat["OTHER_VEHICLES"]["mpe_mean"],
            "others_num_objs": per_cat["OTHER_VEHICLES"]["num_objs"],
            "others_num_pts": per_cat["OTHER_VEHICLES"]["num_pts"],
            "per_category": per_cat,
        }

    def save_detailed_json(self, data_name: str, flow_mode: str, path) -> Path:
        """res-{data}.json in eval.py's nested format (distance ranges zeroed —
        submission archives carry no ego-distance information)."""
        path = Path(path)
        data = {}
        if path.exists():
            try:
                data = json.loads(path.read_text())
            except json.JSONDecodeError:
                data = {}
        scores = self.compute_scores()["per_category"]
        for cat in TARGET_CATEGORIES:
            if not self.data[cat]["mean"]["num_pts"]:
                continue
            s = scores[cat]
            entry = {
                "overall": {
                    "mpe": s["mpe_mean"],
                    "cd": s["cham_mean"],
                    "std_mpe": s["mpe_std"],
                    "std_cd": s["cham_std"],
                    "num_pts": s["num_pts"],
                    "num_obj": s["num_objs"],
                },
                "velocity": s["velocity"],
                "distance": {
                    r: {"mpe": 0.0, "cd": 0.0, "num_pts": 0, "num_obj": 0}
                    for r in RANGES
                },
            }
            data.setdefault(data_name, {}).setdefault(flow_mode, {})[cat] = entry
        path.write_text(json.dumps(data, indent=4))
        return path


def score(
    gt_path: str,
    pred_path: str,
    output_dir: Optional[str] = None,
    flow_mode: str = "submission",
    data_name: Optional[str] = None,
) -> dict:
    """Score a prediction archive against a GT archive; print + save results."""
    # Dataset identity picks the min-velocity filter (1.5 scania / 3.0 av2);
    # refuse to guess on unrecognized archive names like the reference's
    # check_valid does (utils/__init__.py:10-11) rather than silently scoring
    # under the wrong filter. Pass data_name explicitly to override.
    if data_name is None:
        lowered = (str(gt_path) + str(pred_path)).lower()
        if "scania" in lowered:
            data_name = "scania"
        elif "av2" in lowered:
            data_name = "av2"
        else:
            raise ValueError(
                "Cannot infer dataset from archive paths "
                f"({gt_path!r}, {pred_path!r}); expected 'scania' or 'av2' in "
                "the name, or pass data_name explicitly"
            )
    if data_name not in ("scania", "av2"):
        raise ValueError(f"Unknown data_name {data_name!r}: expected scania or av2")

    gt_sweeps = list_sweep_uuids(gt_path)
    pred_sweeps = set(list_sweep_uuids(pred_path))
    metrics = ScoreMetrics()
    missing: List = []
    mismatched: List = []

    for uuid in gt_sweeps:
        if uuid not in pred_sweeps:
            missing.append(uuid)
            print(f"Warning: Missing prediction for {uuid}")
            continue
        gt = read_submission_frame(gt_path, uuid)
        pred = read_submission_frame(pred_path, uuid)
        if len(gt["comp_dis"]) != len(pred["comp_dis"]):
            mismatched.append((uuid, len(gt["comp_dis"]), len(pred["comp_dis"])))
            print(
                f"Warning: Point count mismatch for {uuid}: "
                f"GT={len(gt['comp_dis'])}, Pred={len(pred['comp_dis'])}"
            )
            continue
        metrics.step(
            gt["comp_dis"],
            pred["comp_dis"],
            gt["eval_mask"],
            category=gt.get("category"),
            instance=gt.get("instance"),
            gt_flow_norm=gt.get("gt_flow_norm"),
            pc0=gt.get("pc0"),
            data_name=data_name,
        )

    scores = metrics.compute_scores()

    print(f"\n{'=' * 50}")
    print(f"HiMo refinement metrics in {data_name}:")
    per_cat = scores["per_category"]
    rows = []
    total_pts = total_objs = 0
    for cat in TARGET_CATEGORIES:
        c = per_cat[cat]
        rows.append(
            [
                "OTHERS" if cat == "OTHER_VEHICLES" else cat,
                f"{c['cham_mean']:.3f} ± {c['cham_std']:.2f}",
                f"{c['mpe_mean']:.3f} ± {c['mpe_std']:.2f}",
                c["num_pts"],
                c["num_objs"],
            ]
        )
        total_pts += c["num_pts"]
        total_objs += c["num_objs"]
    rows.insert(
        0,
        ["Total", f"{scores['chamfer']:.3f}", f"{scores['mpe']:.3f}", total_pts, total_objs],
    )
    headers = ["Class", "CDE (Chamfer) ↓", "MPE (Point Err) ↓", "# Points", "# Objs"]
    print(fancy_grid(rows, headers))
    print(f"Total frames processed: {scores['num_frames']}")
    print(f"{'=' * 50}\n")
    if missing:
        print(f"Missing predictions for {len(missing)} sweeps. Examples:")
        print(missing[:5])
    if mismatched:
        print(
            f"Point-count mismatches for {len(mismatched)} sweeps. "
            "Examples (sweep, GT_count, Pred_count):"
        )
        print(mismatched[:5])

    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(exist_ok=True, parents=True)
        (out / "scores.json").write_text(json.dumps(scores, indent=2))
        print(f"Scores saved to {out / 'scores.json'}")
        metrics.save_detailed_json(data_name, flow_mode, out / f"res-{data_name}.json")
        print(f"Detailed results saved to {out / f'res-{data_name}.json'}")
    return scores
