"""Quality evidence of the PyTorch port: the cross-method table (CDE / MPE,
EPE 3-way / FD / BS, AccS / AccR) on the bucket-complete synthetic suite,
with ``seflowpp`` self-supervised on it and the optimisation estimators
run through the registry, as ``scripts/quality_evidence.py`` computes it
for the JAX package:

    python3 scripts/torch_quality_evidence.py [--root $TMPDIR/av2_quality] \\
        [--skip-train] [--skip-opt] [--seeds 0,1,2] [--device cuda]

Steps per seed: [1/5] ``make_benchmark_dataset`` (18 scenes + 8
``scene_adv_*`` scenes x 4 frames, 16,000 background + 6 x 400 object
points a frame), [2/5] DUFO labels and ``train()`` of ``seflowpp`` (12
epochs, B8, 20,480 points, lr 6e-5 halved every 3 epochs) then
``fleet_save`` of its flow, [3/5] ``nsfp``, ``fastnsf10`` and ``icpflow``
through ``estimate_scene_flow``, [4/5] ``cli.eval`` and [5/5]
``cli.eval_flow`` on the whole suite and on its ``scene_adv`` tranche.
Flags and defaults are the JAX script's; ``--device`` (default: the GPU;
raises without CUDA) is passed to every step that takes one.

Run it from a scratch directory: like the evaluation CLIs it writes
``res-av2.json``, ``res-flow-av2.json``, their ``-scene_adv`` twins and
``res-seeded.json`` (every seed's table) into the working directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

METHODS_OPT = ("nsfp", "fastnsf10", "icpflow")

def run_one(args, root: Path, seed: int) -> dict:
    """Full pipeline on one dataset seed; returns {method: {metric: value}}.
    ``args.on_step``, where the caller sets it, is called as
    ``on_step(label, seconds)`` after each step (``chip_smoke.phase_quality``
    reads each step's launches through it)."""
    from himo_tpu_torch.data.synthetic import make_benchmark_dataset

    on_step = getattr(args, "on_step", None)

    @contextlib.contextmanager
    def _step(label: str):
        start = time.perf_counter()
        yield
        if on_step is not None:
            on_step(label, time.perf_counter() - start)

    if not root.exists():
        print(f"[1/5] building benchmark dataset at {root} (seed {seed}, "
              f"{args.bg_points} bg + 6x{args.obj_points} obj pts)")
        with _step("dataset"):
            make_benchmark_dataset(
                root,
                seed=seed,
                num_background=args.bg_points,
                points_per_object=args.obj_points,
            )
    else:
        print(f"[1/5] reusing dataset at {root}")

    from himo_tpu_torch.training.ssl_labels import write_ssl_labels_dufo

    t0 = time.time()
    methods = []
    if not args.skip_train:
        print("[2/5] DUFO SSL labels + SeFlow++ SSL training")
        if not args.skip_labels:
            with _step("labels"):
                write_ssl_labels_dufo(root, verbose=True)
        from himo_tpu_torch.training.trainer import TrainConfig, train

        train_models = [args.model]
        if args.ablate_noprior and args.model == "seflowpp":
            # The point-wise decoder's ablation row: same recipe, no
            # instance head.
            train_models.append("seflowpp_noprior")
        if args.trust and args.model == "seflowpp":
            # The offline / labelling hybrid, evaluated with causal fresh
            # priors: the on-disk ssl_prior carries the non-causal
            # scene-start backcast repair.
            train_models.append("seflowpp_trust")
        for tm in train_models:
            config = TrainConfig(
                model=tm,
                batch_size=8,
                epochs=args.epochs,
                lr=args.lr,
                step_lr_epochs=args.lr_step,
                num_points=args.num_points,
                loss_points=8192,
                log_every=10,
                val_every=3,
                seed=seed,
            )
            with _step(f"train {tm}"):
                result = train(
                    str(root), config, run_dir=str(root / f"runs/{tm}"),
                    device=args.device,
                )
            params = result["params"]
            print(f"  {tm} trained in {time.time() - t0:.0f}s; "
                  "writing flow (fleet)")
            from himo_tpu_torch.parallel.fleet import FleetConfig, fleet_save

            with _step(f"fleet {tm}"):
                fleet_save(
                    str(root),
                    model=tm,
                    params=params,
                    output_key=tm,
                    config=FleetConfig(
                        num_points=args.num_points,
                        prior_source="fresh" if tm == "seflowpp_trust" else "auto",
                    ),
                    device=args.device,
                )
            methods.append(tm)

    if not args.skip_opt:
        from himo_tpu_torch.models.runner import estimate_scene_flow

        for m in METHODS_OPT:
            print(f"[3/5] optimization method {m}")
            t1 = time.time()
            with _step(f"opt {m}"):
                estimate_scene_flow(
                    str(root),
                    model=m,
                    max_estimation_points=args.max_est_points or None,
                    device=args.device,
                )
            print(f"  {m}: {time.time() - t1:.0f}s")
            methods.append(m)

    print("[4/5] HiMo CDE/MPE eval (full + adversarial tranche)")
    from himo_tpu_torch.cli.eval import main as eval_main

    all_methods = ["raw"] + methods
    with _step("eval"):
        for m in all_methods:
            eval_main(data_dir=str(root), res_name=m)
            eval_main(data_dir=str(root), res_name=m, scene_filter="scene_adv")

    print("[5/5] EPE/Acc flow metrics (full + adversarial tranche)")
    from himo_tpu_torch.cli.eval_flow import main as eval_flow_main

    with _step("eval_flow"):
        flow_res = eval_flow_main(data_dir=str(root), res_names=all_methods)
        flow_res_adv = eval_flow_main(
            data_dir=str(root), res_names=all_methods, scene_filter="scene_adv"
        )

    def rows(himo_json: str, flow: dict, tag: str) -> dict:
        himo_res = json.loads(Path(himo_json).read_text())["av2"]
        out = {}
        for m in all_methods:
            he = himo_res.get(m, {})
            cde = mpe = float("nan")
            if he:
                cats = [
                    he[c]["overall"] for c in ("CAR", "OTHER_VEHICLES") if c in he
                ]
                pts = sum(c["num_pts"] for c in cats)
                cde = sum(c["cd"] * c["num_pts"] for c in cats) / max(pts, 1)
                mpe = sum(c["mpe"] * c["num_pts"] for c in cats) / max(pts, 1)
            fe = flow.get(m, {})
            out[m + tag] = {
                "CDE": cde,
                "MPE": mpe,
                "EPE_3way": fe.get("EPE_3way", float("nan")),
                "EPE_FD": fe.get("EPE_FD", float("nan")),
                "EPE_BS": fe.get("EPE_BS", float("nan")),
                "AccS": fe.get("AccS", float("nan")),
                "AccR": fe.get("AccR", float("nan")),
            }
        return out

    table = rows("res-av2.json", flow_res, "")
    table.update(rows("res-av2-scene_adv.json", flow_res_adv, " [adv]"))
    return table


COLS = ("CDE", "MPE", "EPE_3way", "EPE_FD", "EPE_BS", "AccS", "AccR")
ARROWS = {"AccS": "↑", "AccR": "↑"}


def print_table(tables: list) -> None:
    """Markdown table; multi-seed runs print mean±(max-min)/2 cells."""
    methods = list(tables[0].keys())
    hdr = " | ".join(f"{c} {ARROWS.get(c, '↓')}" for c in COLS)
    print(f"\n| Method | {hdr} |")
    print("|" + "---|" * (len(COLS) + 1))
    for m in methods:
        cells = []
        for c in COLS:
            vals = np.array([t[m][c] for t in tables if m in t], float)
            if len(vals) > 1:
                spread = (np.nanmax(vals) - np.nanmin(vals)) / 2
                cells.append(f"{np.nanmean(vals):.3f}±{spread:.3f}")
            else:
                cells.append(f"{vals[0]:.3f}")
        print(f"| {m} | " + " | ".join(cells) + " |")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(tempfile.gettempdir()) / "av2_quality"))
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument(
        "--ablate-noprior", action="store_true",
        help="also train/report the seflowpp_noprior (no instance head) "
        "ablation row",
    )
    ap.add_argument(
        "--trust", action="store_true",
        help="also train/report the seflowpp_trust offline hybrid row "
        "(causal fresh priors at eval)",
    )
    ap.add_argument("--skip-opt", action="store_true")
    ap.add_argument(
        "--skip-labels", action="store_true",
        help="reuse existing ssl_* keys (labels are host-side and can be "
        "written beforehand)",
    )
    ap.add_argument("--model", default="seflowpp",
                    help="feed-forward flagship to SSL-train")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lr", type=float, default=6e-5)
    ap.add_argument("--lr-step", type=int, default=3)
    ap.add_argument("--num-points", type=int, default=20480)
    ap.add_argument("--bg-points", type=int, default=16000)
    ap.add_argument("--obj-points", type=int, default=400)
    ap.add_argument(
        "--seeds", default="0",
        help="comma-separated dataset/train seeds; >1 builds one dataset "
        "per seed (root suffixed _s{seed}) and prints mean±spread cells",
    )
    # 0 = full-resolution estimation: subsampling before the host labelling
    # starves the object clusters.
    ap.add_argument("--max-est-points", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without CUDA)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    from himo_tpu_torch.models.feedforward import resolve_device

    args.device = str(resolve_device(args.device))
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]

    tables = []
    for seed in seeds:
        root = Path(args.root if len(seeds) == 1 else f"{args.root}_s{seed}")
        print(f"\n=== seed {seed} (root {root}) ===")
        tables.append(run_one(args, root, seed))
        if len(seeds) > 1:
            print_table([tables[-1]])
    print_table(tables)
    # Every seed's table: res-av2.json keeps only the last seed's.
    Path("res-seeded.json").write_text(
        json.dumps({"seeds": seeds, "tables": tables}, indent=1)
    )
    return tables


if __name__ == "__main__":
    main()
