"""Per-instance decomposition of the feed-forward flagship's error, through
the PyTorch port (``scripts/flagship_diagnostic.py``'s counterpart):

    python3 scripts/torch_flagship_diagnostic.py [--root $TMPDIR/av2_q18_s0] \\
        [--model seflowpp] [--min-speed 5] [--limit 0] [--device cuda]

Restores the latest checkpoint of ``{root}/runs/{model}/ckpts`` (the
layout ``scripts/torch_quality_evidence.py`` trains into) with
``training/checkpoints.CheckpointManager``, runs the network's forward
with ``with_aux=True`` on each eval frame (``--device``, default: the GPU;
raises without CUDA), and for every fast GT instance reports how much of
it the instance head covers (``aux["slot"] != -1``), how much the gate
opens (``aux["gate_logit"] > 0``), and where the error lives: the pooled
component mean against the truth (the bias of the per-object estimate)
against the per-point scatter around it. Rows by speed bucket, then the
twelve worst instances. As in the JAX script, the forward gets the
frame's clouds as ``parallel/fleet.frame_to_arrays`` ships them (pc0 not
ego-compensated) and the truth is the GT flow less the ego flow.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(tempfile.gettempdir()) / "av2_q18_s0"))
    ap.add_argument("--model", default="seflowpp")
    ap.add_argument("--min-speed", type=float, default=5.0)
    ap.add_argument("--num-points", type=int, default=20480)
    ap.add_argument("--period", type=float, default=0.1)
    ap.add_argument("--limit", type=int, default=0, help="max frames (0=all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without CUDA)")
    args = ap.parse_args(argv)

    import torch

    from himo_tpu_torch.core.transforms import rigid_flow
    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.models.feedforward import make_model
    from himo_tpu_torch.parallel.fleet import frame_to_arrays
    from himo_tpu_torch.training.checkpoints import CheckpointManager

    net, cfg = make_model(args.model, device=args.device)
    device = next(net.parameters()).device
    mgr = CheckpointManager(f"{args.root}/runs/{args.model}/ckpts", async_save=False)
    step, tree = mgr.restore_latest(map_location=str(device))
    if tree is None:
        raise FileNotFoundError(f"no checkpoint in {mgr.directory}")
    net.load_state_dict(tree["params"])
    net.eval()
    print(f"restored {args.model} step {step}")

    dataset = SceneFlowDataset(
        args.root, with_pc1=True, with_history=cfg.num_frames >= 3, eval=True
    )

    @torch.inference_mode()
    def forward(f):
        t = {k: torch.from_numpy(np.ascontiguousarray(v))[None].to(device)
             for k, v in f.items() if not isinstance(v, int)}
        sweeps = [t["pc0"], t["pc1"]]
        valids = [t["valid0"], t["valid1"]]
        if cfg.num_frames >= 3:
            sweeps.append(t["pc_hist"])
            valids.append(t["valid_hist"])
        flow, aux = net(tuple(sweeps), tuple(valids), with_aux=True)
        return flow[0].cpu().numpy(), {k: v[0].cpu().numpy() for k, v in aux.items()}

    rows = []
    n_frames = min(len(dataset), args.limit) if args.limit else len(dataset)
    for i in range(n_frames):
        data = dataset[i]
        f = frame_to_arrays(data, args.num_points, cfg.num_frames >= 3)
        flow, aux = forward(f)
        slot = aux["slot"]
        gate = aux["gate_logit"] > 0
        n = f["num_real"]
        ego = rigid_flow(
            data["pc0"][:, :3].astype(np.float32), data["pose0"], data["pose1"]
        )
        truth = (np.asarray(data["flow"])[:n, :3] - ego[:n]).astype(np.float32)
        inst = np.asarray(data["flow_instance_id"])[:n]
        for iid in np.unique(inst[inst > 0]):
            m = inst == iid
            if m.sum() < 10:
                continue
            t = truth[m].mean(0)
            speed = float(np.linalg.norm(t)) / args.period
            if speed < args.min_speed:
                continue
            fl, sl, gt_ = flow[:n][m], slot[:n][m], gate[:n][m]
            err = np.linalg.norm(fl - truth[m], axis=1)
            # Majority slot = the component the head thinks this object is.
            maj = np.bincount(sl[sl >= 0] + 1).argmax() - 1 if (sl >= 0).any() else -1
            in_maj = sl == maj if maj >= 0 else np.zeros(len(sl), bool)
            pooled_err = (
                float(np.linalg.norm(fl[in_maj & gt_].mean(0) - t))
                if (in_maj & gt_).sum() >= 3
                else np.nan
            )
            rows.append(
                dict(
                    scene=data["scene_id"], frame=i, inst=int(iid),
                    speed=speed,
                    slot_cov=float((sl >= 0).mean()),
                    gate_open=float(gt_.mean()),
                    acc_s=float((err <= np.maximum(0.05, 0.05 * np.linalg.norm(truth[m], axis=1))).mean()),
                    err_mean=float(err.mean()),
                    pooled_bias=pooled_err,
                    n_slots=int(len(np.unique(sl[sl >= 0]))),
                )
            )

    print(f"{len(rows)} fast frame-instances")
    byspeed = defaultdict(list)
    for r in rows:
        b = "05-10" if r["speed"] < 10 else ("10-20" if r["speed"] < 20 else "20+")
        byspeed[b].append(r)
    for b in sorted(byspeed):
        rs = byspeed[b]

        def agg(k):
            vals = [r[k] for r in rs if not np.isnan(r[k])]
            return float(np.mean(vals)) if vals else float("nan")
        print(
            f"{b} m/s (n={len(rs)}): slot_cov {agg('slot_cov'):.2f} "
            f"gate_open {agg('gate_open'):.2f} AccS {agg('acc_s'):.2f} "
            f"err {agg('err_mean'):.3f} pooled_bias {agg('pooled_bias'):.3f} "
            f"n_slots {agg('n_slots'):.1f}"
        )
    worst = sorted(rows, key=lambda r: -r["err_mean"])[:12]
    print("\nworst instances:")
    for r in worst:
        print(
            f"  {r['scene']} i{r['frame']} inst{r['inst']} {r['speed']:.0f} m/s "
            f"cov {r['slot_cov']:.2f} gate {r['gate_open']:.2f} "
            f"AccS {r['acc_s']:.2f} err {r['err_mean']:.2f} "
            f"bias {r['pooled_bias']:.2f} slots {r['n_slots']}"
        )
    return rows


if __name__ == "__main__":
    main()
