"""Feed-forward inference cells: ``himo_tpu_torch.models.feedforward.frame``
(the network and the de-skew) on batches of sweep triplets, one batch in
flight, each uploaded from pinned host memory and its flow and de-skewed
points read back into pinned host memory.

The check runs the plain reference (``reference/seflowpp.py``) on every
batch of the pool that the seed's sample of the window's answers drew, and
counts the valid points whose flow or de-skewed point lies more than
``tolerance_m`` from the reference's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import weights as weights_mod
from reference import seflowpp as ref
from traffic.synthetic import make_item

KEYS = ("pc0", "pc1", "pc_hist", "valid", "dt0")


class Infer:
    def __init__(self, cell, tracer):
        from himo_tpu_torch.models import feedforward

        cell.extra.setdefault("marks", []).append(("the program imported", time.perf_counter()))
        self.cell, self.tracer = cell, tracer
        self.dev = torch.device(cell.device)
        model_cfg = dict(cell.config["model"])
        preset = model_cfg.pop("preset")
        self.net_config = ref.net_config(model_cfg)
        traffic = cell.traffic
        rng = np.random.default_rng(cell.seed)
        pin = self.dev.type == "cuda"
        self.pool = []
        for _ in range(traffic["pool"]):
            batch = make_item(traffic, rng)
            host = {k: torch.from_numpy(batch[k]) for k in KEYS}
            self.pool.append({k: v.pin_memory() if pin else v for k, v in host.items()})

        cell.extra.setdefault("marks", []).append(("inputs", time.perf_counter()))
        self.weights, cell.extra["reference_s"] = weights_mod.make_calibrated(
            self.net_config, cell.seed, self.dev, self.pool[0], "valid",
            cell.config["calibration"])
        cell.extra.setdefault("marks", []).append(("weights", time.perf_counter()))
        self.model, _ = feedforward.make_model(preset, device=self.dev, **model_cfg)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self.frame = feedforward.frame
        cell.extra.setdefault("marks", []).append(("model", time.perf_counter()))
        shape = tuple(self.pool[0]["pc0"].shape)
        self.out_flow = torch.empty(shape, pin_memory=pin)
        self.out_refined = torch.empty(shape, pin_memory=pin)
        self.units_per_item = int(self.pool[0]["valid"].sum())
        self.steps_per_item = 1
        self.sample_rng = np.random.default_rng([cell.seed, 1])
        self.sample, self.seen = [], 0
        self.sample_size = traffic["sample"]
        for _ in range(2):  # every shape of the window, built and warm
            self._run(0)

    def _run(self, k: int):
        host = self.pool[k]
        with self.tracer.host("upload"):
            d = {name: t.to(self.dev, non_blocking=True) for name, t in host.items()}
        with self.tracer.host("entry"):
            flow, _, refined = self.frame(self.model, d["pc0"], d["pc1"], d["pc_hist"],
                                          d["valid"], d["dt0"])
        with self.tracer.host("readback"):
            self.out_flow.copy_(flow, non_blocking=True)
            self.out_refined.copy_(refined, non_blocking=True)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        return flow, refined

    def item(self, i: int):
        k = i % len(self.pool)
        flow, refined = self._run(k)
        # A uniform sample of the window's answers (reservoir sampling). It
        # keeps the answers' device tensors, which ``frame`` makes anew on
        # every call, so drawing it copies nothing inside the window.
        slot = self.seen if self.seen < self.sample_size else int(
            self.sample_rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot < self.sample_size:
            entry = (k, flow, refined)
            if slot < len(self.sample):
                self.sample[slot] = entry
            else:
                self.sample.append(entry)

    @property
    def flops_per_item(self) -> dict:
        import work

        t = self.cell.traffic
        return work.seflowpp_infer_flops(self.cell.config["model"], t["batch"], t["points"])

    def reference(self, k: int, fp8_backbone: bool = False):
        """The reference's (flow, de-skewed points) of pool batch ``k``, on the host."""
        model = ref.SeFlowPP(self.net_config).to(self.dev)
        model.load_state_dict(self.weights)
        d = {name: t.to(self.dev) for name, t in self.pool[k].items()}
        flow, refined = ref.deskew(model, d["pc0"], d["pc1"], d["pc_hist"], d["valid"], d["dt0"],
                                   fp8_backbone=fp8_backbone)
        return flow.cpu(), refined.cpu()

    def check(self, control: bool = False) -> dict:
        """The share of the sampled answers' valid points that lie more
        than ``tolerance_m`` from the reference, in flow or in the
        de-skewed point. With ``control`` the answers are the reference's
        own, with an fp8 backbone, in place of the program's."""
        self.sample = [(k, flow.cpu(), refined.cpu()) for k, flow, refined in self.sample]
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        tol = self.cell.traffic["tolerance_m"]
        want = {k: self.reference(k) for k in sorted({k for k, _, _ in self.sample})}
        got = {k: self.reference(k, fp8_backbone=True) for k in want} if control else None
        far = total = 0
        gaps = []
        for k, flow, refined in self.sample:
            if control:
                flow, refined = got[k]
            ref_flow, ref_refined = want[k]
            gap = torch.maximum((flow - ref_flow).norm(dim=-1), (refined - ref_refined).norm(dim=-1))
            valid = self.pool[k]["valid"]
            bad = ~(gap <= tol) & valid
            far += int(bad.sum())
            total += int(valid.sum())
            gaps.append(gap[valid])
        gaps = torch.cat(gaps)
        q = torch.quantile(gaps[torch.isfinite(gaps)][:1 << 24], torch.tensor([0.5, 0.9, 0.99]))
        print(f"[{self.cell.name}] gaps to the reference over {len(self.sample)} answers "
              f"(pool items {sorted(want)}): median {q[0]:.3e} m, p90 {q[1]:.3e}, "
              f"p99 {q[2]:.3e}, max {float(gaps.max()):.3e}, non-finite "
              f"{int((~torch.isfinite(gaps)).sum())}", file=sys.stderr, flush=True)
        limit = self.cell.traffic["limits"]["far_share"]
        return {"far_share": {"value": far / max(total, 1), "limit": limit}}


def setup(cell, tracer):
    return Infer(cell, tracer)
