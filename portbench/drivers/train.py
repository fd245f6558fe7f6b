"""SSL training cells: ``himo_tpu_torch.training.trainer.make_train_step``
on SSL train batches uploaded from pinned host memory, the loss read
every ``read_every`` steps (as the trainer's ``log_every`` reads it), the
window ending on a read.

Set-up builds the one train step with its model and optimizer and drives
it through its first three steps, on three different batches of the pool,
through the same upload and call as the window. The check, once the
window has closed, runs the reference's step (``reference/train.py``)
from the same initial weights over the same three batches and compares:
each step's loss, each leaf's gradient norm at step 1 as the optimizer got
it (read from Adam's first moment after that step), and each leaf's norm
of the parameters' change over the three steps.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

import weights as weights_mod
from reference import seflowpp as ref
from reference import train as ref_train
from traffic.synthetic import make_item

FIRST_STEPS = 3
BETA1 = 0.9


class Train:
    def __init__(self, cell, tracer):
        from himo_tpu_torch.models import feedforward
        from himo_tpu_torch.training import trainer

        cell.extra.setdefault("marks", []).append(("the program imported", time.perf_counter()))
        self.cell, self.tracer = cell, tracer
        self.dev = torch.device(cell.device)
        model_cfg = dict(cell.config["model"])
        preset = model_cfg.pop("preset")
        self.net_config = ref.net_config(model_cfg)
        self.train_cfg = dict(cell.config["train"])
        traffic = cell.traffic
        rng = np.random.default_rng(cell.seed)
        pin = self.dev.type == "cuda"
        self.pool = []
        for _ in range(traffic["pool"]):
            batch = {k: torch.from_numpy(v) for k, v in make_item(traffic, rng).items()}
            self.pool.append({k: v.pin_memory() if pin else v for k, v in batch.items()})

        cell.extra.setdefault("marks", []).append(("inputs", time.perf_counter()))
        self.weights, cell.extra["reference_s"] = weights_mod.make_calibrated(
            self.net_config, cell.seed, self.dev, self.pool[0], "valid0",
            cell.config["calibration"])
        cell.extra.setdefault("marks", []).append(("weights", time.perf_counter()))
        self.model, _ = feedforward.make_model(preset, device=self.dev, **model_cfg)
        self.model.load_state_dict(self.weights)
        self.model.train()
        config = trainer.TrainConfig(**{k: v for k, v in self.train_cfg.items()
                                        if k != "steps_per_epoch"})
        self.optimizer, _ = trainer.make_optimizer(self.model.parameters(), config,
                                                   self.train_cfg["steps_per_epoch"])
        self.step = trainer.make_train_step(self.model, config, self.optimizer)
        cell.extra.setdefault("marks", []).append(("model", time.perf_counter()))
        self.read_every = traffic["read_every"]
        self.steps_per_item = self.read_every
        self.units_per_item = traffic["batch"] * traffic["points"] * self.read_every
        self.steps_done = 0

        # The first steps, through the window's own feed and call.
        self.first_losses = []
        for s in range(FIRST_STEPS):
            metrics = self._step()
            self.first_losses.append(float(metrics["total"]))
            if s == 0:
                state = self.optimizer.adam.state
                self.first_grads = [state[p]["exp_avg"].detach().clone() / (1.0 - BETA1)
                                    if p in state else torch.zeros_like(p)
                                    for p in self.optimizer.params]
        self.after_first = [p.detach().clone() for p in self.optimizer.params]
        self.losses_read = []

    def _step(self):
        host = self.pool[self.steps_done % len(self.pool)]
        with self.tracer.host("upload"):
            batch = {k: v.to(self.dev, non_blocking=True) for k, v in host.items()}
        with self.tracer.host("entry"):
            metrics = self.step(batch)
        self.steps_done += 1
        return metrics

    def item(self, i: int):
        for _ in range(self.read_every):
            metrics = self._step()
        with self.tracer.host("readback"):
            self.losses_read.append(float(metrics["total"]))

    @property
    def flops_per_item(self) -> dict:
        import work

        t = self.cell.traffic
        one = work.seflowpp_train_flops(self.cell.config["model"], t["batch"], t["points"],
                                        t["loss_points"])
        return {k: v * self.read_every for k, v in one.items()}

    def reference(self, fp8_backbone: bool = False):
        """The reference's losses of the first steps, step 1's gradient
        per leaf and the parameters after the first steps."""
        model = ref.SeFlowPP(self.net_config).to(self.dev)
        model.load_state_dict(self.weights)
        step = ref_train.Step(model, self.train_cfg, fp8_backbone=fp8_backbone)
        losses = []
        for s in range(FIRST_STEPS):
            batch = {k: v.to(self.dev) for k, v in self.pool[s % len(self.pool)].items()}
            losses.append(float(step(batch)["total"]))
            if s == 0:
                grads = [p.grad.detach().clone() for p in step.params]
        return losses, grads, [p.detach().clone() for p in step.params]

    def check(self, control: bool = False) -> dict:
        """Gaps to the reference, each relative and the worst over steps or
        leaves: ``loss_gap`` of the first steps' losses, ``grad_gap`` of
        step 1's gradient norm per leaf, ``change_gap`` of the norm of each
        leaf's change over the first steps (leaves whose reference gradient
        is under a thousandth of the median leaf's left out). A leaf's gap
        is taken against the larger of its own reference norm and the
        median leaf's. With ``control`` the reference with an fp8
        backbone stands in for the program."""
        losses, grads, after = self.first_losses, self.first_grads, self.after_first
        init = [self.weights[name] for name in self._param_names()]
        del self.model, self.optimizer, self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        want_losses, want_grads, want_after = self.reference()
        if control:
            losses, grads, after = self.reference(fp8_backbone=True)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        gn = [float(g.norm()) for g in grads]
        wgn = [float(g.norm()) for g in want_grads]
        gmed = statistics.median(wgn)
        grad_gap = max(abs(a - b) / max(b, gmed) for a, b in zip(gn, wgn))
        ch = [float((a - p0).norm()) for a, p0 in zip(after, init)]
        wch = [float((a - p0).norm()) for a, p0 in zip(want_after, init)]
        kept = [i for i, w in enumerate(wgn) if w >= 1e-3 * gmed]
        cmed = statistics.median(wch[i] for i in kept)
        change_gap = max(abs(ch[i] - wch[i]) / max(wch[i], cmed) for i in kept)
        names = self._param_names()
        worst_grad = max(range(len(gn)), key=lambda i: abs(gn[i] - wgn[i]) / max(wgn[i], gmed))
        worst_change = max(kept, key=lambda i: abs(ch[i] - wch[i]) / max(wch[i], cmed))
        print(f"[{self.cell.name}] losses {losses} against {want_losses}; worst leaves: "
              f"gradient {names[worst_grad]}, change {names[worst_change]}; "
              f"{len(names) - len(kept)} of {len(names)} leaves left out of the change",
              file=sys.stderr, flush=True)
        if not all(np.isfinite(self.losses_read)):
            loss_gap = float("inf")
        limits = self.cell.traffic["limits"]
        return {"loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
                "grad_gap": {"value": grad_gap, "limit": limits["grad_gap"]},
                "change_gap": {"value": change_gap, "limit": limits["change_gap"]}}

    def _param_names(self):
        """The parameters' names in the order the optimizers hold them."""
        with torch.device("meta"):
            return [n for n, _ in ref.SeFlowPP(self.net_config).named_parameters()]


def setup(cell, tracer):
    return Train(cell, tracer)
