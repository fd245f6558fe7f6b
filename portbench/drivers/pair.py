"""Runtime-optimisation cells: one frame pair in flight through the
registry's estimator (``himo_tpu_torch.models.registry.get_estimator``:
the configuration's ``estimator`` with its ``model`` settings), then
``core.compensation``'s de-skew, as ``cli.save`` runs each pair.

An item: one pair of the pool (pc0 and pc1 of a sweep triplet, the
triplet's mask for both, pc0's ``dt0``) uploaded from pinned host memory;
the estimator's flow, its MLP drawn from a ``torch.Generator`` seeded from
(run seed, item index); the de-skew; the de-skewed points read back into
pinned host memory.

The check, once the window has closed, takes a seeded sample of the
window's pairs and, for each, holds the program to the plain reference
(``reference/nsfp.py``) over ``first_steps`` steps at each end of the run:
- ``loss_gap``, ``change_gap``: the program's first steps, run through the
  same estimator from the same generator (``iterations`` 1 to
  ``first_steps``: each call's loss is its last step's; an optimizer hook
  reads the parameters before the first update and after the last),
  against the reference's from the same MLP: the worst relative gap of a
  step's loss, and the worst gap of a leaf's norm of change over the
  steps, relative to the larger of the reference's norm for the leaf and
  the median leaf's;
- ``self_gap``: the pair again through the estimator, all its steps; the
  largest distance in m between that flow and the window's;
- ``final_gap``: in that second run an optimizer hook reads the
  parameters and Adam's state (moments, step count) before the last
  ``first_steps`` updates; the reference goes on from that state for as
  many steps. The gap is the relative one between the loss the program
  returned (its last step's, before the last update) and the reference's
  loss of that step: it holds the run's end (Adam's bias correction and
  rate hundreds of steps in) to the reference at the same point of the
  run. The leaves' change over those steps is not compared: where a run
  ends oscillating (its loss swinging a few per cent a step), the two
  sides' rounding alone moves a leaf's change by up to 0.4 % in three
  steps, with the same neighbours on both sides.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from reference import nsfp as ref
from traffic.synthetic import sweep_triplet

KEYS = ("pc0", "pc1", "valid", "dt0")


def item_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of item ``index`` of a run of ``seed`` (any whole
    numbers), as ``cli.save`` hands the estimator one."""
    state = np.random.SeedSequence([seed % 2**64, index % 2**64]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class _Steps:
    """While open, what ``torch.optim`` optimizers hold before update
    ``start`` (``first``: the parameters; ``state``: Adam's ``exp_avg``,
    ``exp_avg_sq`` and ``step``, None before the first update) and after
    update ``end`` (``last``: the parameters), and the number of updates."""

    def __init__(self, start: int, end: int):
        self.start, self.end = start, end

    def __enter__(self):
        self.first = self.state = self.last = None
        self.updates = 0

        def params(opt):
            return [p for g in opt.param_groups for p in g["params"]]

        def pre(opt, args, kwargs):
            if self.updates == self.start:
                ps = params(opt)
                self.first = [p.detach().clone() for p in ps]
                if opt.state:
                    self.state = {key: [opt.state[p][key].clone() for p in ps]
                                  for key in ("exp_avg", "exp_avg_sq")}
                    self.state["step"] = int(opt.state[ps[0]]["step"])

        def post(opt, args, kwargs):
            self.updates += 1
            if self.updates == self.end:
                self.last = [p.detach().clone() for p in params(opt)]

        from torch.optim import optimizer

        self.handles = [optimizer.register_optimizer_step_pre_hook(pre),
                        optimizer.register_optimizer_step_post_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def loss_gap(losses: list, want: list) -> float:
    """The worst relative gap of a step's loss."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, want))


def change_gap(after: list, want_after: list, before: list) -> float:
    """The worst gap of a leaf's norm of change from ``before``, relative to
    the larger of the reference's norm for the leaf and the median leaf's."""
    ch = [float((a - p0).norm()) for a, p0 in zip(after, before)]
    wch = [float((a - p0).norm()) for a, p0 in zip(want_after, before)]
    med = statistics.median(wch)
    return max(abs(a - b) / max(b, med) for a, b in zip(ch, wch))


class Pair:
    def __init__(self, cell, tracer):
        from himo_tpu_torch.core import compensation
        from himo_tpu_torch.models.registry import get_estimator

        cell.extra.setdefault("marks", []).append(("the program imported", time.perf_counter()))
        self.cell, self.tracer = cell, tracer
        self.dev = torch.device(cell.device)
        self.model_cfg = dict(cell.config["model"])
        self.name = cell.config["estimator"]
        self.get_estimator = get_estimator
        self.estimate = get_estimator(self.name, device=self.dev, **self.model_cfg)
        self.to_comp_dis, self.refine = compensation.flow_to_comp_dis, compensation.refine_points
        traffic = cell.traffic
        rng = np.random.default_rng(cell.seed)
        pin = self.dev.type == "cuda"
        self.pool = []
        for _ in range(traffic["pool"]):
            pc0, pc1, _, valid, dt0 = sweep_triplet(rng, traffic["points"], traffic["objects"],
                                                    traffic["speed_mps"],
                                                    traffic["valid_fraction"])
            host = {k: torch.from_numpy(a) for k, a in zip(KEYS, (pc0, pc1, valid, dt0))}
            self.pool.append({k: v.pin_memory() if pin else v for k, v in host.items()})
        cell.extra.setdefault("marks", []).append(("inputs", time.perf_counter()))
        self.out_refined = torch.empty(tuple(self.pool[0]["pc0"].shape), pin_memory=pin)
        self.units_per_item = int(self.pool[0]["valid"].sum())
        self.steps_per_item = self.model_cfg["iterations"]
        self.sample_rng = np.random.default_rng([cell.seed % 2**64, 1])
        self.sample, self.seen = [], 0
        self.sample_size = traffic["sample"]
        # Every shape of the window, built and warm: a pair of two steps
        # (each step launches the same kernels at the same shapes).
        self._run(0, item_generator(cell.seed, -1),
                  get_estimator(self.name, device=self.dev, **dict(self.model_cfg, iterations=2)))
        cell.extra.setdefault("marks", []).append(("warm-up pair", time.perf_counter()))

    def _run(self, k: int, generator: torch.Generator, estimate=None):
        host = self.pool[k]
        with self.tracer.host("upload"):
            d = {name: t.to(self.dev, non_blocking=True) for name, t in host.items()}
        with self.tracer.host("entry"):
            flow, loss = (estimate or self.estimate)(d["pc0"], d["pc1"], d["valid"], d["valid"],
                                                     generator)
            refined = self.refine(d["pc0"], self.to_comp_dis(flow, d["dt0"]))
        with self.tracer.host("readback"):
            self.out_refined.copy_(refined, non_blocking=True)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        return flow, loss

    def item(self, i: int):
        k = i % len(self.pool)
        flow, loss = self._run(k, item_generator(self.cell.seed, i))
        # A uniform sample of the window's answers (reservoir sampling),
        # kept as the device tensors the estimator made: nothing is copied
        # inside the window.
        slot = self.seen if self.seen < self.sample_size else int(
            self.sample_rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot < self.sample_size:
            entry = (i, k, flow, loss)
            if slot < len(self.sample):
                self.sample[slot] = entry
            else:
                self.sample.append(entry)

    @property
    def flops_per_item(self) -> dict:
        from drivers import pair_work

        return pair_work.nsfp_pair_flops(self.cell.config["model"], self.cell.traffic["points"])

    def _on_device(self, k: int) -> dict:
        return {name: t.to(self.dev) for name, t in self.pool[k].items()}

    def first_steps(self, i: int, k: int):
        """The program's losses of the first steps of item ``i``'s pair,
        and its parameters before and after them."""
        d = self._on_device(k)
        losses, n = [], self.cell.traffic["first_steps"]
        for m in range(1, n + 1):
            est = self.get_estimator(self.name, device=self.dev,
                                     **dict(self.model_cfg, iterations=m))
            with _Steps(0, m) as steps:
                _, loss = est(d["pc0"], d["pc1"], d["valid"], d["valid"],
                              item_generator(self.cell.seed, i))
            if steps.updates != m:
                raise RuntimeError(f"the estimator made {steps.updates} updates, not {m}")
            losses.append(float(loss))
        return losses, steps.first, steps.last

    def again(self, i: int, k: int):
        """Item ``i``'s pair again through the estimator: its flow and loss,
        and what the optimizer held before and after its last steps."""
        d = self._on_device(k)
        total = self.model_cfg["iterations"]
        with _Steps(max(total - self.cell.traffic["first_steps"], 0), total) as steps:
            flow, loss = self.estimate(d["pc0"], d["pc1"], d["valid"], d["valid"],
                                       item_generator(self.cell.seed, i))
        return flow, float(loss), steps

    def reference_steps(self, i: int, k: int, tf32: bool = False, start: dict | None = None):
        """The reference's losses of ``first_steps`` steps of item ``i``'s
        pair, and its parameters before and after them: from the item's
        MLP, or on from ``start``."""
        d = self._on_device(k)
        m = self.model_cfg
        r = ref.optimise(d["pc0"], d["pc1"], d["valid"], d["valid"], item_generator(self.cell.seed, i),
                         iterations=self.cell.traffic["first_steps"], hidden=m["hidden"],
                         layers=m["layers"], lr=m["lr"], max_dist=m["max_dist"], tf32=tf32,
                         start=start)
        return r["losses"], r["first"], r["last"]

    def check(self, control: bool = False) -> dict:
        """The four gaps, each the worst over the sampled pairs. With
        ``control`` the reference with its MLP products in TF32 stands in
        for the program's first and last steps."""
        limits = self.cell.traffic["limits"]
        names = ("loss_gap", "change_gap", "self_gap", "final_gap")
        gaps = dict.fromkeys(names, 0.0)
        for i, k, flow, loss in self.sample:
            want_losses, init, want_after = self.reference_steps(i, k)
            if control:
                losses, _, after = self.reference_steps(i, k, tf32=True)
            else:
                losses, first, after = self.first_steps(i, k)
                if any(not torch.equal(a, b.to(a.device)) for a, b in zip(first, init)):
                    raise RuntimeError("the program and the reference start from other weights")
            got = {"loss_gap": loss_gap(losses, want_losses),
                   "change_gap": change_gap(after, want_after, init)}

            again, again_loss, end = self.again(i, k)
            got["self_gap"] = float((again - flow).norm(dim=-1).max())
            want_end = [float("nan")]
            if end.last is None or end.state is None:  # fewer updates than the configuration's
                got["final_gap"] = float("inf")
            else:
                start = {"params": end.first, **end.state}
                want_end, _, _ = self.reference_steps(i, k, start=start)
                end_losses = (self.reference_steps(i, k, tf32=True, start=start)[0] if control
                              else [again_loss])
                got["final_gap"] = loss_gap(end_losses[-1:], want_end[-1:])
            print(f"[{self.cell.name}] item {i} (pool {k}): losses {losses} against "
                  f"{want_losses}; last step's loss {again_loss:.6g} against "
                  f"{want_end[-1]:.6g}; gaps "
                  + " ".join(f"{name} {got[name]:.3e}" for name in names),
                  file=sys.stderr, flush=True)
            for name in names:
                v = got[name]
                gaps[name] = max(gaps[name], v) if np.isfinite(v) else float("inf")
        return {name: {"value": v, "limit": limits[name]} for name, v in gaps.items()}


def setup(cell, tracer):
    return Pair(cell, tracer)
