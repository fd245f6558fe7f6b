"""The ``pair`` driver of ``nsfp-cold.pair-65k`` on the CPU at a small size
(512 points, 8 Adam steps): a run and its result line, the check's
controls, the work count, and the pair's readers on hand-built traces.

The check runs under the cell's own limits. At this size on the CPU, where
the port's plain search computes ``|q|^2 + |r|^2 - 2 q.r``, the program
read at most 5.0e-5 (loss) and 3.1e-5 (change) on 32 sampled pairs, the
TF32 reference at least 3.7e-3 and 6.0e-3; at the last step, on 6 pairs,
the program at most 8.5e-5 (``final_gap``), half the rate from the third
update at least 1.7e-2."""

import contextlib
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import estimate_spans
import harness
import pair_controls
import work
from conftest import run_small
from drivers import pair_work
from reference import nsfp as ref

BENCH = Path(__file__).resolve().parent.parent
CELL = "nsfp-cold.pair-65k"
SPANS = ["launches_per_step.pair"] + [f"{s}_device_ms.pair"
                                      for s in ("mlp", "chamfer", "backward", "adam")]


def small_pair(points: int = 512, steps: int = 8, sample: int = 1):
    cell = harness.load_cell(CELL)
    cell.device = "cpu"
    cell.traffic.update(points=points, sample=sample)
    cell.config["model"]["iterations"] = steps
    return cell


def window(cell, seed: int, items: int = 2):
    from tracing import Tracer

    cell.seed = seed
    driver = harness.load_module(BENCH / "drivers" / "pair.py").setup(cell, Tracer())
    for i in range(items):
        driver.item(i)
    return driver


def failed(compared: dict) -> list:
    return [name for name, c in compared.items() if not c["value"] <= c["limit"]]


def test_a_traced_small_run_is_correct_and_reports_the_pair_metrics():
    result = run_small(small_pair(), seed=2**31 + 26, seconds=0.3, trace=True)
    assert result["correct"], result["compared"]
    assert set(SPANS) | {"mfu.pair"} <= set(result["metrics"])
    assert result["compared"]["self_gap"]["value"] == 0.0
    untraced = run_small(small_pair(), seed=26, seconds=0.3)
    assert set(untraced["metrics"]) == {"compensated_pts_per_s", "setup_s"}
    assert untraced["metrics"]["compensated_pts_per_s"]["value"] > 0


def test_the_check_fails_each_control():
    driver = window(small_pair(), 2**33 + 5)
    assert failed(driver.check()) == []
    # The reference with TF32 products in place of the program's first steps.
    assert {"loss_gap", "change_gap"} & set(failed(driver.check(control=True)))
    # One pair's flow moved 5 cm.
    i, k, flow, loss = driver.sample[0]
    driver.sample[0] = (i, k, flow + torch.tensor([0.05, 0.0, 0.0]), loss)
    moved = driver.check()
    assert moved["self_gap"]["value"] == pytest.approx(0.05, rel=1e-4)
    assert "self_gap" in failed(moved)
    # K3 sum in no fixed order (on the CPU, a fresh random order each call).
    driver = window(small_pair(), 2**33 + 5, items=0)
    with pair_controls.atomic_sum():
        for i in range(2):
            driver.item(i)
        unordered = driver.check()
    assert "self_gap" in failed(unordered)
    # Half the rate from the program's fourth update on: only the run's end
    # shows it (the last 3 of 8 steps are held to the reference).
    with pair_controls.late_rate(after=3):
        late = window(small_pair(), 2**33 + 5).check()
    assert "final_gap" in failed(late)
    assert not {"loss_gap", "change_gap", "self_gap"} & set(failed(late))


def test_a_run_with_fewer_updates_fails_final_gap():
    driver = window(small_pair(), 11)
    driver.estimate = driver.get_estimator(driver.name, device=driver.dev,
                                           **dict(driver.model_cfg, iterations=6))
    compared = driver.check()
    assert compared["final_gap"]["value"] == float("inf")


def test_a_program_without_the_spans_reports_none_of_them(monkeypatch):
    from himo_tpu_torch.models import nsfp, opt_loop

    monkeypatch.setattr(nsfp, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(opt_loop, "span", lambda name: contextlib.nullcontext())
    result = run_small(small_pair(), seed=27, seconds=0.3, trace=True)
    assert not set(SPANS) & set(result["metrics"])
    assert "mfu.pair" in result["metrics"] and result["correct"]


def test_the_work_count_equals_the_flop_counter_over_the_reference():
    """The MLP's products of one step, counted by ``FlopCounterMode`` over
    the reference's forward and backward, equal ``pair_work``'s count."""
    model = {"hidden": 128, "layers": 8, "iterations": 1}
    n = 300
    params = ref.init_mlp(torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_(True) for pair in params for t in pair]
    x = torch.randn(n, 3)
    with FlopCounterMode(display=False) as counter:
        flow = ref.mlp(list(zip(leaves[0::2], leaves[1::2])), x)
        torch.autograd.grad(flow.square().sum(), leaves)
    with FlopCounterMode(display=False) as final:
        ref.mlp(params, x)
    count = pair_work.nsfp_pair_flops(model, n)
    assert count["fp32"] == counter.get_total_flops() + final.get_total_flops()
    assert count["nn"] == 2 * 10 * n * n and count["bf16"] == 0


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}}


def kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def pair_trace():
    """One pair of two steps: ``himo.estimate`` over 0..200 with each step's
    mlp, chamfer (a ``segment_rows_sum`` call in the second step's
    backward), backward and adam."""
    events = [span("himo.estimate", 0, 200), launch(1, 100), kernel(500, 1, 100)]
    corr = 0
    for step, t in enumerate((10, 100)):
        for name, start, dur in (("himo.mlp", t, 10), ("himo.chamfer", t + 20, 10),
                                 ("himo.backward", t + 40, 20), ("himo.adam", t + 70, 10)):
            events.append(span(name, start, dur))
            corr += 1
            events += [launch(start + 1, corr), kernel(600 + 10 * corr, 2.0, corr)]
    events += [span("pb.op:segment_rows_sum#0", 145, 5), launch(146, 50),
               kernel(900, 4.0, 50), launch(147, 51, "cudaMemsetAsync"), kernel(905, 1.0, 51)]
    return events


def read(name, ctx):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read(ctx)


def test_the_pair_readers_on_a_hand_built_trace():
    calls = [("segment_rows_sum", {"shapes": [(1, 1000, 3), (1, 1000), None],
                                   "ints": [1000], "live": 1000, "reached": 600})]
    ctx = {"events": pair_trace(), "traced_items": 1, "calls": calls,
           "driver": SimpleNamespace(steps_per_item=2)}
    assert read("launches_per_step.pair", ctx) == (1 + 8 + 2) / 2
    for name in ("mlp", "chamfer", "adam"):
        assert read(f"{name}_device_ms.pair", ctx) == pytest.approx(2 * 2.0 / 2 / 1e3)
    # The K3 sum's launches, in its op range, count in the backward too.
    assert read("backward_device_ms.pair", ctx) == pytest.approx((2 * 2.0 + 5.0) / 2 / 1e3)
    least = work.call_least_seconds(*calls[0])
    want = 100.0 * least / 5e-6
    assert read("segment_sum_roofline_pct.pair", ctx) == pytest.approx(want)
    assert read("segment_sum_roofline_pct.train", ctx) == pytest.approx(want)
    # Without the root span, or without the op's launches, nothing is read.
    bare = {"events": [e for e in pair_trace() if e["name"] != "himo.estimate"],
            "traced_items": 1, "driver": ctx["driver"]}
    assert all(read(name, bare) is None for name in SPANS)
    assert estimate_spans.summarize([], 1) is None
    assert read("segment_sum_roofline_pct.pair", {**ctx, "calls": []}) is None
