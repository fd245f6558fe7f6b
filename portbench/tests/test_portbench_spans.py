"""The readers of the program's spans (``spans.py`` and the metrics that
call it) on hand-built traces, and on a traced CPU run of a small cell,
with and without the program's spans."""

from pathlib import Path
from types import SimpleNamespace

import pytest

import harness
import spans
from conftest import run_small, small_cell

BENCH = Path(__file__).resolve().parent.parent
INFER = ["launches_per_batch.infer"] + [f"{s}_device_ms.infer" for s in (
    "pillarize", "correlation", "backbone", "instance", "decoder", "slot_pool", "refine")]
TRAIN = ["launches_per_step.train"] + [f"{s}_device_ms.train" for s in (
    "forward", "loss", "backward", "optimizer")]


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}, "tid": tid}


def kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def read(name, events, items=1, steps=1):
    ctx = {"events": events, "traced_items": items,
           "driver": SimpleNamespace(steps_per_item=steps)}
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read(ctx)


def frame_trace():
    """One batch: ``himo.frame`` over 0..100 holding ``himo.pillarize``
    (10..30) and ``himo.backbone`` (40..90); launches inside each, in the
    root alone, and outside every span."""
    return [
        span("himo.frame", 0, 100), span("himo.pillarize", 10, 20),
        span("himo.backbone", 40, 50),
        launch(5, 1), kernel(200, 3, 1),  # the root's own
        launch(12, 2), kernel(210, 4, 2),  # pillarize
        launch(15, 3, "cudaMemsetAsync"), kernel(220, 1, 3),
        launch(45, 4, "cuLaunchKernel"), kernel(230, 8, 4),  # backbone
        launch(50, 5, "cudaStreamSynchronize"),  # no launch: not counted
        launch(150, 6), kernel(300, 16, 6),  # outside every span
    ]


def test_launches_are_counted_only_inside_a_root_span():
    events = frame_trace()
    assert read("launches_per_batch.infer", events) == 4.0
    assert read("launches_per_batch.infer", events * 2, items=2) == 4.0
    # A launch outside the root, even in a span of another name, is not counted.
    events.append(span("himo.decoder", 120, 40))
    assert read("launches_per_batch.infer", events) == 4.0
    assert read("launches_per_step.train", events) is None  # another root


def test_a_device_event_goes_to_the_innermost_himo_span():
    events = frame_trace()
    assert read("pillarize_device_ms.infer", events) == pytest.approx(5e-3)
    assert read("backbone_device_ms.infer", events) == pytest.approx(8e-3)
    assert read("decoder_device_ms.infer", events) is None  # never opened
    table = spans.summarize(events, 1)["rows"]
    assert table["himo.frame"]["device_us"] == 3.0  # its own: not the stages'
    assert table["himo.frame"]["nested_us"] == 16.0
    assert table["himo.frame"]["launches"] == 1
    assert table["himo.pillarize"]["launches"] == 2


def test_a_launch_outside_every_himo_span_goes_nowhere():
    table = spans.summarize(frame_trace(), 1)["rows"]
    assert sum(row["device_us"] for row in table.values()) == 3.0 + 5.0 + 8.0
    assert sum(row["launches"] for row in table.values()) == 4


def test_an_autograd_thread_launch_inside_backward_goes_to_backward():
    events = [
        span("himo.train_step", 0, 100), span("himo.forward", 5, 20),
        span("himo.pillarize", 6, 10), span("himo.loss", 30, 10),
        span("himo.backward", 45, 40), span("himo.optimizer", 88, 10),
        launch(8, 1), kernel(200, 2, 1),  # pillarize, inside forward
        launch(20, 2), kernel(210, 3, 2),  # forward's own
        launch(35, 3), kernel(220, 5, 3),  # loss
        launch(60, 4, tid=7), kernel(230, 7, 4),  # autograd's device thread
        launch(90, 5, "cudaLaunchKernelExC"), kernel(240, 11, 5),  # optimizer
    ]
    assert read("backward_device_ms.train", events) == pytest.approx(7e-3)
    assert read("forward_device_ms.train", events) == pytest.approx(5e-3)  # own + nested
    assert read("loss_device_ms.train", events) == pytest.approx(5e-3)
    assert read("optimizer_device_ms.train", events) == pytest.approx(11e-3)
    assert read("launches_per_step.train", events) == 5.0
    # Ten steps a read: per step.
    assert read("launches_per_step.train", events, items=1, steps=10) == 0.5


def test_a_trace_without_a_root_span_gives_none_for_every_reader():
    events = [e for e in frame_trace() if e["name"] != "himo.frame"]
    events += [span("pb.item", 0, 400)]
    for name in INFER + TRAIN:
        assert read(name, events) is None, name
    assert spans.summarize([], 1) is None


def test_the_table_prints_once_a_run(capsys):
    ctx = {"events": frame_trace(), "traced_items": 1,
           "driver": SimpleNamespace(steps_per_item=1)}
    for name in INFER:
        harness.load_module(BENCH / "metrics" / f"{name}.py").read(ctx)
    err = capsys.readouterr().err
    assert err.count("[spans] himo.frame over 1 traced item(s)") == 1
    assert "himo.pillarize" in err and "host ms (profiled)" in err


@pytest.mark.parametrize("cell", ["seflowpp-512.infer-65k", "seflowpp-512.train-65k"])
def test_a_traced_cpu_run_reports_the_span_metrics(cell):
    names = INFER if "infer" in cell else TRAIN
    result = run_small(small_cell(cell), seed=2**31 + 71, seconds=0.3, trace=True)
    assert set(names) <= set(result["metrics"])
    assert result["correct"]


def test_a_program_without_spans_reports_none_of_them(monkeypatch):
    """The parent of the spans' change: the run succeeds, and its result
    line leaves the span metrics out."""
    import contextlib

    from himo_tpu_torch.models import feedforward

    monkeypatch.setattr(feedforward, "span", lambda name: contextlib.nullcontext())
    result = run_small(small_cell("seflowpp-512.infer-65k"), seed=72, seconds=0.3, trace=True)
    assert not set(INFER) & set(result["metrics"])
    assert "mfu.infer" in result["metrics"]
