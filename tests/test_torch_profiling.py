"""The port's spans (``himo_tpu_torch.utils.profiling.span``) on the CPU:
where ``frame`` and ``train_step`` open them, how they nest, that they
leave the outputs bitwise as they were, and that with no profiler
recording a span never reaches ``record_function``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from himo_tpu_torch.data.synthetic import train_batch
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.training import trainer as PT
from himo_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
TOY = {
    "pillar.voxel_size": (0.4, 0.4),
    "pillar.x_range": (-12.8, 12.8),
    "pillar.y_range": (-12.8, 12.8),
    "depths": (16, 32),
    "refine.num_query": 256,
    "refine.num_ref": 512,
}
B, N, K = 2, 1024, 256
STAGES = ("himo.pillarize", "himo.correlation", "himo.backbone", "himo.instance",
          "himo.decoder", "himo.slot_pool", "himo.refine")
STEP = ("himo.forward", "himo.loss", "himo.backward", "himo.optimizer")


def _model(seed: int = 0):
    model, _ = PF.make_model("seflowpp", device="cpu", **TOY)
    PF.init_params(model, torch.Generator().manual_seed(seed))
    return model


def _batch(seed: int = 0) -> dict:
    batch = train_batch(np.random.default_rng(seed), B, N, K)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _frame_args(batch: dict):
    dt0 = torch.rand(B, N, generator=torch.Generator().manual_seed(1)) * 0.1
    return batch["pc0"], batch["pc1"], batch["pc_hist"], batch["valid0"], dt0


def _spans(prof, tmp_path) -> list:
    """The trace's ``himo.`` ranges as (start, end, name), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat", "").lower() == "user_annotation"
                  and e["name"].startswith("himo."))


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _train_step(seed: int = 0):
    model = _model(seed)
    config = PT.TrainConfig(**dict(batch_size=B, num_points=N, loss_points=K, lr=1e-3))
    optimizer, _ = PT.make_optimizer(model.parameters(), config, 10)
    return model, PT.make_train_step(model, config, optimizer)


def test_frame_holds_each_stage_span_once_inside_one_frame_span(tmp_path):
    model = _model().eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        PF.frame(model, *_frame_args(_batch()))
    spans = _spans(prof, tmp_path)
    names = [name for _, _, name in spans]
    assert names.count("himo.frame") == 1
    root = spans[names.index("himo.frame")]
    assert sorted(names) == sorted(("himo.frame",) + STAGES)
    assert all(_inside(s, root) for s in spans)
    # The stages follow one another, in the forward's order.
    stages = [s for s in spans if s[2] != "himo.frame"]
    assert tuple(name for _, _, name in stages) == STAGES
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def test_train_step_holds_forward_loss_backward_optimizer_in_order(tmp_path):
    _, step = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_batch())
    spans = _spans(prof, tmp_path)
    names = [name for _, _, name in spans]
    assert names.count("himo.train_step") == 1
    root = spans[names.index("himo.train_step")]
    assert all(_inside(s, root) for s in spans)
    top = [s for s in spans if s[2] in STEP]
    assert tuple(name for _, _, name in top) == STEP
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    # The model's stages nest in the forward; training runs no refine head.
    forward = top[0]
    stages = [s for s in spans if s[2] not in STEP + ("himo.train_step",)]
    assert tuple(name for _, _, name in stages) == STAGES[:-1]
    assert all(_inside(s, forward) for s in stages)


def test_without_a_profiler_a_span_never_enters_record_function(monkeypatch):
    # torch's optimizers open ranges of their own, whatever the profiler.
    real = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        if name.startswith("himo."):
            raise AssertionError(f"record_function({name!r}) entered")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("himo.frame") is profiling.span("himo.backbone")
    model, step = _train_step()
    batch = _batch()
    PF.frame(model.eval(), *_frame_args(batch))
    step(batch)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="himo.frame"):
            PF.frame(model.eval(), *_frame_args(batch))


def test_frame_outputs_are_bitwise_equal_with_and_without_the_profiler():
    model = _model(3).eval()
    args = _frame_args(_batch(3))
    plain = PF.frame(model, *args)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = PF.frame(model, *args)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert plain[0].abs().sum() > 0


def test_train_step_is_bitwise_equal_with_and_without_the_profiler():
    batch = _batch(4)
    plain_model, plain_step = _train_step(4)
    traced_model, traced_step = _train_step(4)
    plain = [plain_step(batch) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [traced_step(batch) for _ in range(2)]
    for a, b in zip(plain, traced):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, p), q in zip(plain_model.named_parameters(), traced_model.parameters()):
        assert torch.equal(p, q), name


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    model = _model().eval()
    with profiling.trace(str(tmp_path)):
        PF.frame(model, *_frame_args(_batch()))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat", "").lower() == "user_annotation"}
    assert {"himo.frame", *STAGES} <= names
    with profiling.trace(None):  # no directory: nothing traced, no span opened
        assert profiling.span("himo.frame") is profiling.span("himo.refine")


def test_profiling_imports_without_starting_cuda_and_keeps_the_jax_names():
    code = (
        "import torch\n"
        "from himo_tpu_torch.utils import profiling\n"
        "assert callable(profiling.stage_timer) and callable(profiling.trace)\n"
        "assert callable(profiling.span) and callable(profiling.Timer)\n"
        "with profiling.span('himo.frame'):\n"
        "    pass\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
