"""The comparison that decides ``correct`` fails what it must: the
control (the reference one precision below the configuration's) and the
faults the timed path can have, planted under a run of the harness that
skips only its look for a chip."""

import pytest
import torch

from conftest import run_small, small_cell


def _readings(name: str, seed: int, control: bool, items: int = 2) -> float:
    import harness
    from tracing import Tracer

    cell = small_cell(name)
    cell.seed = seed
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.traffic['kind']}.py").setup(
        cell, Tracer())
    for i in range(items):
        driver.item(i)
    compared = driver.check(control=control)
    return compared["far_share"]["value"], compared["far_share"]["limit"]


@pytest.mark.parametrize("seed", [21, 22, 2**31 + 23])
def test_the_fp8_control_fails_and_the_program_passes(seed):
    value, limit = _readings("seflowpp-512.infer-65k", seed, control=False)
    assert value <= limit
    value, limit = _readings("seflowpp-512.infer-65k", seed, control=True)
    assert value > limit


@pytest.mark.parametrize("seed", [24, 25, 2**31 + 26])
def test_the_fp8_control_fails_a_train_number_and_the_program_passes(seed):
    import harness
    from tracing import Tracer

    kind = harness.HERE / "drivers" / "train.py"
    for control in (False, True):
        cell = small_cell("seflowpp-512.train-65k")
        cell.seed = seed
        driver = harness.load_module(kind).setup(cell, Tracer())
        driver.item(0)
        compared = driver.check(control=control)
        failed = [k for k, c in compared.items() if c["value"] > c["limit"]]
        assert bool(failed) == control, compared


def _unchanged_state(monkeypatch):
    from himo_tpu_torch.training import trainer

    monkeypatch.setattr(trainer.ClippedAdam, "step", lambda self: None)


def _half_train_batch(monkeypatch):
    from himo_tpu_torch.training import trainer

    real = trainer.mean_losses

    def half(model, config, batch):
        rows = batch["pc0"].shape[0] // 2
        return real(model, config, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(trainer, "mean_losses", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_train_batch])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run_small(small_cell("seflowpp-512.train-65k"), seed=43, seconds=0.5)
    assert result["correct"] is False


def _altered_frame(monkeypatch):
    from himo_tpu_torch.models import feedforward

    real = feedforward.frame

    def frame(*args, **kwargs):
        flow, comp, refined = real(*args, **kwargs)
        refined = refined.clone()
        refined[0] += 0.05  # the answer of one frame altered
        return flow, comp, refined

    monkeypatch.setattr(feedforward, "frame", frame)


def _half_batch(monkeypatch):
    from himo_tpu_torch.models import feedforward

    real = feedforward.frame

    def frame(model, pc0, pc1, pc_hist, valid, dt0, prior=None):
        half = pc0.shape[0] // 2
        flow, comp, refined = real(model, pc0[:half], pc1[:half], pc_hist[:half],
                                   valid[:half], dt0[:half])
        pad = torch.zeros_like(pc0[half:])
        return (torch.cat([flow, pad]), torch.cat([comp, pad]),
                torch.cat([refined, pc0[half:]]))

    monkeypatch.setattr(feedforward, "frame", frame)


@pytest.mark.parametrize("fault", [_altered_frame, _half_batch])
def test_a_broken_inference_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run_small(small_cell("seflowpp-512.infer-65k"), seed=41)
    assert result["correct"] is False
