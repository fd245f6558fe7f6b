"""``chip_smoke.py``'s phases rehearsed on the CPU at a tiny size.

The script needs a card to run; this drives its phase functions with the
CUDA-only calls stubbed (synchronize, events, memory statistics), a toy
grid and batch, and every kernel wrapper replaced by a counting call of its
plain version (the real wrappers count only kernel launches). What it
checks is the script's own logic: shapes, the kernel-vs-plain comparisons,
the launch counts each path expects, and the kernels line it prints. It
imports no JAX, like the script."""

import functools
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

TOY = {"pillar.voxel_size": (0.4, 0.4), "depths": (16, 32),
       "refine.num_query": 64, "refine.num_ref": 128}


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture()
def rehearsal(monkeypatch):
    from himo_tpu_torch.models import feedforward as pf
    from himo_tpu_torch.training import trainer as pt

    for name, value in (("BATCH", 2), ("NUM_POINTS", 2048), ("FUSED_POINTS", 256),
                        ("NN_SHAPES", ((128, 256), (256, 128))),
                        ("SEGMENT_SHAPES", ((256, 2048), (512, 256)))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    make = pf.make_model
    monkeypatch.setattr(pf, "make_model", lambda name, device=None, **kw: make(
        name, device="cpu", **{**TOY, **kw}))
    monkeypatch.setattr(pt, "TrainConfig", functools.partial(
        pt.TrainConfig, batch_size=2, num_points=2048, loss_points=256))
    for (mod, name), plain in cs._wrappers().items():
        def counted(*args, _plain=plain, _name=name, _mod=mod):
            getattr(_mod, _name).launches += 1
            return _plain(*args)

        counted.launches = 0
        monkeypatch.setattr(mod, name, counted)
    return torch.device("cpu")


def test_chip_smoke_phases_on_the_cpu(rehearsal, capsys):
    dev = rehearsal
    clouds = cs._clouds(dev)
    scatter = cs.phase_scatter(dev, clouds)
    scatter_sum = cs.phase_scatter_sum(dev, clouds)
    segment = cs.phase_segment_sum(dev)
    nn = cs.phase_nn(dev)
    fused = cs.phase_fused(dev)
    launches, run_frame, frame_ms = cs.phase_slice(dev, clouds)
    train, run_step, step_ms = cs.phase_train(dev)
    assert frame_ms > 0 and step_ms > 0
    run_frame()
    run_step()
    assert launches == dict(scatter_max_rows=3, scatter_sum_rows=0, nn_argmin_rows=10,
                            nn_min_rows=1, segment_rows_sum=0, fused_nn=0, fused_nn_idx=0)
    steps = cs.TRAIN_STEPS
    assert train == dict(scatter_max_rows=4 * steps + 4, scatter_sum_rows=steps,
                         nn_argmin_rows=0, nn_min_rows=0, segment_rows_sum=3 * steps,
                         fused_nn=1, fused_nn_idx=steps)
    entries = [scatter, scatter_sum, *segment.values(), *nn[cs.NN_SHAPES[0]].values(),
               *fused.values()]
    keys = {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}
    for e in entries:
        assert set(e) == keys and e["bound_ms"] > 0
        json.dumps(e)
    assert scatter["library_ms"] is not None and fused["idx"]["library_ms"] is None
    out = capsys.readouterr().out
    assert "step 1 terms, kernels/plain" in out and "val step" in out


def test_profile_picks_the_port_kernels_out_of_a_trace():
    """Trace names as the profiler gives them, templated and not; PyTorch's
    own kernels, in anonymous namespaces too, are left out."""
    pattern = cs.port_kernel_pattern()
    for name in ("void (anonymous namespace)::masked_min_kernel<true>(float const*, int)",
                 "void (anonymous namespace)::nn_kernel<false>(float const*)",
                 "(anonymous namespace)::scatter_sum_elem(int const*, float const*)",
                 "(anonymous namespace)::scatter_sum_warp(int const*)",
                 "(anonymous namespace)::scatter_max_rows(int const*)",
                 "(anonymous namespace)::fill_neg_inf(float*, long long)",
                 "(anonymous namespace)::finalize(float*, long long)"):
        assert pattern.match(name), name
    for name in ("void (anonymous namespace)::elementwise_kernel_with_index<int>(int)",
                 "void at::native::(anonymous namespace)::finalize(float*)"):
        assert not pattern.match(name), name


def test_busy_time_is_the_union_of_intervals():
    assert cs._busy_ms([(0, 1000), (500, 1500), (3000, 4000), (3100, 3200)]) == 2.5
    assert cs._busy_ms([]) == 0.0
