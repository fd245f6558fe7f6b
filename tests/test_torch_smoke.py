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

import himo_tpu_torch.cli.train  # noqa: E402,F401 - bound to TrainConfig before the rehearsal

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
    from himo_tpu_torch.ops import voxelize as pv
    from himo_tpu_torch.ops.dt import DTConfig
    from himo_tpu_torch.training import trainer as pt

    # Route thresholds shrunk with the shapes: the main paths' toy 256x256
    # grid at 2,048 points takes the table route (as 512x512 at 65,536),
    # path A's 128x128 grid the resident route, path B's 4,096 points the
    # stream route; 3 x 2,048 points do not fuse.
    monkeypatch.setattr(pv, "_RESIDENT_BYTES", 16 * 1024 * 1024)
    monkeypatch.setattr(pv, "_TABLE_BYTES", 1536 * 1024)
    for name, value in (("BATCH", 2), ("NUM_POINTS", 2048), ("FUSED_POINTS", 256),
                        ("GRID_256", {"pillar.voxel_size": (0.8, 0.8)}),
                        ("BIG_POINTS", 4096),
                        ("NN_SHAPES", ((128, 256), (256, 128))),
                        ("NN_NSFP_SHAPE", (1, 512, 512)),
                        ("SEGMENT_SHAPES", ((256, 2048), (512, 256))),
                        ("NSFP_POINTS", 512), ("NSFP_ITERS", 6), ("NSFP_PROFILE_ITERS", 2),
                        ("KNN_DUPLICATES", 16), ("HOST_POINTS", 64), ("HOST_ROWS", 128),
                        ("FASTNSF_DT", DTConfig(voxel_size=(3.2, 3.2, 1.6)))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    # No device to trace or to queue launches on: one timed call stands in.
    monkeypatch.setattr(cs, "device_ms", lambda fn, iters=20: cs.cuda_ms(fn, 1, 0))
    monkeypatch.setattr(cs, "device_split",
                        lambda fn, iters=20: {"kernel": cs.cuda_ms(fn, 1, 0)})
    monkeypatch.setattr(cs, "host_us", lambda fn: cs.cuda_ms(fn, 1, 0) * 1e3)
    make = pf.make_model
    monkeypatch.setattr(pf, "make_model", lambda name, device=None, **kw: make(
        name, device="cpu", **{**TOY, **kw}))
    monkeypatch.setattr(pt, "TrainConfig", functools.partial(
        pt.TrainConfig, batch_size=2, num_points=2048, loss_points=256))
    monkeypatch.setattr(pv, "_run_max_kernel", lambda p, f, rows, flagged=None:
                        pv._scatter_max_rows_plain(p, f, rows))
    for (mod, name), plain in cs._wrappers().items():
        def counted(*args, _plain=plain, _name=name, _mod=mod):
            fn = getattr(_mod, _name)
            fn.launches += 1
            if _name == "sorted_segment_sum":  # K10 also counts by width
                c = args[1].shape[-1]
                fn.launches_by_c[c] = fn.launches_by_c.get(c, 0) + 1
            return _plain(*args)

        counted.launches = 0
        counted.launches_by_c = {}
        monkeypatch.setattr(mod, name, counted)
    return torch.device("cpu")


def test_chip_smoke_phases_on_the_cpu(rehearsal, capsys):
    dev = rehearsal
    clouds = cs._clouds(dev)
    big = cs._clouds(dev, cs.BIG_POINTS)
    scatter = cs.phase_scatter(dev, clouds)
    resident = cs.phase_scatter_resident(dev, clouds)
    scatter_sum = cs.phase_scatter_sum(dev, clouds)
    gather = cs.phase_gather(dev, clouds)
    sorted_max, sorted_sum = cs.phase_sorted(dev, big)
    segment_sum_k10, segment_sum_k10_step = cs.phase_sorted_sum(dev, clouds)
    segment_gather_k11, sorted_gather_k5 = cs.phase_sorted_gathers(dev, clouds, big)
    segment = cs.phase_segment_sum(dev)
    nn = cs.phase_nn(dev)
    fused = cs.phase_fused(dev)
    cs.phase_nn_grid(dev)
    launches, run_frame, frame_ms = cs.phase_slice(dev, clouds)
    launches_256, _, _ = cs.phase_slice(dev, clouds, name="inference_256",
                                        expected=cs.INFER_256_LAUNCHES, **cs.GRID_256)
    launches_big, _, _ = cs.phase_slice(dev, big, name="inference_big",
                                        expected=cs.INFER_BIG_LAUNCHES)
    launches_sorted, _, _ = cs.phase_slice(dev, clouds, name="inference_mean_sorted",
                                           expected=cs.INFER_SORTED_LAUNCHES,
                                           pooling="mean_sorted")
    train, run_step, step_ms = cs.phase_train(dev)
    train_256 = cs.phase_train(dev, name="train_256", steps=cs.ROUTE_TRAIN_STEPS,
                               expected=cs.TRAIN_256_LAUNCHES, val=False, **cs.GRID_256)[0]
    train_big = cs.phase_train(dev, name="train_big", steps=cs.ROUTE_TRAIN_STEPS,
                               expected=cs.TRAIN_BIG_LAUNCHES, val=False,
                               num_points=cs.BIG_POINTS)[0]
    train_sorted = cs.phase_train(dev, name="train_mean_sorted", steps=cs.ROUTE_TRAIN_STEPS,
                                  expected=cs.TRAIN_SORTED_LAUNCHES, val=False,
                                  pooling="mean_sorted")[0]
    pair = cs._nsfp_pair(dev)
    knn = cs.phase_knn(dev, pair)
    nsfp, run_nsfp, nsfp_ms = cs.phase_nsfp(dev, pair)
    run_fastnsf, fastnsf_ms = cs.phase_fastnsf(dev, pair)
    assert frame_ms > 0 and step_ms > 0 and nsfp_ms > 0 and fastnsf_ms > 0
    run_frame()
    run_step()
    flow, loss = run_nsfp()
    assert flow.shape == (512, 3)
    none = dict.fromkeys(("scatter_max_rows", "scatter_max_resident_rows",
                          "scatter_sum_rows", "sorted_scatter_max_rows",
                          "sorted_scatter_sum_rows", "gather_rows", "nn_argmin_rows",
                          "nn_min_rows", "segment_rows_sum", "fused_nn", "fused_nn_idx",
                          "knn_rows", "sorted_segment_sum", "sorted_segment_gather",
                          "sorted_gather_rows", cs.K10_STEP), 0)
    assert launches == {**none, "scatter_max_rows": 3, "nn_argmin_rows": 10,
                        "nn_min_rows": 1}
    assert launches_256 == {**none, "scatter_max_resident_rows": 3, "gather_rows": 1,
                            "nn_argmin_rows": 10, "nn_min_rows": 1}
    assert launches_big == {**none, "sorted_scatter_max_rows": 3, "nn_argmin_rows": 10,
                            "nn_min_rows": 1}
    assert launches_sorted == {**none, "sorted_segment_sum": 3, "sorted_segment_gather": 1,
                               "nn_argmin_rows": 10, "nn_min_rows": 1}
    steps = cs.TRAIN_STEPS
    assert train == {**none, "scatter_max_rows": 4 * steps + 4, "scatter_sum_rows": steps,
                     "segment_rows_sum": 3 * steps, "fused_nn": 1, "fused_nn_idx": steps,
                     "sorted_gather_rows": 3 * steps}
    steps = cs.ROUTE_TRAIN_STEPS
    assert train_256 == {**none, "scatter_max_resident_rows": 4 * steps,
                         "gather_rows": steps, "segment_rows_sum": 4 * steps,
                         "fused_nn_idx": steps}
    assert train_big == {**none, "sorted_scatter_max_rows": 4 * steps,
                         "sorted_scatter_sum_rows": steps, "segment_rows_sum": 3 * steps,
                         "fused_nn_idx": steps, "sorted_gather_rows": 3 * steps}
    assert train_sorted == {**none, "scatter_max_rows": steps, "sorted_segment_sum": 3 * steps,
                            cs.K10_STEP: steps, "sorted_segment_gather": 4 * steps,
                            "segment_rows_sum": 4 * steps, "fused_nn_idx": steps}
    iters = cs.NSFP_ITERS  # knn_k 0, then 4
    assert nsfp == {**none, "nn_argmin_rows": 2 * iters * 2, "segment_rows_sum": iters * 2,
                    "knn_rows": 2 * iters}
    entries = [scatter, resident, scatter_sum, gather, sorted_max, sorted_sum,
               *segment.values(), *nn[cs.NN_SHAPES[0]].values(), *fused.values(), knn,
               segment_sum_k10, segment_sum_k10_step, segment_gather_k11, sorted_gather_k5]
    keys = {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_ms", "library_device_ms"}
    for e in entries:
        assert set(e) == keys and e["bound_ms"] > 0 and e["device_ms"] > 0
        assert (e["library_ms"] is None) == (e["library_device_ms"] is None)
        json.dumps(e)
    assert scatter["library_ms"] is not None and fused["idx"]["library_ms"] is None
    assert all(e["library_device_ms"] > 0 for e in segment.values())
    assert gather["bound_by"] == "bytes" and sorted_sum["library_ms"] is not None
    assert knn["library_ms"] is None and knn["bound_by"] == "operations"
    assert segment_gather_k11["bound_by"] == sorted_gather_k5["bound_by"] == "bytes"
    assert segment_sum_k10["library_ms"] is not None
    assert segment_sum_k10_step["library_ms"] is not None
    assert segment_sum_k10_step["bound_ms"] > segment_sum_k10["bound_ms"]
    out = capsys.readouterr().out
    assert "step 1 terms, kernels/plain" in out and "val step" in out
    assert "bitwise equal from launch to launch" in out and "at equal work" in out
    assert "[inference_256] forward + de-skew" in out and "[train_big] step 2" in out
    assert "[inference_mean_sorted] forward + de-skew" in out
    assert "[train_mean_sorted] step 2" in out and "sorted_segment_sum C=33 bf16=1" in out
    assert "sorted_segment_sum C=65 bf16=1: bitwise equal from launch to launch" in out
    assert out.count("sorted stream B=") == 2  # path B's and mean_sorted's runs
    assert "stable argsort" in out
    assert "signed features" in out and "kernel's device ms by pass" in out
    assert "scatter_max_resident_rows C=32 flag-free decode: bitwise equal" in out
    assert "scatter_max_rows C=1 flagged decode: bitwise equal" in out
    assert "gather_rows at the unclamped ids" in out
    assert f"C={cs.MEAN_CHANNELS}" in out and "zeros + index_add_" in out
    host = cs.wrapper_host_us(dev)
    assert set(host) == set(none) - {cs.K10_STEP} and all(v > 0 for v in host.values())
    assert "nsfp knn_k=4 step 1, kernels vs plain" in out and "distance-field build" in out


def test_prior_paths_on_the_cpu(rehearsal, monkeypatch, capsys):
    """The host cluster prior's paths at a toy size: K7 at a toy ICP shape,
    ``nsfp`` and ``fastnsf`` at their defaults, ``icpflow`` and
    ``seflowpp_trust`` (forward and two train steps), on 4,096-point
    pairs (16 object clusters of about 25 points each, so the clustering
    finds objects)."""
    dev = rehearsal
    monkeypatch.setattr(cs, "ICP_SHAPE", (4, 64, 512))
    monkeypatch.setattr(cs, "NSFP_POINTS", 4096)
    icp = cs.phase_nn_icp(dev)
    assert icp["bound_by"] == "operations" and icp["bound_ms"] > 0 and icp["device_ms"] > 0
    pair = cs._nsfp_pair(dev)
    none = dict.fromkeys(cs.read_counts(), 0)
    prior = cs.phase_opt_prior(dev, pair, {"nsfp": 1.0, "fastnsf": 1.0})
    assert prior == {**none, "nn_argmin_rows": 2 * cs.NSFP_ITERS,
                     "segment_rows_sum": cs.NSFP_ITERS}
    assert cs.phase_icpflow(dev, pair) == {**none, "nn_argmin_rows": cs.ICP_ITERS}
    launches, train, run_frame, frame_ms = cs.phase_trust(dev)
    assert launches == {**none, "scatter_max_rows": 3, "nn_argmin_rows": 10,
                        "nn_min_rows": 1}
    steps = cs.ROUTE_TRAIN_STEPS
    assert train == {**none, "scatter_max_rows": 4 * steps, "scatter_sum_rows": steps,
                     "segment_rows_sum": 3 * steps, "fused_nn_idx": steps,
                     "sorted_gather_rows": 3 * steps}
    run_frame()
    assert frame_ms > 0
    out = capsys.readouterr().out
    assert "cluster_prior_flow (NSFPConfig defaults)" in out and "(cold start 1.0000 m)" in out
    assert "icpflow registration, kernels vs plain: 1.000000 of filled slots" in out
    assert "[inference_trust] host prior of 2 frames" in out
    assert "[inference_trust] kernels vs plain on the card" in out
    assert "[train_trust] step 2" in out and "nn icp B=4 64x512" in out


def test_train_loop_phase_on_the_cpu(rehearsal, monkeypatch, capsys):
    """``phase_train_loop`` at a toy size: 2 scenes x 5 frames of 2,000
    points, batch 2, so 4 steps an epoch; the trace is the CPU's (the
    epoch ranges, no device events)."""
    from torch.profiler import ProfilerActivity, profile

    from himo_tpu_torch.models import feedforward as pf
    from himo_tpu_torch.training import trainer as pt

    monkeypatch.setattr(pt, "make_model", pf.make_model)  # the rehearsal's toy model
    for name, value in (("LOOP_SCENES", 2), ("LOOP_FRAMES", 5), ("LOOP_BACKGROUND", 1200),
                        ("LOOP_ISOLATED_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)

    def cpu_traced(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
        return out, cs._trace_events(prof)

    monkeypatch.setattr(cs, "traced", cpu_traced)
    launches = cs.phase_train_loop(rehearsal, "Card, 700.00 W")
    steps, val_steps = 2 * 4, 2 * 1
    want = dict.fromkeys(launches, 0)
    want.update(scatter_max_rows=4 * steps + 4 * val_steps, scatter_sum_rows=steps,
                fused_nn_idx=steps, segment_rows_sum=3 * steps, sorted_gather_rows=3 * steps,
                fused_nn=val_steps)
    assert launches == want
    assert pt.batch_iterator.__name__ == "batch_iterator"  # the wrappers are gone
    assert pt.make_train_step.__name__ == "make_train_step"
    out = capsys.readouterr().out
    assert "[train_loop] 10 frames of 2,000 points in 2 scenes" in out
    assert "[train_loop] Card, 700.00 W: host" in out and "ms per batch of 2 frames" in out
    assert "vs the same step alone" in out and "busy share 0.0000" in out
    assert "resumed from step 4 (epoch 1)" in out


def test_window_busy_clips_device_time_to_the_ranges():
    def ev(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [ev(cs.LOOP_LABEL, "user_annotation", 100, 100),
              ev(cs.LOOP_LABEL, "user_annotation", 1000, 1000),
              ev("other", "user_annotation", 0, 5000),
              ev("k", "kernel", 50, 100), ev("k", "kernel", 120, 20),
              ev("m", "gpu_memset", 1500, 1000), ev("k", "kernel", 300, 500),
              ev("launch", "cuda_runtime", 150, 10)]
    busy, wall = cs.window_busy(events, cs.LOOP_LABEL)
    assert (busy, wall) == (0.05 + 0.5, 1.1)
    with pytest.raises(AssertionError, match="no 'x' range"):
        cs.window_busy(events, "x")


def test_profile_picks_the_port_kernels_out_of_a_trace():
    """Trace names as the profiler gives them, templated and not; PyTorch's
    own kernels, in anonymous namespaces too, are left out."""
    pattern = cs.port_kernel_pattern()
    for name in ("void (anonymous namespace)::fused_kernel<true>(float const*, int)",
                 "void (anonymous namespace)::finalize_kernel<false>(float const*)",
                 "(anonymous namespace)::nn_min_kernel(float const*, int)",
                 "(anonymous namespace)::nn_argmin_kernel(float const*, int)",
                 "void (anonymous namespace)::scatter_sum_elem<int>(int const*, float const*)",
                 "void (anonymous namespace)::gather_tile<int, true>(int const*, float const*)",
                 "(anonymous namespace)::gather_runs(int const*, int const*)",
                 "(anonymous namespace)::scatter_sum_warp(int const*)",
                 "(anonymous namespace)::scatter_max_rows(int const*)",
                 "void (anonymous namespace)::decode_reached<uint4>(unsigned char const*, "
                 "uint4*, long long, int)",
                 "void (anonymous namespace)::decode_reached<unsigned int>(unsigned char "
                 "const*, unsigned int*, long long, int)",
                 "void (anonymous namespace)::decode_all<uint4>(uint4*, long long)",
                 "void (anonymous namespace)::gather_tile<int, false, true>(int const*)",
                 "void (anonymous namespace)::sum_runs<true>(int const*, float const*)",
                 "void (anonymous namespace)::max_runs<float4>(int const*, float4 const*)",
                 "void (anonymous namespace)::knn_kernel<4>(float const*, float const*, "
                 "float*, int, int)"):
        assert pattern.match(name), name
    for name in ("void (anonymous namespace)::elementwise_kernel_with_index<int>(int)",
                 "void at::native::(anonymous namespace)::finalize(float*)"):
        assert not pattern.match(name), name


def test_busy_time_is_the_union_of_intervals():
    assert cs._busy_ms([(0, 1000), (500, 1500), (3000, 4000), (3100, 3200)]) == 2.5
    assert cs._busy_ms([]) == 0.0


def test_short_name_strips_namespace_templates_and_parameters():
    assert cs.short_name("void (anonymous namespace)::decode_reached<uint4>(unsigned char "
                         "const*, uint4*, long long, int)") == "decode_reached"
    assert cs.short_name("(anonymous namespace)::scatter_max_rows(int const*)") == \
        "scatter_max_rows"
    assert cs.short_name("Memset (Device)") == "Memset"


def test_split_calls_ties_device_events_to_the_call_that_launched_them():
    """A lost device event leaves its call short and no other call long: the
    record_function ranges of a real CPU trace, with launches and kernels
    placed in them as CUPTI reports them (correlation ids)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            with record_function(f"{cs.SPLIT_LABEL}{i}"):
                torch.ones(64).sum()
    events = cs._trace_events(prof)
    ranges = sorted((e for e in events if e["name"].startswith(cs.SPLIT_LABEL)),
                    key=lambda e: e["ts"])
    assert len(ranges) == 4
    for i, r in enumerate(ranges):
        launch = r["ts"] + r["dur"] / 2
        events.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=launch,
                           dur=0, args={"correlation": 1000 + i}))
        events.append(dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize",
                           ts=launch, dur=0, args={"correlation": 2000 + i}))
        if i != 2:  # the trace lost call 2's kernel
            events.append(dict(ph="X", cat="kernel", name="void k<1>(float*)",
                               ts=launch + 1e4, dur=3.0, args={"correlation": 1000 + i}))
        # The same range on the device's timeline, late and long enough to
        # hold every launch of the trace.
        events.append(dict(ph="X", cat="gpu_user_annotation", name=r["name"],
                           ts=ranges[0]["ts"], dur=ranges[-1]["ts"] + ranges[-1]["dur"]
                           - ranges[0]["ts"] + 1e4, args={}))
    per_call = cs.split_calls(events, range(1, 4))
    assert [len(c) for c in per_call] == [1, 0, 1]
    assert [c[0]["args"]["correlation"] for c in per_call if c] == [1001, 1003]
