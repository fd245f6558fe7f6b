"""``chip_smoke.py``'s kernel phases and its trace helpers rehearsed on
the CPU at a tiny size (``tests/torch_rehearsal.py`` sets the phases up).
What it checks is the script's own logic: shapes, the kernel-vs-plain
comparisons, the launch counts each path expects, and the kernels line it
prints. The rehearsals of the later paths are in
``tests/test_torch_smoke_paths.py``, so that a second test worker takes
them. It imports no JAX, like the script."""

import json

import pytest
import torch
from torch_rehearsal import cpu_traced, cs, rehearsal  # noqa: F401 - a fixture


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
                 "void (anonymous namespace)::gather_scattered<float4>(int const*, "
                 "int const*, float4 const*, float4*, long long, int, int, int)",
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


def test_downstream_phase_on_the_cpu(rehearsal, monkeypatch, capsys, tmp_path):
    """``phase_downstream`` at a toy size on 1 scene x 4 frames of 2,000
    points (3 eval frames) with a ``perfect`` flow, 2,048 points a frame:
    SegNet on a 256x256 grid at depths (16, 32), which the shrunk
    thresholds send down the table route as the 512x512 grid at 32,768
    points goes on the card; DetNet at voxel 0.8 (128x128, resident, as
    256x256 on the card); the trace is the CPU's."""
    from himo_tpu_torch.data.synthetic import make_dataset
    from himo_tpu_torch.ops.voxelize import PillarConfig

    for name, value in (("DOWNSTREAM_POINTS", 2048), ("DET_VOXEL", 0.8),
                        ("DOWNSTREAM_TRACE_CALLS", 1),
                        ("SEG_OVERRIDES", {"pillar": PillarConfig(voxel_size=(0.4, 0.4)),
                                           "depths": (16, 32)})):
        monkeypatch.setattr(cs, name, value)

    monkeypatch.setattr(cs, "traced", cpu_traced)
    root = tmp_path / "av2_down"
    make_dataset(root, num_scenes=1, num_frames=4, seed=0, num_background=1200,
                 method_flows={"perfect": 0.0})
    launches = cs.phase_downstream(rehearsal, "Card, 700.00 W", root)
    frames, eval_frames = 4, 3
    want = dict.fromkeys(launches, 0)
    want.update(scatter_max_rows=frames + 2 * frames, sorted_gather_rows=frames,
                scatter_sum_rows=frames)
    det_steps = launches["scatter_max_resident_rows"] - 2 * eval_frames
    assert 1 <= det_steps <= eval_frames
    want["scatter_max_resident_rows"] = det_steps + 2 * eval_frames
    assert launches == want
    out = capsys.readouterr().out
    assert "[seg_h5 train] step 1, kernels vs plain" in out
    assert "[det_h5 train] step 1, kernels vs plain" in out
    assert "[downstream] Card, 700.00 W: seg_h5 SegNet, grid (256, 256)" in out
    assert "busy share 0.0000" in out and "eval_seg mIoU seg_raw" in out
    assert "argmax equal on the" in out and "det_h5 geometric:" in out
    for kernel in ("scatter_max_rows (SegNet)", "scatter_sum_rows (SegNet)",
                   "sorted_gather_rows (SegNet)", "scatter_max_resident_rows (DetNet)"):
        assert f"[downstream] {kernel} B=1 N=2048" in out
    assert out.count('[downstream] scatter_max') >= 2 and '"bound_ms"' in out


def test_device_split_fails_when_a_call_lost_its_device_events(monkeypatch, capsys):
    """A call that lost a device event is left out and named; a trace with
    fewer than ``SPLIT_WHOLE`` of its calls whole fails (17 of 20 calls of
    K5 once came back empty on the card, before each trace opened with
    its lead of fills)."""
    kernel = {"name": "void (anonymous namespace)::k<1>(float*)", "dur": 2000.0}
    calls = {"whole": [[kernel]] * 20, "one lost": [[kernel]] * 19 + [[]],
             "lost": [[] for _ in range(17)] + [[kernel]] * 3,
             "six lost": [[]] * 6 + [[kernel]] * 14}
    monkeypatch.setattr(cs, "traced", lambda fn: (fn(), []))
    for case in ("whole", "one lost"):
        monkeypatch.setattr(cs, "split_calls", lambda events, c: calls[case])
        split = cs.device_split(lambda: None)
        assert set(split) == {"k"} and split["k"] == pytest.approx(2.0)
    assert "calls [19] of 20 lacked a device event" in capsys.readouterr().out
    for case in ("lost", "six lost"):
        monkeypatch.setattr(cs, "split_calls", lambda events, c: calls[case])
        with pytest.raises(AssertionError, match="device events per call"):
            cs.device_split(lambda: None)


def test_without_lead_drops_the_fills_device_events():
    """The device events of the launches in the lead range go, the ones
    lost are not counted, and the rest of the trace stays whole."""
    def ev(name, cat, ts, corr=None):
        return {"name": name, "cat": cat, "ts": ts, "dur": 1.0,
                **({"args": {"correlation": corr}} if corr is not None else {})}

    lead = [ev(cs.LEAD_LABEL, "user_annotation", 0)]
    lead[0]["dur"] = 100.0
    launches = [ev("cudaLaunchKernel", "cuda_runtime", 10 * i, i) for i in (1, 2, 3)]
    filled = [ev("fill", "kernel", 200 + i, i) for i in (1, 2)]  # fill 3 lost
    timed = [ev("cudaLaunchKernel", "cuda_runtime", 150, 4), ev("k", "kernel", 300, 4),
             ev(f"{cs.SPLIT_LABEL}0", "user_annotation", 140)]
    events, kept = cs.without_lead(lead + launches + filled + timed)
    assert kept == 2
    assert events == lead + launches + timed