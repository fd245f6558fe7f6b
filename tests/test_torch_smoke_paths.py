"""``chip_smoke.py``'s later paths rehearsed on the CPU at a tiny size
(``tests/torch_rehearsal.py`` sets the phases up): the host cluster
prior's paths, the train loop, inference and evaluation, the
leaderboard submission, the viz layer, data parallelism. A file apart from
``tests/test_torch_smoke.py``, so that a second test worker takes them. It
imports no JAX, like the script."""

import torch
from torch_rehearsal import cpu_traced, cs, rehearsal  # noqa: F401 - a fixture


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
    from himo_tpu_torch.models import feedforward as pf
    from himo_tpu_torch.training import trainer as pt

    monkeypatch.setattr(pt, "make_model", pf.make_model)  # the rehearsal's toy model
    for name, value in (("LOOP_SCENES", 2), ("LOOP_FRAMES", 5), ("LOOP_BACKGROUND", 1200),
                        ("LOOP_ISOLATED_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)

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


def test_inference_phases_on_the_cpu(rehearsal, monkeypatch, capsys, tmp_path):
    """The native, fleet, save and eval phases at a toy size: the fleet on
    1 scene x 3 frames of 2,000 points (batches of 2, the second partial),
    ``cli.save`` on 1 scene x 4 frames padded to 2,048 points (``fastnsf``
    at 5 steps of a small MLP with its host prior and the scene-start
    repair, then ``seflowpp`` from a checkpoint), the evals in a temporary
    directory; the trace is the CPU's."""
    import functools

    from himo_tpu_torch.models import fastnsf, runner
    from himo_tpu_torch.ops.dt import DTConfig

    for name, value in (("NATIVE_FRAMES", (2000, 2100, 1900, 2048)), ("NATIVE_TREE", 4096),
                        ("NATIVE_RUNS", 2), ("FLEET_SCENES", 1), ("FLEET_FRAMES", 3),
                        ("FLEET_BACKGROUND", 1200), ("SAVE_SCENES", 1),
                        ("SAVE_BACKGROUND", 1200)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(fastnsf, "FastNSFConfig", functools.partial(
        fastnsf.FastNSFConfig, iterations=5, hidden=16, layers=2,
        dt=DTConfig(voxel_size=(3.2, 3.2, 1.6))))
    monkeypatch.setattr(runner, "bucket_size", lambda n: 2048)  # the toy table route

    monkeypatch.setattr(cs, "traced", cpu_traced)
    smi = "Card, 700.00 W"
    cs.phase_native(smi)
    fleet = cs.phase_fleet(rehearsal, smi, tmp_path / "av2_fleet")
    none = dict.fromkeys(fleet, 0)
    assert fleet == {**none, "scatter_max_rows": 3 * 2, "nn_argmin_rows": 10 * 2,
                     "nn_min_rows": 2}
    save = cs.phase_save(rehearsal, smi, tmp_path / "av2_save")
    assert save == {**none, "scatter_max_rows": 3 * 3, "nn_argmin_rows": 10 * 3,
                    "nn_min_rows": 3}
    monkeypatch.chdir(tmp_path)
    cs.phase_eval(smi, tmp_path / "av2_save", tmp_path / "av2_fleet")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["av2_fleet", "av2_save"]
    out = capsys.readouterr().out
    assert "[native] Card, 700.00 W: pack_frames 4 x <= 2048 x 3" in out
    assert "[fleet] Card, 700.00 W: timed pass" in out and "busy share 0.0000" in out
    assert "first batch vs plain versions: 1.000000 of points" in out
    assert "cli.save model=fastnsf: 3 frame pairs of 1 scenes" in out
    assert "cli.save model=seflowpp: 3 frame pairs of 1 scenes, 0 re-estimated" in out
    assert "[eval] Card, 700.00 W: Total MPE / CDE: perfect 0.000000" in out


def test_submit_phase_on_the_cpu(rehearsal, monkeypatch, capsys, tmp_path):
    """``phase_submit`` on 1 scene x 4 frames of 2,000 points with a
    ``perfect`` and a noisy ``seflowpp`` flow (3 eval frames): no kernel
    launched, the scene directory and the working directory left as they
    were."""
    from pathlib import Path

    from himo_tpu_torch.data.synthetic import make_dataset

    root = tmp_path / "av2_save"
    make_dataset(root, num_scenes=1, num_frames=4, seed=0, num_background=1200,
                 method_flows={"perfect": 0.0, "seflowpp": 0.05})
    before = sorted(p.name for p in root.iterdir())
    monkeypatch.chdir(tmp_path)
    cs.reset_counts()
    cs.phase_submit("Card, 700.00 W", root, Path(cs.__file__).resolve().parent)
    assert not any(cs.read_counts().values())
    assert sorted(p.name for p in root.iterdir()) == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["av2_save"]
    out = capsys.readouterr().out
    assert "[submit] Card, 700.00 W: host ms per frame over 3 frames: save_zip perfect" in out
    assert "zip-mode eval equals flow mode (totals and table) for perfect, seflowpp" in out
    assert "score MPE / CDE: gt 0.000000 / 0.000000 m; perfect 0.000000 / 0.000000 m" in out
    assert "byte for byte the same; columns equal the generator's" in out


def test_viz_phase_on_the_cpu(rehearsal, monkeypatch, capsys, tmp_path):
    """``phase_viz`` on 1 scene x 4 frames of 2,000 points with a
    ``perfect`` and a noisy ``seflowpp`` flow (none on the last frame, as
    ``cli.save`` writes it), at 96x96 and a 3-frame APNG:
    no kernel launched, every file read back equal, the scene directory
    left as it was. The test process may hold cv2, PIL or matplotlib from
    other tests; they are taken out of ``sys.modules`` for the phase."""
    import sys

    from himo_tpu_torch.data.synthetic import make_dataset

    from himo_tpu_torch.data.dataset import SceneFlowDataset
    from himo_tpu_torch.data.schema import rewrite_scene

    root = tmp_path / "av2_save"
    make_dataset(root, num_scenes=1, num_frames=4, seed=0, num_background=1200,
                 method_flows={"perfect": 0.0, "seflowpp": 0.05})
    scene, last = SceneFlowDataset(root).data_index[-1]  # as cli.save leaves it:
    rewrite_scene(root / f"{scene}.h5", {str(last): {"seflowpp": None}})  # no last flow
    before = sorted(p.name for p in root.iterdir())
    monkeypatch.setattr(cs, "VIZ_RESOLUTION", 96)
    monkeypatch.setattr(cs, "VIZ_ANIMATION_FRAMES", 3)
    for name in cs.VIZ_ABSENT:
        monkeypatch.delitem(sys.modules, name, raising=False)
    launches = cs.phase_viz("Card, 700.00 W", root)
    assert launches == dict.fromkeys(launches, 0)
    assert sorted(p.name for p in root.iterdir()) == before
    out = capsys.readouterr().out
    assert "[viz] Card, 700.00 W: visualize.main at 96x96, host ms per frame over 8 frames: " \
        "read " in out and ", encode " in out
    assert "[viz] Card, 700.00 W: save_animation at 96x96, host ms per frame over 3 frames" in out
    assert "largest chamfer / MPE: perfect 0.000000 / 0.000000 m; seflowpp " in out
    assert "files: 8 BEV PNGs " in out and "2 instance panels" in out and "1 APNG" in out
    assert "all 12 read back equal to their images; no kernel launched; none of cv2, " \
        "matplotlib, open3d, PIL imported" in out
    assert "[viz] the phase took" in out


def test_ingest_phase_on_the_cpu(rehearsal, monkeypatch, capsys, tmp_path):
    """``phase_ingest`` at a toy size: an AV2 log of 4 sweeps x 20,000
    points with 8 tracks, 2 Scania scenes x 3 superframes x 20,000 points
    with 6 boxes, the Scania extraction in a spawn pool of 2 CPU workers,
    ``cli.save`` at 2,048 points; the card's memory reading stubbed."""
    import torch

    from himo_tpu_torch.models import runner

    for name, value in (("INGEST_AV2_SWEEPS", 4), ("INGEST_AV2_POINTS", 20000),
                        ("INGEST_AV2_TRACKS", 8), ("INGEST_SCANIA_FRAMES", 3),
                        ("INGEST_SCANIA_BOXES", 6), ("INGEST_OBJECT_POINTS", 60),
                        ("BIG_POINTS", 20000)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(runner, "bucket_size", lambda n: 2048)  # the toy table route
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (0, 0))
    launches = cs.phase_ingest(rehearsal, "Card, 700.00 W", tmp_path / "ingest")
    none = dict.fromkeys(launches, 0)
    assert launches == {**none, "scatter_max_rows": 3 * 3, "nn_argmin_rows": 10 * 3,
                        "nn_min_rows": 3}
    out = capsys.readouterr().out
    for ds in ("av2", "scania"):
        assert f"[ingest] Card, 700.00 W: {ds} card vs CPU: every file, group and " \
            "dataset bitwise; 0 of" in out
        assert f"[ingest] Card, 700.00 W: {ds} " in out and "points_in_boxes" in out
    assert "extract_scania nproc=2" in out and "MiB a worker" in out
    assert "host ms a sweep: read" in out and "host ms a superframe: read" in out
    assert "second runs printed the skip line" in out and "perfect 0.000000 / 0.000000 m" in out


def test_data_parallel_phase_on_the_cpu(rehearsal, monkeypatch, capsys, tmp_path):
    """``phase_dp_gloo`` ((b) and (c); (a) needs NCCL) over two gloo CPU
    ranks at the toy size, each rank taking the toy setting
    (``rank_toy_setup``): the global batch of 2 split in two for 2 steps,
    then the fleet on 2 scenes x 3 frames of 2,000 points, whose one-rank
    flows this process writes first."""
    from torch_rehearsal import rank_toy_setup

    from himo_tpu_torch.data.synthetic import make_dataset
    from himo_tpu_torch.models.feedforward import init_params, make_model
    from himo_tpu_torch.parallel import fleet

    monkeypatch.setattr(cs, "DP_RANK_SETUP", rank_toy_setup)
    monkeypatch.setattr(cs, "DP_TIMEOUT_S", 120.0)
    root = tmp_path / "av2_fleet"
    make_dataset(root, num_scenes=2, num_frames=3, seed=0, num_background=1200)
    model, _ = make_model("seflowpp", dtype="bfloat16")
    fleet.fleet_save(str(root), model="seflowpp", output_key="fleet", verbose=False,
                     params=init_params(model, torch.Generator().manual_seed(0)),
                     config=fleet.FleetConfig(num_points=cs.NUM_POINTS, batch_per_device=cs.BATCH),
                     model_overrides={"dtype": "bfloat16"}, device="cpu")
    parts = cs.phase_dp_gloo(rehearsal, "Card, 700.00 W", root, tmp_path)
    none = dict.fromkeys(parts[0], 0)
    for steps in parts[:2]:
        assert steps == {**none, **{k: cs.DP_STEPS * v for k, v in cs.TRAIN_LAUNCHES.items()}}
    assert parts[2] == {**none, **{k: 2 * 2 * v for k, v in cs.FLEET_LAUNCHES.items()}}
    out = capsys.readouterr().out
    assert "[data_parallel] (b) step 1, two B1 ranks vs one B2 process" in out
    assert "parameters bitwise equal across the ranks after each of 2 steps" in out
    assert "through the host rank 0" in out
    assert "producer, host ms per global batch of 2 over 3 batches" in out
    assert "two ranks sharing one card: 6 frames, " in out
    assert "scenes written once each, by rank: [1, 1]" in out
