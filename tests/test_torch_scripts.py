"""The port's counterparts of the JAX package's scripts, against those
scripts on the CPU at a toy size, each run in a test directory (the
evaluations write ``res-*.json`` into the working directory):

- ``torch_quality_evidence.run_one`` and ``quality_evidence.run_one`` with
  ``--skip-train --skip-opt`` on the same toy suite (2 + 1 scenes of
  ``make_benchmark_dataset``, 1,500 + 6 x 100 points a frame): the suites
  each builds bitwise equal, equal tables, the same printed table and
  equal ``res-*.json`` files; the port's train branch once at a toy width
  (the network's preset shrunk by patching ``make_model``) with finite
  rows;
- both ``prior_diagnostic`` mains print the same lines (both packages on
  scipy's ``cKDTree``);
- both ``flagship_diagnostic`` mains on one checkpoint, JAX's orbax tree
  converted by ``scripts/orbax_to_torch.py``, JAX's forward run op by op
  (a jitted run differs by up to 0.93 in the dynamic logits): each fast
  instance's slot coverage, gate share, AccS and slot count equal, its
  errors within 1e-4 m;
- ``torch_profile_fleet.profile`` prints every stage with ``device="cpu"``,
  and the busy ms a batch of the traced pass it hands to ``busy``;
- ``torch_kernel_bench``'s pairs with the plain versions on the CPU: the
  scatter pair equal to its library pair, the one-hot pair within bf16
  rounding of it.
"""

import functools
import importlib.util
import json
import pickle
import shutil
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest

import himo_tpu.native
import himo_tpu_torch.native
from himo_tpu.data import synthetic as JSyn
from himo_tpu.models import feedforward as JF
from himo_tpu_torch.data import synthetic as PSyn
from himo_tpu_torch.models import feedforward as PF

REPO = Path(__file__).resolve().parents[1]
SUITE = dict(num_scenes=2, adversarial_scenes=1)
FLAGS = ["--bg-points", "1500", "--obj-points", "100", "--num-points", "2048",
         "--device", "cpu"]
TOY = {"pillar.voxel_size": (0.8, 0.8), "depths": (16, 32), "refine.num_query": 64,
       "refine.num_ref": 128}


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def on_ckdtree(monkeypatch):
    """Both packages on scipy's ``cKDTree`` (the native trees' parity is
    ``tests/test_torch_native.py``'s)."""
    monkeypatch.setattr(himo_tpu.native, "available", lambda: False)
    monkeypatch.setattr(himo_tpu_torch.native, "available", lambda: False)


@pytest.fixture()
def toy_suite(monkeypatch):
    """Both packages' ``make_benchmark_dataset`` cut to ``SUITE``."""
    monkeypatch.setattr(JSyn, "make_benchmark_dataset",
                        functools.partial(JSyn.make_benchmark_dataset, **SUITE))
    monkeypatch.setattr(PSyn, "make_benchmark_dataset",
                        functools.partial(PSyn.make_benchmark_dataset, **SUITE))


def _h5(path) -> dict:
    with h5py.File(path, "r") as f:
        return {(g, d): np.asarray(f[g][d][()]) for g in f for d in f[g]}


def _run_quality(module, work: Path, argv, monkeypatch, capsys, on_step=None):
    work.mkdir()
    monkeypatch.chdir(work)
    port = _script("torch_quality_evidence")
    args = port.parse_args(["--root", str(work / "av2_quality"), *argv])
    args.on_step = on_step
    table = module.run_one(args, work / "av2_quality", 0)
    capsys.readouterr()
    module.print_table([table])
    printed = capsys.readouterr().out
    files = {p.name: json.loads(p.read_text()) for p in work.glob("res-*.json")}
    return table, printed, files


def test_quality_run_one_matches_jax(tmp_path, toy_suite, monkeypatch, capsys):
    jax_table, jax_printed, jax_files = _run_quality(
        _script("quality_evidence"), tmp_path / "jax", ["--skip-train", "--skip-opt", *FLAGS],
        monkeypatch, capsys)
    table, printed, files = _run_quality(
        _script("torch_quality_evidence"), tmp_path / "port",
        ["--skip-train", "--skip-opt", *FLAGS], monkeypatch, capsys)
    assert list(table) == ["raw", "raw [adv]"]
    assert table == jax_table
    assert printed == jax_printed and "| raw [adv] |" in printed
    assert sorted(files) == ["res-av2-scene_adv.json", "res-av2.json",
                             "res-flow-av2-scene_adv.json", "res-flow-av2.json"]
    assert files == jax_files
    # The two suites, bitwise: the raw rows rest on them.
    jroot, proot = tmp_path / "jax" / "av2_quality", tmp_path / "port" / "av2_quality"
    names = sorted(p.name for p in jroot.iterdir())
    assert names == sorted(p.name for p in proot.iterdir())
    assert names == ["index_eval.pkl", "index_total.pkl", "scene_000.h5", "scene_001.h5",
                     "scene_adv_000.h5"]
    for name in names:
        if name.endswith(".pkl"):
            assert pickle.loads((proot / name).read_bytes()) == \
                pickle.loads((jroot / name).read_bytes())
            assert (proot / name).read_bytes() == (jroot / name).read_bytes(), name
            continue
        got, want = _h5(proot / name), _h5(jroot / name)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key


def test_quality_train_branch_on_the_cpu(tmp_path, toy_suite, monkeypatch, capsys):
    from himo_tpu_torch.training import trainer as PT

    make = PF.make_model
    toy_make = functools.partial(make, **TOY)
    monkeypatch.setattr(PF, "make_model", toy_make)
    monkeypatch.setattr(PT, "make_model", toy_make)
    qe = _script("torch_quality_evidence")
    steps = []
    table, printed, files = _run_quality(
        qe, tmp_path / "port", ["--skip-opt", "--epochs", "1", *FLAGS], monkeypatch, capsys,
        on_step=lambda label, s: steps.append(label))
    assert list(table) == ["raw", "seflowpp", "raw [adv]", "seflowpp [adv]"]
    assert all(np.isfinite(v) for row in table.values() for v in row.values())
    assert steps == ["dataset", "labels", "train seflowpp", "fleet seflowpp", "eval",
                     "eval_flow"]
    assert "seflowpp" in files["res-av2.json"]["av2"]
    assert (tmp_path / "port" / "av2_quality" / "runs" / "seflowpp" / "ckpts").is_dir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        qe.main(["--root", str(tmp_path / "never")])
    assert not (tmp_path / "never").exists()


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """A toy suite written once for the diagnostics (the port's writer; the
    JAX package's writes the same bytes, above)."""
    root = tmp_path_factory.mktemp("diag") / "av2_quality"
    PSyn.make_benchmark_dataset(root, seed=0, num_background=1500, points_per_object=100,
                                **SUITE)
    return root


def test_prior_diagnostic_prints_as_jax(suite, monkeypatch, capsys):
    argv = ["--root", str(suite), "--min-speed", "5"]
    monkeypatch.setattr(sys, "argv", ["prior_diagnostic.py", *argv])
    _script("prior_diagnostic").main()
    want = capsys.readouterr().out
    stats = _script("torch_prior_diagnostic").main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert len(stats) > 10 and f"fast-object frame-instances: {len(stats)}" in got
    assert "covered-ok err" in got


def test_flagship_diagnostic_matches_jax(suite, tmp_path, monkeypatch):
    """One checkpoint, JAX's and the port's reading of it: random weights
    with the slice test's two head biases (dynamic logit -1.2, gate +0.1),
    so that gates open and components form."""
    from himo_tpu.training import checkpoints as JCk
    from himo_tpu.training import trainer as JT

    sys.path.insert(0, str(REPO / "scripts"))
    import orbax_to_torch

    monkeypatch.setattr(JF, "make_model", functools.partial(JF.make_model, **TOY))
    jm, _ = JF.make_model("seflowpp")
    n = 2048
    sweeps = tuple(jax.numpy.zeros((256, 3)) for _ in range(3))
    valids = tuple(jax.numpy.ones((256,), bool) for _ in range(3))
    params = jax.jit(lambda k: jm.init(k, sweeps, valids, None))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["UNet_0"]["Conv_0"]["bias"][64] = -1.2  # dynamic logit
    params["params"]["DeFlowGRUDecoder_0"]["Dense_3"]["bias"][3] = 0.1  # gate
    opt, _ = JT.make_optimizer(JT.TrainConfig(), 1)
    roots = {side: tmp_path / side / "av2_quality" for side in ("jax", "port")}
    for root in roots.values():
        shutil.copytree(suite, root)
    ckpts = roots["jax"] / "runs" / "seflowpp" / "ckpts"
    mgr = JCk.CheckpointManager(ckpts, async_save=False)
    mgr.save(3, {"params": params, "opt_state": opt.init(params), "step": 3})
    mgr.close()
    assert orbax_to_torch.convert_checkpoint(
        ckpts, roots["port"] / "runs" / "seflowpp" / "ckpts", **TOY) == 3

    argv = ["--min-speed", "5", "--num-points", str(n), "--limit", "2"]
    jax_script = _script("flagship_diagnostic")
    captured = []

    def capture_sorted(items, **kw):
        if "key" in kw:  # the rows, ranked by error (the other call sorts bucket names)
            captured.append([dict(r) for r in items])
        return sorted(items, **kw)

    jax_script.sorted = capture_sorted  # the rows the script ranks for its worst list
    monkeypatch.setattr(sys, "argv", ["flagship_diagnostic.py", "--root",
                                      str(roots["jax"]), *argv])
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda fn, *a, **k: fn)  # the forward op by op
        jax_script.main()
    (want,) = captured
    monkeypatch.setattr(PF, "make_model", functools.partial(PF.make_model, **TOY))
    got = _script("torch_flagship_diagnostic").main(
        ["--root", str(roots["port"]), "--device", "cpu", *argv])
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("scene", "frame", "inst", "slot_cov", "gate_open", "acc_s",
                                  "n_slots")} == \
            {k: w[k] for k in ("scene", "frame", "inst", "slot_cov", "gate_open", "acc_s",
                               "n_slots")}
        for k in ("speed", "err_mean", "pooled_bias"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)
    assert any(r["slot_cov"] > 0 for r in got) and any(r["gate_open"] > 0 for r in got)


def test_profile_fleet_prints_every_stage_on_the_cpu(tmp_path, capsys):
    out = _script("torch_profile_fleet").profile(
        tmp_path / "av2_fleet", "cpu", num_points=2048, batch_size=2, model_overrides=TOY,
        scenes=dict(num_scenes=2, num_frames=3, num_background=1500, seed=0))
    printed = capsys.readouterr().out
    stages = ("h5_decode(dataset[i])", "rigid_flow", "frame_to_arrays", "stack_fleet_batch",
              "upload+step_launch", "synchronize+readback", "h5_write_back")
    assert sorted(out["totals"]) == sorted(stages)
    for stage in stages:
        assert stage in printed
    assert out["frames"] == 6 and out["batches"] == 3 and out["busy_ms"] is None
    assert out["counts"]["upload+step_launch"] == 3 and out["counts"]["h5_write_back"] == 6
    assert "device busy not measured" in printed


def test_profile_fleet_traces_one_more_pass_for_busy(tmp_path, capsys):
    """``busy`` gets a run of one more pass over the batches; the busy ms
    it returns is printed a batch."""
    passes = []

    def busy(run):
        run()
        passes.append(1)
        return 9.0

    out = _script("torch_profile_fleet").profile(
        tmp_path / "av2_fleet", "cpu", num_points=1024, batch_size=2, model_overrides=TOY,
        scenes=dict(num_scenes=1, num_frames=3, num_background=800, seed=0), busy=busy)
    assert passes == [1] and out["frames"] == 3 and out["batches"] == 1
    assert out["busy_ms"] == 9.0
    assert "device busy 9.000 ms" in capsys.readouterr().out


def test_kernel_bench_pairs_on_the_cpu(monkeypatch):
    """The two pairs at B2 x 4,096 points with the plain versions (what the
    kernels are held to bitwise on the card) against their library pairs."""
    import torch

    kb = _script("torch_kernel_bench")
    monkeypatch.setattr(kb, "B", 2)
    monkeypatch.setattr(kb, "N", 4096)
    pair, library, wanted, mag = kb._scatter_pairs("cpu")
    assert mag is None  # the max pair is held bitwise
    (out, grad), (lout, lgrad) = pair(), library()
    assert wanted == {"scatter_max_rows": 1, "sorted_gather_rows": 1}
    assert out.shape == (2, 512, 512, kb.C) and grad.shape == (2, 4096, kb.C)
    assert torch.equal(out, lout) and torch.equal(grad, lgrad)
    assert (grad != 0).any()
    pair, library, wanted, mag = kb._onehot_pairs("cpu")
    (out, grad), (lout, lgrad) = pair(), library()
    assert mag.shape == out.shape and bool((mag >= out.abs()).all())
    assert wanted == {"sorted_segment_sum": 1, "sorted_segment_gather": 1}
    assert out.shape == (2, 512 * 512, kb.C) and grad.shape == (2, 4096, kb.C)
    torch.testing.assert_close(out, lout, rtol=0, atol=0.02)  # bf16-rounded operands
    torch.testing.assert_close(grad, lgrad, rtol=0, atol=0.02)
