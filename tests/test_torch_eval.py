"""The port's flow-mode evaluation (``himo_tpu_torch/eval/``, ``cli/eval.py``,
``cli/eval_flow.py``) against the JAX package's, on the CPU.

Scenes: the session's ``synthetic_dataset`` (the JAX package's
``make_dataset``, 2 scenes x 4 frames with ``perfect`` and ``noisy``
method flows), and a copy with a third method flow. Everything is held
bitwise or equal: ``prepare_frame``'s arrays, the scene-flow metrics, the
instance metrics' summaries and the JSON ``print`` writes, on both native
branches (the KD-tree Chamfer of each package, or scipy's on both), and
the printed text, whose table the port formats without tabulate. Every
eval runs in a temporary working directory (``res-*.json`` is written
there)."""

import json
import shutil

import numpy as np
import pytest
from tabulate import tabulate

import himo_tpu.native
import himo_tpu_torch.native
from himo_tpu.cli.eval import main as j_eval
from himo_tpu.cli.eval_flow import main as j_eval_flow
from himo_tpu.data.dataset import SceneFlowDataset as JDataset
from himo_tpu.eval import flow_metrics as JFM
from himo_tpu.eval.pipeline import prepare_frame as j_prepare
from himo_tpu_torch.cli.eval import main as p_eval
from himo_tpu_torch.cli.eval_flow import main as p_eval_flow
from himo_tpu_torch.data.dataset import SceneFlowDataset as PDataset
from himo_tpu_torch.eval import flow_metrics as PFM
from himo_tpu_torch.eval.instance_metrics import fancy_grid
from himo_tpu_torch.eval.pipeline import prepare_frame as p_prepare

METHODS = ("perfect", "noisy", "raw")
HEADERS = ["Class", "CDE (Chamfer) ↓", "MPE (Point Err) ↓", "# Points", "# Objs"]


@pytest.fixture(params=["native", "scipy"])
def branch(request, monkeypatch):
    """Both packages on their native KD-tree, or both on scipy's."""
    if request.param == "scipy":
        monkeypatch.setattr(himo_tpu.native, "available", lambda: False)
        monkeypatch.setattr(himo_tpu_torch.native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("data_name", ["av2", "scania"])
def test_prepare_frame_matches_reference(synthetic_dataset, data_name):
    jds = JDataset(synthetic_dataset, vis_name="noisy", eval=True)
    pds = PDataset(synthetic_dataset, vis_name="noisy", eval=True)
    for i in range(len(jds)):
        jd, pd = jds[i], pds[i]
        for res_name in (None, "raw", "noisy"):
            want = j_prepare(jd, data_name, res_name=res_name)
            got = p_prepare(pd, data_name, res_name=res_name)
            assert got.keys() == want.keys()
            for k in want:
                g, w = np.asarray(got[k]), np.asarray(want[k])
                assert g.dtype == w.dtype and g.shape == w.shape, k
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_flow_metrics_match_reference(synthetic_dataset):
    for name in METHODS:
        got = PFM.evaluate_flow_metrics(synthetic_dataset, name, verbose=False)
        want = JFM.evaluate_flow_metrics(synthetic_dataset, name, verbose=False)
        assert got == want
    rng = np.random.default_rng(0)
    fm_p, fm_j = PFM.FlowMetrics(), JFM.FlowMetrics()
    for _ in range(3):
        gt = rng.normal(0, 0.3, (500, 3)).astype(np.float32)
        est = gt + rng.normal(0, 0.05, (500, 3)).astype(np.float32)
        fg, mask = rng.uniform(size=500) > 0.4, rng.uniform(size=500) > 0.1
        fm_p.step(est, gt, fg, mask)
        fm_j.step(est, gt, fg, mask)
    assert fm_p.summary() == fm_j.summary()


def test_cli_eval_matches_reference(synthetic_dataset, tmp_path, monkeypatch, capsys, branch):
    """``cli.eval`` on each method: the summaries, the JSON file and the
    printed text equal the reference's; ``perfect`` scores zero and ``raw``
    worse; a scene filter names its file."""
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    out = {}
    for side, main in (("jax", j_eval), ("port", p_eval)):
        monkeypatch.chdir(tmp_path / side)
        capsys.readouterr()
        metrics = {name: main(data_dir=str(synthetic_dataset), res_name=name)
                   for name in METHODS}
        filtered = main(data_dir=str(synthetic_dataset), res_name="noisy",
                        scene_filter="scene_001")
        out[side] = dict(metrics=metrics, filtered=filtered, text=capsys.readouterr().out,
                         json=json.loads((tmp_path / side / "res-av2.json").read_text()),
                         json_filtered=(tmp_path / side / "res-av2-scene_001.json").read_text())
    got, want = out["port"], out["jax"]
    assert got["text"] == want["text"] and "╒" in got["text"]
    assert got["json"] == want["json"] and set(got["json"]["av2"]) == set(METHODS)
    assert got["json_filtered"] == want["json_filtered"]
    for name in METHODS:
        g, w = got["metrics"][name], want["metrics"][name]
        assert g.total_summary() == w.total_summary() and g.frame_cnt == w.frame_cnt
        for cat in ("CAR", "OTHER_VEHICLES"):
            assert g.category_summary(cat) == w.category_summary(cat)
    assert got["filtered"].total_summary() == want["filtered"].total_summary()
    perfect, raw = (got["metrics"][n].total_summary() for n in ("perfect", "raw"))
    assert perfect["mpe"] < 1e-5 and perfect["cd"] < 1e-5 and raw["mpe"] > 0.3
    assert raw["cd"] > perfect["cd"]


def test_cli_eval_flow_matches_reference(synthetic_dataset, tmp_path, monkeypatch):
    results = {}
    for side, main in (("jax", j_eval_flow), ("port", p_eval_flow)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        results[side] = main(data_dir=str(synthetic_dataset), res_names=list(METHODS))
        results[side + "_file"] = (tmp_path / side / "res-flow-av2.json").read_text()
    assert results["port"] == results["jax"]
    assert results["port_file"] == results["jax_file"]
    assert results["port"]["perfect"]["EPE_3way"] < 1e-6


def test_printed_table_is_tabulates(synthetic_dataset, tmp_path, monkeypatch, capsys):
    """The port's table against ``tabulate``'s own text for the rows that
    ``print`` builds on ``perfect``, ``raw`` and a noisy flow written into a
    copy of the scenes, and for a table without rows."""
    from himo_tpu_torch.data.schema import write_method_flows
    from himo_tpu_torch.eval import instance_metrics as PIM

    root = tmp_path / "av2_table"
    shutil.copytree(synthetic_dataset, root)
    rng = np.random.default_rng(3)
    ds = PDataset(root, vis_name="perfect")
    by_scene = {}
    for i in range(len(ds)):
        d = ds[i]
        by_scene.setdefault(d["scene_id"], {})[d["timestamp"]] = (
            d["perfect"] + rng.normal(0, 0.2, d["perfect"].shape).astype(np.float32))
    for scene, flows in by_scene.items():
        write_method_flows(root, scene, "wobbly", flows)
    tables = []
    real = PIM.fancy_grid
    monkeypatch.setattr(PIM, "fancy_grid", lambda rows, headers: tables.append(
        (rows, headers)) or real(rows, headers))
    monkeypatch.chdir(tmp_path)
    for name in ("perfect", "raw", "wobbly"):
        p_eval(data_dir=str(root), res_name=name)
    assert len(tables) == 3
    text = capsys.readouterr().out
    for rows, headers in tables + [([], HEADERS)]:
        want = tabulate(rows, headers=headers, tablefmt="fancy_grid", stralign="center")
        assert fancy_grid(rows, headers) == want
        assert not rows or want in text


def test_zip_mode_is_refused(synthetic_dataset, tmp_path, monkeypatch, capsys):
    """A ``comp_dis_zip`` that does not exist is refused as the source: the
    eval falls back to the flow ``res_name`` names, as the JAX package's
    ``check_valid`` does, and prints what the reference prints."""
    out = {}
    for side, main in (("jax", j_eval), ("port", p_eval)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        capsys.readouterr()
        metrics = main(data_dir=str(synthetic_dataset), res_name="noisy",
                       comp_dis_zip="pred-submit.zip")
        out[side] = (metrics.total_summary(), capsys.readouterr().out,
                     sorted(p.name for p in (tmp_path / side).iterdir()))
        flow = main(data_dir=str(synthetic_dataset), res_name="noisy")
        assert flow.total_summary() == metrics.total_summary()
    assert out["port"] == out["jax"]
    assert "No valid comp_dis_zip provided, evaluating based on noisy" in out["port"][1]
    assert out["port"][2] == ["res-av2.json"]
