"""The port's leaderboard submission path (``io/submission.py``,
``cli/save_zip.py``, ``cli/save_zip_gt.py``, ``eval/score.py``,
``cli/score.py`` and zip-mode ``cli/eval.py``) against the JAX package's,
on the CPU.

Scenes come from the JAX package's ``make_dataset`` (2 scenes x 4 frames,
``perfect`` and ``noisy`` method flows). Each package writes its own
archives from the same scenes; each must read the other's (the JAX
package's frames are pandas' LZ4 feather files, the port's uncompressed
ones) to the same arrays. Score dicts, ``scores.json`` / ``res-av2.json``
and the printed text must be equal; zip-mode evaluation must print the
table flow mode prints. The cases of ``tests/test_score.py`` run on the
port: the GT-vs-GT gate, the missing sweep, extracted directories, the
test split without GT and the unknown dataset. Every scorer and eval call
runs in a temporary working directory."""

import json
import shutil
from zipfile import ZipFile

import numpy as np
import pytest

from himo_tpu.cli.eval import main as j_eval
from himo_tpu.cli.save_zip import main as j_save_zip
from himo_tpu.cli.save_zip_gt import main as j_save_zip_gt
from himo_tpu.cli.score import main as j_score_cli
from himo_tpu.data.synthetic import make_dataset
from himo_tpu.eval.score import score as j_score
from himo_tpu.io import submission as JS
from himo_tpu_torch.cli.eval import main as p_eval
from himo_tpu_torch.cli.save_zip import main as p_save_zip
from himo_tpu_torch.cli.save_zip_gt import main as p_save_zip_gt
from himo_tpu_torch.cli.score import main as p_score_cli
from himo_tpu_torch.eval.score import score as p_score
from himo_tpu_torch.io import submission as PS

SIDES = {"jax": (j_save_zip, j_save_zip_gt), "port": (p_save_zip, p_save_zip_gt)}
METHODS = ("perfect", "noisy")


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Both packages' archives of the same scenes, each side's save_zip and
    save_zip_gt run in turn on the same directory (so their printed paths
    agree), its archives then moved to ``{side}-{name}.zip``."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("submit") / "av2_submit"
    make_dataset(root, num_scenes=2, num_frames=4, seed=3,
                 method_flows={"perfect": 0.0, "noisy": 0.05})
    out = {"root": root}
    for side, (save_zip, save_zip_gt) in SIDES.items():
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            for name in METHODS:
                path = save_zip(data_dir=str(root), res_name=name)
                out[side, name] = shutil.move(path, root / f"{side}-{name}.zip")
            path = save_zip_gt(data_dir=str(root), output_dir=str(root / "gt"),
                               res_name="flow")
            out[side, "gt"] = shutil.move(path, root / f"{side}-gt.zip")
        out[side, "text"] = text.getvalue()
        assert not [p for p in (root / "results").iterdir() if p.is_dir()]
        assert not [p for p in (root / "gt").iterdir() if p.is_dir()]
    return out


def test_archives_match_and_each_package_reads_the_others(archives):
    assert archives["port", "text"] == archives["jax", "text"]
    for name in (*METHODS, "gt"):
        jz, pz = archives["jax", name], archives["port", name]
        with ZipFile(jz) as a, ZipFile(pz) as b:
            assert a.namelist() == b.namelist() and len(a.namelist()) == 6
        uuids = PS.list_sweep_uuids(pz)
        assert uuids == JS.list_sweep_uuids(pz) == JS.list_sweep_uuids(jz)
        for uuid in uuids:
            want = JS.read_submission_frame(jz, uuid)
            for reader in (PS.read_submission_frame, JS.read_submission_frame):
                for path in (jz, pz):
                    got = reader(path, uuid)
                    assert got.keys() == want.keys()
                    for key, value in want.items():
                        assert got[key].dtype == value.dtype, key
                        assert got[key].tobytes() == value.tobytes(), key
            np.testing.assert_array_equal(PS.read_comp_dis_zip(jz, uuid),
                                          JS.read_comp_dis_zip(pz, uuid))
        assert (name == "gt") == ("pc0" in want)


def test_written_frame_is_what_pandas_reads(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(0)
    n = 1000
    comp = rng.normal(0, 1, (n, 3))
    path = PS.write_comp_dis_feather(
        comp, ("scene_x", "17"), tmp_path, eval_mask=rng.random(n) < 0.5,
        flow_category_indices=rng.integers(0, 30, n), flow_instance_id=rng.integers(0, 9, n),
        gt_flow_norm=rng.random(n), pc0=rng.normal(0, 9, (n, 3)))
    JS.write_comp_dis_feather(
        comp, ("scene_y", "17"), tmp_path, eval_mask=rng.random(n) < 0.5,
        flow_category_indices=rng.integers(0, 30, n), flow_instance_id=rng.integers(0, 9, n),
        gt_flow_norm=rng.random(n), pc0=rng.normal(0, 9, (n, 3)))
    got, want = pd.read_feather(path), pd.read_feather(tmp_path / "scene_y" / "17.feather")
    assert list(got.columns) == list(want.columns)
    assert got.dtypes.to_dict() == want.dtypes.to_dict()
    assert got["comp_dis_y_m"].to_numpy().tobytes() == \
        comp[:, 1].astype(np.float32).tobytes()


def _run(fn, capsys, *args, **kwargs):
    capsys.readouterr()
    result = fn(*args, **kwargs)
    return result, capsys.readouterr().out


@pytest.mark.parametrize("pred", ["gt", *METHODS])
def test_score_matches_jax(archives, pred, tmp_path, monkeypatch, capsys):
    """The port's scorer on the port's archives and on JAX's, JAX's on
    JAX's: the same dict, files and text. GT against GT and ``perfect``
    against GT score zero, ``noisy`` worse."""
    monkeypatch.chdir(tmp_path)
    runs = {}
    for side, fn, src in (("jax", j_score, "jax"), ("port", p_score, "port"),
                          ("port on jax", p_score, "jax")):
        out_dir = tmp_path / side.replace(" ", "_")
        scores, text = _run(fn, capsys, archives[src, "gt"], archives[src, pred],
                            output_dir=str(out_dir))
        runs[side] = (scores, text.replace(str(out_dir), "OUT"),
                      (out_dir / "scores.json").read_text(),
                      (out_dir / "res-av2.json").read_text())
    assert runs["port"] == runs["jax"]
    assert runs["port on jax"] == runs["jax"]
    scores, text = runs["port"][:2]
    assert "╒" in text and scores["num_frames"] == 6
    if pred == "noisy":
        assert scores["mpe"] > 0.01 and scores["car_num_pts"] > 0
        assert scores["others_num_pts"] > 0
    else:
        assert scores["mpe"] < 1e-6 and scores["chamfer"] < 1e-6


def test_score_cli_matches_jax(archives, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    runs = {}
    for side, main in (("jax", j_score_cli), ("port", p_score_cli)):
        argv = ["--gt_zip", str(archives[side, "gt"]), "--pred_zip",
                str(archives[side, "noisy"]), "--output_dir", str(tmp_path / side),
                "--flow_mode", "noisy"]
        scores, text = _run(main, capsys, argv)
        runs[side] = (scores, text.replace(str(tmp_path / side), "OUT")
                      .replace(str(archives[side, "gt"]), "GT"),
                      json.loads((tmp_path / side / "res-av2.json").read_text()))
    assert runs["port"] == runs["jax"] and set(runs["port"][2]["av2"]) == {"noisy"}
    with pytest.raises(SystemExit):
        p_score_cli(["--gt_zip", str(archives["port", "gt"])])


@pytest.mark.parametrize("method", METHODS)
def test_zip_mode_eval_prints_flow_modes_table(archives, method, tmp_path, monkeypatch,
                                               capsys):
    """``cli.eval comp_dis_zip=`` on each package's archive prints the
    table and writes the JSON that flow mode does, and JAX's zip mode
    does."""
    root = str(archives["root"])
    runs = {}
    for side, main, kwargs in (
            ("flow", p_eval, {}),
            ("zip", p_eval, {"comp_dis_zip": str(archives["port", method])}),
            ("zip on jax", p_eval, {"comp_dis_zip": str(archives["jax", method])}),
            ("jax zip", j_eval, {"comp_dis_zip": str(archives["jax", method])})):
        cwd = tmp_path / side.replace(" ", "_")
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        metrics, text = _run(main, capsys, data_dir=root, res_name=method, **kwargs)
        table = text[text.index("HiMo refinement metrics"):]
        runs[side] = (metrics.total_summary(), table, (cwd / "res-av2.json").read_text())
        assert ("Using provided comp_dis_zip" in text) == bool(kwargs)
    assert runs["zip"] == runs["flow"]
    assert runs["zip on jax"] == runs["flow"] == runs["jax zip"]
    if method == "perfect":
        assert runs["zip"][0]["mpe"] < 1e-5


def test_missing_sweep_warns_and_continues(archives, tmp_path, capsys):
    partial = str(tmp_path / "av2_partial.zip")
    with ZipFile(archives["port", "noisy"]) as src, ZipFile(partial, "w") as dst:
        for name in src.namelist()[1:]:  # drop the first sweep
            dst.writestr(name, src.read(name))
    runs = {side: _run(fn, capsys, archives["port", "gt"], partial)
            for side, fn in (("jax", j_score), ("port", p_score))}
    assert runs["port"] == runs["jax"]
    scores, text = runs["port"]
    assert "Missing prediction" in text and scores["num_frames"] == 5


def test_score_extracted_directories(archives, tmp_path):
    gt_dir, pred_dir = tmp_path / "gt_av2_extracted", tmp_path / "pred_extracted"
    with ZipFile(archives["port", "gt"]) as zf:
        zf.extractall(gt_dir)
    with ZipFile(archives["jax", "perfect"]) as zf:
        zf.extractall(pred_dir)
    assert sorted(PS.list_sweep_uuids(gt_dir)) == sorted(JS.list_sweep_uuids(gt_dir))
    scores = p_score(str(gt_dir), str(pred_dir))
    assert scores == j_score(str(gt_dir), str(pred_dir))
    assert scores["mpe"] < 1e-6 and scores["num_frames"] == 6


def test_unknown_dataset_raises(archives, tmp_path):
    anon = tmp_path / "anonymous-submit.zip"
    shutil.copy(archives["port", "gt"], anon)
    with pytest.raises(ValueError, match="Cannot infer dataset"):
        p_score(str(anon), str(anon))
    scores = p_score(str(anon), str(anon), data_name="av2")
    assert scores["mpe"] < 1e-6
    assert p_score(str(anon), str(anon), data_name="scania") == \
        j_score(str(anon), str(anon), data_name="scania")
    with pytest.raises(ValueError, match="Unknown data_name"):
        p_score(str(anon), str(anon), data_name="kitti")


def test_save_zip_on_test_split_without_gt(tmp_path):
    """Leaderboard test splits carry no GT flow; save_zip still exports,
    as the JAX package's does (the GT fields removed through the port's
    scene rewrite)."""
    from himo_tpu_torch.data import h5
    from himo_tpu_torch.data.schema import rewrite_scene

    root = tmp_path / "av2_test_split"
    make_dataset(root, num_scenes=1, num_frames=3, seed=9, method_flows={"m": 0.0})
    gt_keys = ("flow", "flow_is_valid", "flow_category_indices", "flow_instance_id",
               "ego_motion")
    for path in root.glob("*.h5"):
        with h5.File(path) as f:
            keys = list(f.keys())
        rewrite_scene(path, {key: dict.fromkeys(gt_keys) for key in keys})
        with h5.File(path) as f:
            assert not set(gt_keys) & set(f[keys[0]].keys())
    zips = {}
    for side, (save_zip, _) in SIDES.items():
        zips[side] = shutil.move(save_zip(data_dir=str(root), res_name="m"),
                                 tmp_path / f"{side}.zip")
    uuids = PS.list_sweep_uuids(zips["port"])
    assert len(uuids) == 2 and uuids == JS.list_sweep_uuids(zips["jax"])
    for uuid in uuids:
        np.testing.assert_array_equal(PS.read_comp_dis_zip(zips["port"], uuid),
                                      JS.read_comp_dis_zip(zips["jax"], uuid))
