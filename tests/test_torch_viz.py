"""The port's viz layer (``himo_tpu_torch/viz/``) against the JAX package's
``himo_tpu/viz/``, on the CPU.

Scenes: the session's ``synthetic_dataset`` (the JAX package's
``make_dataset``, 2 scenes x 4 frames with ``perfect`` and ``noisy``
method flows). Images are held bitwise: the port's PNGs decoded by PIL and
by ``png.read`` against the JAX package's ``cv2.imwrite`` files decoded by
``cv2.imread``, the APNG fly-through's frames against those the JAX package
hands ``cv2.VideoWriter`` (a recording stand-in), the instance panels
outside the label boxes (cv2's Hershey label against the port's bitmap
font). Also bitwise or equal: the printed instance scores, the
trajectories, the schematic's arrays against a recording matplotlib
``Axes``, the ``plasma`` table, the open3d viewer's call logs against a
mock, and ``view_dataset``'s geometry."""

import json
import sys
import types

import cv2
import numpy as np
import pytest
from PIL import Image, ImageSequence

from himo_tpu.viz import animation as JA
from himo_tpu.viz import o3d_view as JO
from himo_tpu.viz import render as JR
from himo_tpu.viz import schematic as JS
from himo_tpu.viz import view_instance as JV
from himo_tpu.viz import visualize as JZ
from himo_tpu_torch.viz import animation as PA
from himo_tpu_torch.viz import font, png
from himo_tpu_torch.viz import o3d_view as PO
from himo_tpu_torch.viz import render as PR
from himo_tpu_torch.viz import schematic as PS
from himo_tpu_torch.viz import view_instance as PV
from himo_tpu_torch.viz import visualize as PZ

RES = 160


def _cv2_read(path) -> np.ndarray:
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]


def _pil_frames(path) -> list:
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


CENTER64 = (0.3, -1.1)  # not float32 numbers


def _edge_cloud(extent: float) -> np.ndarray:
    """Random points around the view, points on and just outside its
    edges, 40 points on one pixel (later points overwrite earlier), and
    float32 points on the pixel boundaries about ``CENTER64``, where
    float64 and float32 arithmetic truncate to different pixels."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.2 * extent, 1.2 * extent, (600, 3))
    eps = 1e-3
    edges = [(x, y, 0.5) for x in (-extent, extent, -extent - eps, extent - eps,
                                   -extent + eps) for y in (-extent, extent, extent + eps,
                                                            0.0, -extent + eps)]
    same = np.tile([[1.01, 2.02, 0.0]], (40, 1)) + np.linspace(0, 2, 40)[:, None] * [0, 0, 1]
    k = np.arange(RES) / (RES / (2 * extent))
    bounds = np.stack([k - extent + CENTER64[0], extent - k + CENTER64[1], 0 * k], axis=1)
    return np.concatenate([pts, np.asarray(edges), same, bounds]).astype(np.float32)


@pytest.mark.parametrize("point_px", [1, 3])
@pytest.mark.parametrize("center", ["float64", "float32"])
@pytest.mark.parametrize("color", ["height", "ids"])
def test_render_bev_bitwise(point_px, center, color):
    pts = _edge_cloud(12.0)
    c = CENTER64 if center == "float64" else tuple(pts[:, :2].mean(axis=0))
    ids = None if color == "height" else np.arange(len(pts)) % 13
    kw = dict(color_by=ids, extent=12.0, center=c, resolution=RES, point_px=point_px)
    got, want = PR.render_bev(pts, **kw), JR.render_bev(pts, **kw)
    assert got.dtype == np.uint8 and got.shape == (RES, RES, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != 16).any(axis=2)[0].any() and (got != 16).any(axis=2)[:, 0].any()
    if center == "float64":  # the cloud tells a float64 centre from a float32 one
        as32 = JR.render_bev(pts, **{**kw, "center": np.asarray(c, np.float32)})
        assert (as32 != want).any()


@pytest.mark.parametrize("shape", [(96, 96), (37, 211), (1, 1)])
def test_png_still_bitwise_against_cv2(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    img[: shape[0] // 2] = 16  # flat rows and random rows
    port = PR.save_image(tmp_path / "port.png", img)
    JR.save_image(tmp_path / "jax.png", img)
    want = _cv2_read(tmp_path / "jax.png")
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.read(port), want)
    np.testing.assert_array_equal(_pil_frames(port)[0], want)
    assert (tmp_path / "port.png").read_bytes() == png.encode(img)


def _label_mask(labels, resolution) -> np.ndarray:
    """Pixels of the concatenated panels inside either package's label box:
    cv2's from ``getTextSize`` (plus the stroke's thickness), the font's
    from ``text_box``, each clipped to its panel."""
    mask = np.zeros((resolution, resolution * len(labels)), bool)
    (x, y), thick = PR.LABEL_ORG, 2
    for k, label in enumerate(labels):
        (w, h), base = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.8, thick)
        top, left, bottom, right = font.text_box(label, PR.LABEL_ORG, PR.LABEL_SCALE)
        for t, l, b, r in ((y - h - thick, x - thick, y + base + thick, x + w + thick),
                           (top, left, bottom, right)):
            r = min(r, resolution)
            mask[max(t, 0):b, k * resolution + max(l, 0):k * resolution + r] = True
    return mask


def _check_panel(got, want, labels, resolution):
    mask = _label_mask(labels, resolution)
    assert mask[:, :resolution].sum() <= 40 * (12 + 16 * len(labels[0]) + 2)  # small boxes
    np.testing.assert_array_equal(got[~mask], want[~mask])
    for k, label in enumerate(labels):
        top, left, bottom, right = font.text_box(label, PR.LABEL_ORG, PR.LABEL_SCALE)
        box = got[top:bottom, k * resolution + left:k * resolution + min(right, resolution)]
        assert (box == 255).all(axis=2).any(), label


def test_instance_panel_outside_labels(synthetic_dataset):
    """``render_instance_panel`` at 240 px with a label longer than its panel
    (clipped at the panel's edge in both packages)."""
    from himo_tpu.data.dataset import SceneFlowDataset
    from himo_tpu.eval.pipeline import prepare_frame

    data = SceneFlowDataset(synthetic_dataset, vis_name="noisy")[0]
    frame = prepare_frame(data, "av2", res_name="noisy")
    pc = frame["xyz"][np.asarray(data["flow_instance_id"]) == 1]
    clouds = {"raw": pc, "a label longer than its panel": pc + 0.3, "gt": pc - 0.2}
    got = PR.render_instance_panel(clouds, extent=6.0, resolution=240)
    want = JR.render_instance_panel(clouds, extent=6.0, resolution=240)
    assert got.shape == want.shape == (240, 720, 3)
    _check_panel(got, want, list(clouds), 240)


@pytest.mark.parametrize("flow_mode", ["perfect", "noisy", "raw"])
def test_vis_refine_ins_files(synthetic_dataset, tmp_path, flow_mode, capsys):
    kw = dict(data_dir=str(synthetic_dataset), flow_mode=flow_mode, start_id=1,
              ins_id=[1, 2, 99], num_frames=2)
    got = PV.vis_refine_ins(out_dir=str(tmp_path / "port"), **kw)
    port_out = capsys.readouterr().out
    want = JV.vis_refine_ins(out_dir=str(tmp_path / "jax"), **kw)
    jax_out = capsys.readouterr().out
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    assert len(got) == 4
    assert port_out.replace("port", "jax") == jax_out
    labels = ["raw", f"{flow_mode} refined", "gt refined"]
    for g, w in zip(got, want):
        image = png.read(g)
        np.testing.assert_array_equal(_pil_frames(g)[0], image)
        _check_panel(image, _cv2_read(w), labels, 480)


class _RecordingWriter:
    """A stand-in for ``cv2.VideoWriter``: keeps the frames written."""

    made = []

    def __init__(self, path, fourcc, fps, size):
        self.args = (path, fourcc, fps, size)
        self.frames = []
        _RecordingWriter.made.append(self)

    def write(self, frame):
        self.frames.append(np.array(frame))

    def release(self):
        pass


@pytest.mark.parametrize("flow_mode,sample_step,view", [
    ("perfect", 1, None), ("raw", 2, "trajectory"), ("noisy", 1, "list")])
def test_animation_frames_bitwise(synthetic_dataset, tmp_path, monkeypatch, flow_mode,
                                  sample_step, view, capsys):
    view_file = ""
    if view:
        keys = JA.default_trajectory(3)
        for k in keys:
            k["lookat"] = [1.5, -2.0, 0.0]
            k["front"] = [float(v) for v in k["front"]]
            k["zoom"] = float(k["zoom"])
        spec = {"trajectory": keys} if view == "trajectory" else keys[1:]
        view_file = tmp_path / "view.json"
        view_file.write_text(json.dumps(spec))
    kw = dict(data_dir=str(synthetic_dataset), flow_mode=flow_mode, view_file=str(view_file),
              fps=7, resolution=RES, max_frames=5, sample_step=sample_step)
    monkeypatch.setattr(cv2, "VideoWriter", _RecordingWriter)
    _RecordingWriter.made.clear()
    JA.save_animation(output=str(tmp_path / "jax.mp4"), **kw)
    (writer,) = _RecordingWriter.made
    want = [f[:, :, ::-1] for f in writer.frames]  # the JAX package hands cv2 BGR
    out = PA.save_animation(output=str(tmp_path / "port.png"), **kw)
    assert out == str(tmp_path / "port.png")
    frames, delays = png.read_apng(out)
    assert len(frames) == len(want) == len(range(0, 5, sample_step))
    assert delays == [(1, 7)] * len(want)
    for got, pil, w in zip(frames, _pil_frames(out), want):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(pil, w)
    assert "Wrote animation to" in capsys.readouterr().out


def test_animation_refuses_a_video_name(synthetic_dataset, tmp_path):
    with pytest.raises(ValueError, match="APNG"):
        PA.save_animation(data_dir=str(synthetic_dataset), output=str(tmp_path / "a.mp4"))
    assert not (tmp_path / "a.mp4").exists()


@pytest.mark.parametrize("flow_mode", ["perfect", "noisy"])
@pytest.mark.parametrize("start_id", [0, 5])
def test_print_refine_ins_identical(synthetic_dataset, flow_mode, start_id, capsys):
    kw = dict(data_dir=str(synthetic_dataset), flow_mode=flow_mode, start_id=start_id,
              ins_id=[1, 2, 99])
    got = PV.print_refine_ins(**kw)
    port_out = capsys.readouterr().out
    want = JV.print_refine_ins(**kw)
    assert got == want and port_out == capsys.readouterr().out
    assert "ins_id 99: no points" in port_out and len(got[0]) == 2
    if flow_mode == "perfect":
        assert max(got[1]) < 1e-5 and "chamfer distance: 0.0000" in port_out


@pytest.mark.parametrize("color", ["lidar", "height", "flow"])
def test_visualize_main_files(synthetic_dataset, tmp_path, color, capsys):
    kw = dict(data_dir=str(synthetic_dataset), flow_mode="noisy", color=color, start_id=2,
              num_frames=3, extent=30.0, resolution=RES)
    got = PZ.main(out_dir=str(tmp_path / "port"), **kw)
    want = JZ.main(out_dir=str(tmp_path / "jax"), **kw)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    assert len(got) == 3 and all(p.endswith("_noisy.png") for p in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(png.read(g), _cv2_read(w))
    capsys.readouterr()


@pytest.mark.parametrize("num_key,sample_step", [(2, 1), (4, 3), (5, 10)])
def test_trajectories_identical(num_key, sample_step):
    keys = PA.default_trajectory(num_key)
    assert keys == JA.default_trajectory(num_key)
    got = PA.interpolate_trajectory(keys, sample_step)
    assert got == JA.interpolate_trajectory(keys, sample_step)
    assert len(got) == num_key * sample_step - (sample_step - 1)


class _RecordingAxes:
    """A matplotlib ``Axes`` stand-in: records every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return name
        return call


def _same_calls(a, b):
    assert [(n, sorted(k)) for n, _, k in a] == [(n, sorted(k)) for n, _, k in b]
    for (_, a_args, a_kw), (_, b_args, b_kw) in zip(a, b):
        for x, y in zip((*a_args, *a_kw.values()), (*b_args, *b_kw.values())):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("speed", [20.0, 7.5])
@pytest.mark.parametrize("compensated", [False, True])
def test_schematic_arrays_bitwise(speed, compensated):
    jax_ax, port_ax = _RecordingAxes(), _RecordingAxes()
    JS.sweep_figure(jax_ax, speed, compensated)
    PS.sweep_figure(port_ax, speed, compensated)
    _same_calls(port_ax.calls, jax_ax.calls)
    d = PS.sweep_arrays(speed, compensated)
    (_, (x, y), kw), (_, (tx, ty, style), _) = jax_ax.calls[:2]
    for got, want in ((d["points"][:, 0], x), (d["points"][:, 1], y), (d["dts"], kw["c"]),
                      (d["truth"][:, 0], tx), (d["truth"][:, 1], ty)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert jax_ax.calls[-1] == ("set_title", (d["title"],), {"fontsize": 10})
    np.testing.assert_array_equal(d["outline"], JS._box_outline((10.0, 0.0), (4.5, 2.0), n=30))


def test_schematic_figure_and_plasma(tmp_path, capsys):
    import matplotlib

    from himo_tpu_torch.viz.plasma import PLASMA

    np.testing.assert_array_equal(np.asarray(PLASMA), matplotlib.colormaps["plasma"].colors)
    t = np.array([0.0, 0.3, 0.999, 1.0])
    np.testing.assert_array_equal(
        PS.plasma_rgb(t), matplotlib.colormaps["plasma"](t, bytes=True)[:, :3])
    path = PS.main(out_dir=str(tmp_path / "fig"))
    assert path.endswith("rolling_shutter.png") and f"Wrote {path}" in capsys.readouterr().out
    image = png.read(path)
    np.testing.assert_array_equal(image, PS.render_figure())
    assert image.shape == (*PS.FIG_SHAPE, 3)
    d = PS.sweep_arrays(20.0, False)
    colors = {tuple(c) for c in PS.plasma_rgb((d["dts"] - d["dts"].min()) / np.ptp(d["dts"]))}
    top, left, bottom, right = PS._panel_box(PS.PANEL_LEFTS[0])
    drawn = {tuple(c) for c in image[top:bottom, left:right].reshape(-1, 3)}
    assert len(colors & drawn) >= 0.8 * len(colors)  # discs overlap: later ones cover
    assert (PS.TRUTH_GRAY,) * 3 in drawn


class _MockVis:
    """open3d's ``VisualizerWithKeyCallback`` stand-in: logs every call;
    ``poll_events`` presses the next key of ``script`` (then reports the
    window closed once the script is spent)."""

    script = []

    def __init__(self):
        self.log, self.keys, self.ctl = [], {}, _MockCtl(self)
        self.script = list(_MockVis.script)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self.log.append((name, args, tuple(sorted(kwargs.items()))))
        return call

    def register_key_callback(self, key, cb):
        self.log.append(("register_key_callback", (key,), ()))
        self.keys[key] = cb

    def poll_events(self):
        self.log.append(("poll_events", (), ()))
        if not self.script:
            return False
        self.keys[self.script.pop(0)](self)
        return True

    def get_view_control(self):
        self.log.append(("get_view_control", (), ()))
        return self.ctl

    def get_render_option(self):
        return self


class _MockCtl:
    def __init__(self, vis):
        self.vis = vis

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self.vis.log.append(("ctl." + name, args, tuple(sorted(kwargs.items()))))
            return {"cam": 1}
        return call


def _mock_o3d(log):
    def io_call(name):
        return lambda *args: log.append(("io." + name, args, ())) or {"cam": "file"}

    vis_mod = types.SimpleNamespace(VisualizerWithKeyCallback=_MockVis)
    io_mod = types.SimpleNamespace(write_pinhole_camera_parameters=io_call("write"),
                                   read_pinhole_camera_parameters=io_call("read"))
    return types.SimpleNamespace(visualization=vis_mod, io=io_mod)


@pytest.mark.parametrize("view", [None, "simple", "pinhole"])
def test_my_visualizer_call_logs(tmp_path, monkeypatch, view):
    view_file = None
    if view:
        view_file = tmp_path / "view.json"
        spec = ({"front": [0, 0, 1], "lookat": [1, 2, 3], "up": [0, 1, 0], "zoom": 0.5}
                if view == "simple" else {"intrinsic": {}, "extrinsic": []})
        view_file.write_text(json.dumps(spec))
        view_file = str(view_file)
    monkeypatch.setattr(_MockVis, "script", [PO._KEY_V, PO._KEY_N, PO._KEY_SPACE])
    logs = []
    for mod in (JO, PO):
        log = []
        v = mod.MyVisualizer(view_file=view_file, window_title="t", o3d=_mock_o3d(log))
        steps = [v.update(["pcd", "axes"]),           # paused: V, then N steps one frame
                 v.update(["pcd"]),                   # SPACE: playing
                 v.update(["pcd"], wait=False),
                 v.vis.keys[PO._KEY_SPACE](v.vis),    # pause again
                 v.update(["pcd"]),                   # the script is spent: closed
                 v.update(["pcd"])]
        v.destroy()
        logs.append((steps, v.vis.log, log, v.playing))
    assert logs[0] == logs[1]
    assert logs[1][0] == [True, True, True, False, False, False]


@pytest.mark.parametrize("view", [None, "simple", "pinhole"])
def test_my_visualizer_with_test_viz_mock(tmp_path, view):
    """Both packages' viewers on ``tests/test_viz.py``'s own mock ``o3d``
    (its ``poll_events`` never closes, so playback starts first): the same
    key sequence, the same view-control calls, geometries, polls, title
    and saved viewpoints."""
    from test_viz import TestO3DViewer

    view_file = None
    if view:
        view_file = tmp_path / "view.json"
        spec = ({"front": [0, 0, 1], "zoom": 0.5} if view == "simple"
                else {"intrinsic": {}, "extrinsic": []})
        view_file.write_text(json.dumps(spec))
        view_file = str(view_file)
    logs = []
    for mod in (JO, PO):
        fake = TestO3DViewer()._fake_o3d()
        v = mod.MyVisualizer(view_file=view_file, o3d=fake)
        steps = []
        for key, geoms in ((mod._KEY_SPACE, ["pcd", "axes"]), (mod._KEY_V, ["pcd"]),
                           (mod._KEY_RIGHT, ["axes"]), (mod._KEY_Q, ["pcd"])):
            v.vis.keys[key](v.vis)
            steps.append((v.update(geoms), list(v.vis.geoms), v.playing))
        logs.append((steps, v.vis.ctl.calls, v.vis.polls, v.vis.title, fake._written,
                     sorted(v.vis.keys)))
    assert logs[0] == logs[1]
    assert [s[0] for s in logs[1][0]] == [True, True, True, False]


class _PointCloud:
    pass


def _mock_open3d(captured):
    def vector(arr):
        captured.append(np.array(arr))
        return ("vector", len(captured) - 1)

    fake = _mock_o3d([])
    fake.geometry = types.SimpleNamespace(
        PointCloud=_PointCloud,
        TriangleMesh=types.SimpleNamespace(create_coordinate_frame=lambda size: ("axes", size)))
    fake.utility = types.SimpleNamespace(Vector3dVector=vector)
    return fake


@pytest.mark.parametrize("flow_mode,instance_ids", [
    ("perfect", None), ("noisy", [1]), ("raw", [99])])
def test_view_dataset_geometry(synthetic_dataset, monkeypatch, flow_mode, instance_ids):
    """Both packages' ``view_dataset`` with a mock ``open3d`` in
    ``sys.modules`` (SPACE pressed at the first poll, so no frame blocks):
    the same ``Vector3dVector`` arrays, frame by frame."""
    monkeypatch.setattr(_MockVis, "script", [PO._KEY_SPACE])
    captured = {}
    for name, mod in (("jax", JO), ("port", PO)):
        captured[name] = []
        monkeypatch.setitem(sys.modules, "open3d", _mock_open3d(captured[name]))
        mod.view_dataset(str(synthetic_dataset), flow_mode=flow_mode, start_id=1,
                         instance_ids=instance_ids)
    got, want = captured["port"], captured["jax"]
    assert len(got) == len(want) >= 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if instance_ids == [99]:
        assert all(len(g) == 0 for g in got)


def test_png_readers_refuse_foreign_files(tmp_path):
    """``read`` and ``read_apng`` take what the writers emit and raise on
    anything else: cv2's and PIL's filters, grayscale, a bad CRC, a
    truncated file, another format, a still for an animation and back."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    Image.fromarray(img).save(tmp_path / "pil.png")
    Image.fromarray(img[:, :, 0]).save(tmp_path / "gray.png")
    good = png.encode(img)
    (tmp_path / "crc.png").write_bytes(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    (tmp_path / "short.png").write_bytes(good[:-20])
    (tmp_path / "jpeg.png").write_bytes(b"\xff\xd8\xff\xe0" + good[4:])
    png.write(tmp_path / "still.png", img)
    with png.APNGWriter(tmp_path / "anim.png", 10, 24, 32) as w:
        w.write(img)
        w.write(img[::-1].copy())
    for name in ("cv2", "pil", "gray", "crc", "short", "jpeg", "anim"):
        with pytest.raises(ValueError):
            png.read(tmp_path / f"{name}.png")
    with pytest.raises(ValueError, match="still"):
        png.read_apng(tmp_path / "still.png")
    np.testing.assert_array_equal(png.read(tmp_path / "still.png"), img)
    frames, _ = png.read_apng(tmp_path / "anim.png")
    np.testing.assert_array_equal(frames[1], img[::-1])
    with pytest.raises(ValueError, match="at least one frame"):
        png.APNGWriter(tmp_path / "empty.png", 10, 4, 4).close()
    with pytest.raises(ValueError):
        png.encode(img.astype(np.float32))
