"""Port parity: compensation math, de-skew, synthetic clouds, the kernel
build helper, and import isolation (the port must not import JAX).

Inputs come from seeded numpy and are cast to float32 explicitly (the test
session enables JAX x64, and float64 inputs would change the JAX side).
Tolerance for the float math: atol 1e-6 (float32 on both sides, same
formulas; only matmul summation order may differ)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.core import compensation as JC
from himo_tpu.core import deskew as JD
from himo_tpu_torch.core import compensation as PC
from himo_tpu_torch.core import deskew as PD

ATOL = 1e-6
REPO = Path(__file__).resolve().parents[1]


def _pose(rng):
    a = rng.uniform(-0.3, 0.3)
    rot = np.array(
        [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0, 0, 1]]
    )
    pose = np.eye(4)
    pose[:3, :3] = rot
    pose[:3, 3] = rng.uniform(-5, 5, 3)
    return pose.astype(np.float32)


@pytest.fixture()
def frame_data():
    rng = np.random.default_rng(7)
    n = 700
    return dict(
        pc0=rng.uniform(-40, 40, size=(n, 3)).astype(np.float32),
        lidar_dt=rng.uniform(0, 0.1, n).astype(np.float32),
        valid=rng.uniform(size=n) > 0.1,
        pose0=_pose(rng),
        pose1=_pose(rng),
        flow=rng.normal(0, 1.0, size=(n, 3)).astype(np.float32),
        ground=rng.uniform(size=n) > 0.7,
    )


def test_compensation_functions_match_jax(frame_data):
    d = frame_data
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    np.testing.assert_allclose(
        PC.flow_to_comp_dis(t["flow"], t["lidar_dt"]).numpy(),
        np.asarray(JC.flow_to_comp_dis(j["flow"], j["lidar_dt"])),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        PC.refine_points(t["pc0"], t["flow"]).numpy(),
        np.asarray(JC.refine_points(j["pc0"], j["flow"])),
        atol=ATOL,
    )
    for box in (JC.SCANIA_EGO_BOX, JC.AV2_EGO_BOX):
        np.testing.assert_array_equal(
            PC.ego_points_mask(t["pc0"] / 10.0, *box).numpy(),
            np.asarray(JC.ego_points_mask(j["pc0"] / 10.0, *box)),
        )
    rot_p, t_p = PC.relative_se3(t["pose0"], t["pose1"])
    rot_j, t_j = JC.relative_se3(j["pose0"], j["pose1"])
    np.testing.assert_allclose(rot_p.numpy(), np.asarray(rot_j), atol=ATOL)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=ATOL * 10)
    # |pc0| up to 40 m: 1e-6 relative to the coordinates.
    np.testing.assert_allclose(
        PC.pose_flow(t["pc0"], t["pose0"], t["pose1"]).numpy(),
        np.asarray(JC.pose_flow(j["pc0"], j["pose0"], j["pose1"])),
        atol=ATOL * 40,
    )
    for valid in (None, "valid"):
        pv = None if valid is None else t["valid"]
        jv = None if valid is None else j["valid"]
        np.testing.assert_allclose(
            PC.dt0_from_lidar_dt(t["lidar_dt"], pv).numpy(),
            np.asarray(JC.dt0_from_lidar_dt(j["lidar_dt"], jv)),
            atol=ATOL,
        )


def test_batched_compensation_equals_per_frame(frame_data):
    d = frame_data
    pc = torch.from_numpy(np.stack([d["pc0"], d["pc0"][::-1].copy()]))
    p0 = torch.from_numpy(np.stack([d["pose0"], d["pose1"]]))
    p1 = torch.from_numpy(np.stack([d["pose1"], d["pose0"]]))
    out = PC.pose_flow(pc, p0, p1)
    for b in range(2):
        torch.testing.assert_close(
            out[b], PC.pose_flow(pc[b], p0[b], p1[b]), atol=ATOL * 40, rtol=0
        )


@pytest.mark.parametrize("dataset", ["av2", "scania"])
def test_deskew_frame_matches_jax(frame_data, dataset):
    d = frame_data
    args = ("pc0", "lidar_dt", "valid", "pose0", "pose1", "flow", "ground")
    rj = JD.deskew_frame(*(jnp.asarray(d[k]) for k in args), dataset=dataset)
    rp = PD.deskew_frame(
        *(torch.from_numpy(np.asarray(d[k])) for k in args), dataset=dataset
    )
    for name in ("comp_dis", "refined", "motion_flow", "dt0"):
        np.testing.assert_allclose(
            getattr(rp, name).numpy(), np.asarray(getattr(rj, name)),
            atol=ATOL * 40, err_msg=name,
        )
    np.testing.assert_array_equal(rp.eval_mask.numpy(), np.asarray(rj.eval_mask))


def test_deskew_batch_matches_jax_vmap(frame_data):
    d = frame_data
    args = ("pc0", "lidar_dt", "valid", "pose0", "pose1", "flow", "ground")
    stacked = {k: np.stack([d[k], d[k]]) for k in args}
    stacked["pose1"] = np.stack([d["pose1"], d["pose0"]])
    rj = JD.deskew_batch(*(jnp.asarray(stacked[k]) for k in args))
    rp = PD.deskew_batch(*(torch.from_numpy(stacked[k]) for k in args))
    np.testing.assert_allclose(
        rp.refined.numpy(), np.asarray(rj.refined), atol=ATOL * 40
    )
    np.testing.assert_array_equal(rp.eval_mask.numpy(), np.asarray(rj.eval_mask))


def test_lidar_like_cloud_identical_to_bench():
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    from himo_tpu_torch.data.synthetic import lidar_like_cloud

    a = bench.lidar_like_cloud(np.random.default_rng(3), 2, 4096)
    b = lidar_like_cloud(np.random.default_rng(3), 2, 4096)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


BANNED_ROOTS = ("jax", "jaxlib", "flax", "optax", "himo_tpu", "h5py", "orbax", "sklearn",
                "pandas", "pyarrow", "tqdm", "tabulate", "yaml", "cv2", "matplotlib",
                "open3d", "PIL", "imageio")


# Imports allowed inside a function of one module only: the interactive
# open3d window (it needs a display; no path on the card opens it).
LAZY_OPTIONAL = {"himo_tpu_torch/viz/o3d_view.py": ("open3d",)}


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax, flax,
    optax, himo_tpu, or the host libraries the GPU host lacks (h5py,
    orbax, sklearn, pandas, pyarrow, tqdm, tabulate, PyYAML, cv2,
    matplotlib, open3d, PIL, imageio). ``import torch`` itself may
    load some of the latter (some builds load tqdm), so at run
    time only modules beyond torch's own count, and every import statement
    of the port's sources is checked as well."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch\n"
        "torch_own = set(sys.modules)\n"
        "import himo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "himo_tpu_torch.__path__, 'himo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in set(sys.modules) - torch_own if m.split('.')[0] in "
        f"{BANNED_ROOTS!r})\n"
        "bad += sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'himo_tpu'))\n"
        "assert not bad, bad\n"
        "for name in ('core.transforms', 'training.losses', 'training.trainer',\n"
        "             'ops.knn', 'ops.dt', 'models.coordinate_mlp', 'models.opt_loop',\n"
        "             'models.nsfp', 'models.fastnsf', 'ops.mxu_scatter', 'data.h5',\n"
        "             'data.dataset', 'data.index', 'training.checkpoints', 'utils.cli',\n"
        "             'cli.train', 'training.clustering', 'training.ssl_labels',\n"
        "             'models.icp_flow', 'cli.ssl_label', 'native', 'utils.profiling',\n"
        "             'models.runner', 'parallel.fleet', 'eval.chamfer', 'eval.pipeline',\n"
        "             'eval.instance_metrics', 'eval.flow_metrics', 'cli.save', 'cli.eval',\n"
        "             'cli.eval_flow', 'eval.seg', 'cli.eval_seg', 'downstream',\n"
        "             'downstream.segmentation', 'downstream.detection', 'downstream.det_net',\n"
        "             'cli.seg_h5', 'cli.det_h5', 'io', 'io.arrow', 'io.lz4',\n"
        "             'io.submission', 'eval.score', 'cli.save_zip', 'cli.save_zip_gt',\n"
        "             'cli.score', 'cli.pkl_extract', 'cli.repack_h5',\n"
        "             'ops.points_in_boxes', 'ops.ground', 'io.yaml_lite', 'data.av2',\n"
        "             'data.scania', 'cli.extract_av2', 'cli.extract_scania',\n"
        "             'parallel.mesh', 'parallel.multihost', 'entry', 'viz', 'viz.png',\n"
        "             'viz.font', 'viz.plasma', 'viz.render', 'viz.view_instance',\n"
        "             'viz.visualize', 'viz.animation', 'viz.schematic', 'viz.o3d_view'):\n"
        "    assert 'himo_tpu_torch.' + name in names, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 93
    import ast

    for path in [*sorted((REPO / "himo_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        in_functions = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                        for n in ast.walk(f)}
        optional = LAZY_OPTIONAL.get(path.relative_to(REPO).as_posix(), ())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            banned = set(roots) & set(BANNED_ROOTS)
            if id(node) in in_functions:
                banned -= set(optional)
            assert not banned, (path, node.lineno, roots)


def test_build_library_name_tracks_source_content(tmp_path, monkeypatch):
    from himo_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build._library_path("k")
    assert first.parent == tmp_path / "_build" and first.name.startswith("k-")
    assert _build._library_path("k") == first
    src.write_text("// two\n")
    assert _build._library_path("k") != first
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "k")
    _build.check(0, "k")


def test_build_load_binds_every_callers_signatures(tmp_path, monkeypatch):
    """Two entry points of one library: the library is opened once, each
    entry point gets its own argtypes (an entry point left without them
    would pass its pointers as 32-bit ints) with the stream last, once;
    every launch passes the current raw stream and raises on a CUDA
    error."""
    import ctypes

    from himo_tpu_torch.kernels import _build

    opened, calls = [], []

    class FakeFn:
        def __call__(self, *args):
            calls.append(args)
            return 9 if args[0] == 99 else 0

    class FakeLib:
        def __init__(self, path):
            opened.append(path)
            self.a, self.b = FakeFn(), FakeFn()

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    current = [0]
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current[0], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_setDevice", lambda i: current.__setitem__(0, i),
                        raising=False)
    a = _build.Entry("k", "a", (_build.PTR, _build.INT))
    b = _build.Entry("k", "b", (_build.PTR, _build.PTR, _build.INT))
    a.launch(0, 5, 6)
    b.launch(2, 7, 8, 9)
    fn_a = a.bind()
    fn_a.argtypes = None  # a second launch does not bind again
    a.launch(0, 1, 2)
    assert len(opened) == 1 and fn_a.argtypes is None
    assert b.bind().argtypes == [_build.PTR, _build.PTR, _build.INT, _build.PTR]
    assert fn_a.restype is b.bind().restype is ctypes.c_int
    assert calls == [(5, 6, 1000), (7, 8, 9, 1002), (1, 2, 1000)]
    with pytest.raises(RuntimeError, match="a: CUDA error 9"):
        a.launch(0, 99, 0)


@pytest.mark.parametrize("case", ["other device", "other device, call raises",
                                  "other device, CUDA error", "current device"])
def test_entry_launch_runs_on_the_tensors_device(monkeypatch, case):
    """A ``<<<>>>`` launch goes to the calling thread's current device, so
    ``Entry.launch(i, ...)`` makes device ``i`` current for the C call when
    it is not, and restores the previous device afterwards: after a normal
    return, when the call raises, and when it returns a CUDA error. When
    ``i`` is already current, no device is set. The device getter and
    setter, the stream and the bound function are stubs."""
    import ctypes
    import types

    from himo_tpu_torch.kernels import _build

    current = [1 if case == "current device" else 0]
    sets, seen = [], []

    def set_device(i):
        sets.append(i)
        current[0] = i

    class FakeFn:
        def __call__(self, *args):
            seen.append((current[0], args))
            if case == "other device, call raises":
                raise ctypes.ArgumentError("bad argument")
            return 2 if case == "other device, CUDA error" else 0

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current[0], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_setDevice", set_device, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 700 + i,
                        raising=False)
    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(k=FakeFn()))
    entry = _build.Entry("src", "k", (_build.PTR, _build.INT))
    if case == "other device, call raises":
        with pytest.raises(ctypes.ArgumentError):
            entry.launch(1, 5, 6)
    elif case == "other device, CUDA error":
        with pytest.raises(RuntimeError, match="k: CUDA error 2"):
            entry.launch(1, 5, 6)
    else:
        entry.launch(1, 5, 6)
    assert seen == [(1, (5, 6, 701))]  # device 1 current in the call, its stream
    assert current[0] == (1 if case == "current device" else 0)
    assert sets == ([] if case == "current device" else [1, 0])


def _port_entries():
    """Every kernel entry point the port declares: each ``_build.Entry`` at
    the top level of a ``himo_tpu_torch`` module, by its C name."""
    import importlib
    import pkgutil

    import himo_tpu_torch
    from himo_tpu_torch.kernels import _build

    entries = {}
    for mod in pkgutil.walk_packages(himo_tpu_torch.__path__, "himo_tpu_torch."):
        for value in vars(importlib.import_module(mod.name)).values():
            if isinstance(value, _build.Entry):
                entries[value.name] = value
    return dict(sorted(entries.items()))


def _c_signature(source: str, name: str) -> list:
    """The parameters of ``extern "C" int name(...)`` in ``csrc/<source>.cu``,
    each as written (``const void* spids``)."""
    import re

    text = (REPO / "himo_tpu_torch" / "csrc" / f"{source}.cu").read_text()
    found = re.findall(r'extern "C" int\s+' + name + r"\s*\(([^)]*)\)", text)
    assert len(found) == 1, f"{source}.cu defines {name} {len(found)} times"
    return [" ".join(p.split()) for p in found[0].split(",")]


@pytest.mark.parametrize("name", list(_port_entries()))
def test_entry_argtypes_match_the_c_signature(name):
    """Each entry point's ctypes argtypes against its C signature: one per
    parameter, a pointer for each pointer and an int for each int, the
    stream last. A mismatch would pass a wrong pointer or cut one on the
    card; here it fails on the CPU."""
    from himo_tpu_torch.kernels import _build

    entry = _port_entries()[name]
    params = _c_signature(entry.source, name)
    assert len(entry.argtypes) == len(params), params
    kinds = {"const void*": _build.PTR, "void*": _build.PTR, "int": _build.INT}
    for param, argtype in zip(params, entry.argtypes):
        assert kinds[param.rsplit(" ", 1)[0]] is argtype, (param, argtype)
    assert params[-1] == "void* stream" and entry.argtypes[-1] is _build.PTR


@pytest.mark.parametrize("case", ["fp64 values", "int64 ids", "non-contiguous values",
                                  "non-contiguous ids", "mixed devices"])
def test_launch_checks_refuse_what_the_kernels_do_not_take(case):
    """The launch helper's shared argument check, and the row and gather
    wrappers' checks built on it, called on CPU tensors: each refuses the
    input with a TypeError (dtype) or a ValueError (layout, device)."""
    from himo_tpu_torch.kernels import _build
    from himo_tpu_torch.ops import voxelize as PV

    vals = torch.zeros(2, 10, 3)
    ids = torch.zeros(2, 10, dtype=torch.int32)
    image = torch.zeros(2, 7, 3)
    _build.check_args("k", f32=(vals,), i32=(ids,))
    PV._check_rows_args("k", ids, vals)
    PV._check_gather_args("k", image, ids, ids)
    bad_vals, bad_ids, error = {
        "fp64 values": (vals.double(), ids, TypeError),
        "int64 ids": (vals, ids.long(), TypeError),
        "non-contiguous values": (torch.zeros(2, 3, 10).transpose(1, 2), ids, ValueError),
        "non-contiguous ids": (vals, torch.zeros(10, 2, dtype=torch.int32).T, ValueError),
        "mixed devices": (vals, ids.to("meta"), ValueError),
    }[case]
    with pytest.raises(error):
        _build.check_args("k", f32=(bad_vals,), i32=(bad_ids,))
    with pytest.raises(error):
        PV._check_rows_args("k", bad_ids, bad_vals)
    with pytest.raises(error):
        PV._check_gather_args("k", bad_vals, bad_ids)


def test_launch_checks_refuse_mismatched_shapes():
    from himo_tpu_torch.ops import nn as PNN
    from himo_tpu_torch.ops import voxelize as PV

    vals = torch.zeros(2, 10, 3)
    with pytest.raises(ValueError, match="shapes"):
        PV._check_rows_args("k", torch.zeros(2, 9, dtype=torch.int32), vals)
    with pytest.raises(ValueError, match="shapes"):
        PV._check_rows_args("k", torch.zeros(2, 10, dtype=torch.int32), vals[0])
    with pytest.raises(ValueError, match="shapes"):
        PV._check_gather_args("k", vals, torch.zeros(3, 10, dtype=torch.int32))
    with pytest.raises(ValueError, match="shapes"):
        PV._check_gather_args("k", vals, torch.zeros(2, 10, dtype=torch.int32),
                              torch.zeros(2, 9, dtype=torch.int32))
    with pytest.raises(ValueError, match="shapes"):
        PNN._check_clouds(vals, torch.zeros(2, 10, 4))
    with pytest.raises(ValueError):
        PNN._check_clouds(vals, torch.zeros(3, 10, 3))
    with pytest.raises(TypeError):
        PNN._check_clouds(vals, torch.zeros(2, 10, 3), torch.zeros(2, 10).double())
