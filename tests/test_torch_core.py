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


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax, flax or
    himo_tpu (the GPU host has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import himo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "himo_tpu_torch.__path__, 'himo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'himo_tpu'))\n"
        "assert not bad, bad\n"
        "for name in ('core.transforms', 'training.losses', 'training.trainer'):\n"
        "    assert 'himo_tpu_torch.' + name in names, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 16


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
    """Two modules bind different entry points of one library: the library
    is opened once, and each call's argtypes are set (an entry point left
    without them would pass its pointers as 32-bit ints)."""
    import ctypes

    from himo_tpu_torch.kernels import _build

    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)
            self.a = type("Fn", (), {})()
            self.b = type("Fn", (), {})()

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_BOUND", set())
    monkeypatch.setattr(_build, "build", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    first = _build.load("k", {"a": (_build.PTR, _build.INT)})
    second = _build.load("k", {"b": (_build.PTR, _build.PTR, _build.INT)})
    assert first is second and len(opened) == 1
    assert first.a.argtypes == [_build.PTR, _build.INT]
    assert first.b.argtypes == [_build.PTR, _build.PTR, _build.INT]
    assert first.a.restype is first.b.restype is ctypes.c_int
