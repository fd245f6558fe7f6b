"""The port's public API against the JAX package's, on the CPU:
``core.evaluation_mask`` bitwise against JAX's (both datasets, with and
without ``flow_is_valid`` and ``valid``, points on the 35 m circle and one
ulp either side of it, points on every face of both ego boxes), the
float32 fused multiply-add it rounds the range with, ``deskew_frame``'s
mask through it, the seven subpackages' re-exports name for name, and the
whole package's public names, read by AST from both sources. Importing the
subpackages builds no kernel, loads no library and starts no CUDA."""

import ast
import importlib
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from himo_tpu.core import compensation as JC
from himo_tpu.core import deskew as JD
from himo_tpu_torch.core import compensation as PC
from himo_tpu_torch.core import deskew as PD

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("core", "data", "eval", "models", "ops", "parallel", "utils")
F32 = np.float32


def _toward(a, direction):
    """``a`` moved one float32 ulp away from zero (+1) or toward it (-1)."""
    return np.nextafter(a, np.where(a < 0, F32(-direction * np.inf),
                                    F32(direction * np.inf))).astype(F32)


def _circle_points(rng, n):
    """Points on the 35 m circle as float32 rounds them, and the same
    points with x or y one ulp farther out or nearer in."""
    th = rng.uniform(0, 2 * np.pi, n)
    x = (F32(35.0) * np.cos(th)).astype(F32)
    y = (F32(35.0) * np.sin(th)).astype(F32)
    axes = [(F32(35.0), F32(0.0)), (F32(0.0), F32(-35.0)), (F32(-35.0), F32(0.0))]
    x = np.concatenate([x, [a for a, _ in axes]]).astype(F32)
    y = np.concatenate([y, [b for _, b in axes]]).astype(F32)
    out = [(x, y)]
    for direction in (-1, 1):
        out.append((_toward(x, direction), y))
        out.append((x, _toward(y, direction)))
    return np.concatenate([np.stack([a, b], 1) for a, b in out]).astype(F32)


def _box_face_points(rng, box, n=40):
    """Points on each of the six faces of ``box``, inside its other two
    extents, and one ulp either side of the face. Next to a face at 0 the
    step is the smallest normal float32: XLA on the CPU flushes subnormal
    inputs to zero, the port keeps them (a declared difference no LiDAR
    coordinate reaches)."""
    lo, hi = np.asarray(box[0], F32), np.asarray(box[1], F32)
    tiny = np.finfo(F32).tiny
    pts = []
    for axis in range(3):
        for bound in (lo[axis], hi[axis]):
            p = rng.uniform(lo, hi, (n, 3)).astype(F32)
            below, above = ((-tiny, tiny) if bound == 0 else
                            (np.nextafter(bound, F32(-np.inf)), np.nextafter(bound, F32(np.inf))))
            for value in (bound, below, above):
                q = p.copy()
                q[:, axis] = value
                pts.append(q)
    return np.concatenate(pts).astype(F32)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    circle = _circle_points(rng, 4000)
    circle = np.concatenate([circle, rng.uniform(-3, 6, (len(circle), 1))], 1)
    parts = [
        rng.uniform(-60, 60, (4000, 3)),
        circle,
        _box_face_points(rng, JC.AV2_EGO_BOX),
        _box_face_points(rng, JC.SCANIA_EGO_BOX),
        [[np.nan, 0, 0], [np.inf, 0, 0], [0, -np.inf, 1], [0, 0, np.nan]],
    ]
    pc = np.concatenate([np.asarray(p, F32) for p in parts]).astype(F32)
    n = len(pc)
    return dict(
        pc=pc,
        ground=rng.uniform(size=n) < 0.1,
        flow_is_valid=rng.uniform(size=n) < 0.8,
        valid=rng.uniform(size=n) < 0.9,
    )


@pytest.mark.parametrize("dataset", ["av2", "scania"])
@pytest.mark.parametrize("with_flow_valid", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_evaluation_mask_matches_jax(cloud, dataset, with_flow_valid, with_valid):
    fv = cloud["flow_is_valid"] if with_flow_valid else None
    va = cloud["valid"] if with_valid else None
    want = np.asarray(JC.evaluation_mask(
        jnp.asarray(cloud["pc"]), jnp.asarray(cloud["ground"]),
        None if fv is None else jnp.asarray(fv), dataset=dataset,
        valid=None if va is None else jnp.asarray(va)))
    got = PC.evaluation_mask(
        torch.from_numpy(cloud["pc"]), torch.from_numpy(cloud["ground"]),
        None if fv is None else torch.from_numpy(fv), dataset=dataset,
        valid=None if va is None else torch.from_numpy(va))
    assert got.dtype == torch.bool and got.shape == (len(cloud["pc"]),)
    np.testing.assert_array_equal(got.numpy(), want)
    # Every rule decides somewhere in the cloud: some points are in, and
    # the range, the ego box and the masks each take some out.
    assert 0.2 < want.mean() < 0.9


def test_evaluation_mask_range_rounds_as_jax_norm():
    """On the 35 m circle JAX's ``jnp.linalg.norm`` is ``sqrt(fma(y, y,
    x * x))`` in float32, which the port follows; the plain ``sqrt(x * x +
    y * y)`` (``deskew_frame``'s former inline mask) lands on the other side
    of 35 m for some of these points."""
    pts = _circle_points(np.random.default_rng(1), 4000)
    xy = jnp.asarray(pts)
    jax_in = np.asarray(jnp.linalg.norm(xy, axis=-1)) <= 35.0
    plain_in = np.sqrt((pts * pts).sum(-1)) <= 35.0
    pc = torch.from_numpy(np.concatenate([pts, np.zeros((len(pts), 1), F32)], 1))
    got = PC.evaluation_mask(pc, torch.zeros(len(pts), dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), jax_in)
    assert (plain_in != jax_in).sum() > 20
    assert 0.5 < jax_in.mean() < 0.99


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16])
def test_evaluation_mask_takes_float32_only(dtype):
    """The range's rounding is JAX's for float32 only, so another dtype is
    refused rather than given a second formula."""
    pc = torch.zeros(4, 3, dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        PC.evaluation_mask(pc, torch.zeros(4, dtype=torch.bool))


def _fraction_to_f32(value: Fraction) -> np.float32:
    """``value`` rounded to the nearest float32, ties to even."""
    guess = np.float32(float(value))
    cands = [np.nextafter(guess, F32(-np.inf)), guess, np.nextafter(guess, F32(np.inf))]
    dist = [abs(Fraction(float(c)) - value) for c in cands]
    best = min(dist)
    tied = [c for c, d in zip(cands, dist) if d == best]
    if len(tied) == 1:
        return tied[0]
    return next(c for c in tied if int(np.array(c).view(np.uint32)) % 2 == 0)


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(2)
    a = rng.uniform(-50, 50, 300).astype(F32)
    b = rng.uniform(-50, 50, 300).astype(F32)
    c = (rng.uniform(-1, 1, 300) * 10.0 ** rng.integers(-8, 4, 300)).astype(F32)
    # A sum that float64 rounds onto a float32 halfway point: the exact
    # value lies just below it, so ties-to-even of the float64 sum would
    # round up (1 + 2^-23 is odd) where one rounding stays at c.
    a = np.append(a, F32((2 - 2 ** -22) * 2 ** -25))
    b = np.append(b, F32(1 + 2 ** -23))
    c = np.append(c, F32(1 + 2 ** -23))
    got = PC._fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_fraction_to_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], F32)
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(F32)
    assert got[-1] == c[-1] and naive[-1] != c[-1]


def test_deskew_mask_goes_through_evaluation_mask(cloud):
    """``deskew_frame``'s mask is ``evaluation_mask`` of its cloud: bitwise
    the inline mask it replaced wherever the float32 range is not on the
    35 m circle, and JAX's ``deskew_frame`` mask everywhere."""
    rng = np.random.default_rng(3)
    pc = cloud["pc"]
    n = len(pc)
    pc = np.where(np.isfinite(pc), pc, 0).astype(F32)
    lidar_dt = rng.uniform(0, 0.1, n).astype(F32)
    pose = np.eye(4)
    flow = rng.normal(0, 0.5, (n, 3)).astype(F32)
    for dataset in ("av2", "scania"):
        args = (pc, lidar_dt, cloud["valid"], pose, pose, flow, cloud["ground"])
        got = PD.deskew_frame(*(torch.from_numpy(np.asarray(a)) for a in args),
                              torch.from_numpy(cloud["flow_is_valid"]), dataset=dataset).eval_mask
        want = JD.deskew_frame(*(jnp.asarray(a) for a in args),
                               jnp.asarray(cloud["flow_is_valid"]), dataset=dataset).eval_mask
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        xyz = torch.from_numpy(pc)
        dis = torch.sqrt((xyz[:, :2] * xyz[:, :2]).sum(dim=-1))
        old = (dis <= 35.0) & ~torch.from_numpy(cloud["ground"]) & torch.from_numpy(cloud["valid"])
        box = PC.SCANIA_EGO_BOX if dataset == "scania" else PC.AV2_EGO_BOX
        old &= PC.ego_points_mask(xyz, *box)
        if dataset == "scania":
            old &= torch.from_numpy(cloud["flow_is_valid"])
        exact = np.hypot(np.float64(pc[:, 0]), np.float64(pc[:, 1]))
        off_circle = torch.from_numpy(np.abs(exact - 35.0) > 1e-4)
        assert off_circle.sum() > 5000
        assert torch.equal(got[off_circle], old[off_circle])


def _reexports(sub: str) -> list:
    """``(module, name)`` of every ``from ... import`` in the JAX package's
    ``sub/__init__.py``, read by AST (jax is not imported for it)."""
    tree = ast.parse((REPO / "himo_tpu" / sub / "__init__.py").read_text())
    return [(node.module, alias.name) for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_match_jax(sub):
    names = _reexports(sub)
    assert names, sub
    port = importlib.import_module(f"himo_tpu_torch.{sub}")
    for module, name in names:
        assert module.startswith(f"himo_tpu.{sub}."), module
        source = importlib.import_module(module.replace("himo_tpu.", "himo_tpu_torch.", 1))
        assert getattr(port, name) is getattr(source, name), (sub, name)
    assert port.__doc__, sub


def test_subpackage_imports_build_nothing():
    """Importing every subpackage runs no compiler, loads no shared
    library and leaves CUDA uninitialised."""
    code = (
        "import ctypes, subprocess, sys\n"
        "import torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'import started a process or loaded a library: {a}')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import importlib\n"
        f"for sub in {SUBPACKAGES + ('io', 'viz', 'training', 'downstream', 'cli', 'kernels')!r}:\n"
        "    importlib.import_module('himo_tpu_torch.' + sub)\n"
        "from himo_tpu_torch.kernels import _build\n"
        "from himo_tpu_torch import native\n"
        "assert _build._LOADED == {}, _build._LOADED\n"
        "assert native._lib is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _public_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def test_public_names_match_jax_by_ast():
    """Every module of the JAX package has a counterpart in the port with
    its public names; the one exception is the test oracle
    ``ops/nn.py::nn_distance_sq_reference``."""
    missing = {}
    for jax_path in sorted((REPO / "himo_tpu").rglob("*.py")):
        rel = jax_path.relative_to(REPO / "himo_tpu")
        port_path = REPO / "himo_tpu_torch" / rel
        assert port_path.exists(), rel
        gone = _public_names(jax_path) - _public_names(port_path)
        if gone:
            missing[rel.as_posix()] = sorted(gone)
    assert missing == {"ops/nn.py": ["nn_distance_sq_reference"]}
