"""The port's per-frame runner (``himo_tpu_torch/models/runner.py``,
``estimate_scene_flow``) and its write-back (``data/schema``) against the
JAX package's, on the CPU.

Scenes: the JAX package's ``make_dataset`` (2 scenes x 4 frames, 600
background points), copied so that each package writes its own; the
network: ``seflowpp`` at the toy width of ``tests/test_config5_chain.py``
(64 x 64 pillars of 0.8 m, depths (16, 32), 8 point features, 8 base
channels) with the JAX model's initial weights, converted by
``flax_to_torch``. Both packages take their native KD-tree for the
upsampling (the library is built here).

Tolerances: the written flows within 1e-4 m of the reference's (the slice
tests' bound: the same float32 forward, summed in other orders) on every
point outside the instance slots. The refine head is chaotic at the
1e-3..1e-2 m level (a near-tied nearest-neighbour pair flips and moves a
slot's measured translation; ``tests/test_torch_refine.py`` measures the
reference's own sensitivity to a one-ulp nudge), so within each slot (the
port's slot ids, recorded from its forward) the members that differ by
more than 1e-4 m must all differ by one shared offset (to 1e-4 m) of at
most 1 cm. Every other dataset bitwise equal to what the scene held before
(bytes, dtype and shape), and the files read by h5py."""

import contextlib
import shutil

import h5py
import jax
import numpy as np
import pytest

from himo_tpu.data.synthetic import make_dataset
from himo_tpu.models import feedforward as JF
from himo_tpu.models.runner import estimate_scene_flow as j_estimate
from himo_tpu_torch import native as PN
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.models import runner as PR
from himo_tpu_torch.utils.convert import flax_to_torch

TINY = {
    "pillar.x_range": (-25.6, 25.6),
    "pillar.y_range": (-25.6, 25.6),
    "pillar.voxel_size": (0.8, 0.8),
    "depths": (16, 32),
    "point_feat_dim": 8,
    "base_channels": 8,
}
ATOL = 1e-4
SLOT_TOL = 1e-2
CAP = 1000  # max_estimation_points, below every cloud's size


def _read(path):
    with h5py.File(path, "r") as f:
        return {key: {name: f[key][name][()] for name in f[key]} for key in f}


def assert_flows_match(got, ref, slot, what=""):
    """``got`` within ATOL of ``ref`` outside the slots (``slot`` < 0); in
    each slot, the members beyond ATOL moved by one offset of at most
    SLOT_TOL (see the module's docstring)."""
    free = slot < 0
    np.testing.assert_allclose(got[free], ref[free], atol=ATOL, err_msg=str(what))
    diff = got.astype(np.float64) - ref
    for s in np.unique(slot[~free]):
        d = diff[slot == s]
        d = d[np.abs(d).max(1) > ATOL]
        if len(d):
            assert np.abs(d - d[0]).max() <= ATOL, (what, s)
            assert np.abs(d[0]).max() <= SLOT_TOL, (what, s, d[0])


@contextlib.contextmanager
def recorded_slots(monkeypatch):
    """Record each forward of the port's network (called with neither aux
    nor gate): its first sweep and its slot ids, as numpy, in call order."""
    calls = []
    forward = PF.SceneFlowNet.forward

    def recording(self, sweeps, valids, prior=None, **kw):
        flow, aux = forward(self, sweeps, valids, prior, with_aux=True, **kw)
        calls.append((sweeps[0].numpy().copy(), aux["slot"].numpy().copy()))
        return flow

    with monkeypatch.context() as m:
        m.setattr(PF.SceneFlowNet, "forward", recording)
        yield calls


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("runner")
    root = base / "av2_runner"
    make_dataset(root, num_scenes=2, num_frames=4, seed=11, num_background=600)
    jm, _ = JF.make_model("seflowpp", **TINY)
    jparams = jax.tree_util.tree_map(np.asarray, JF.init_params(jm, jax.random.PRNGKey(0), 2048))
    _, pcfg = PF.make_model("seflowpp", device="cpu", **TINY)
    state = flax_to_torch(jparams, pcfg)
    before = {p.stem: _read(p) for p in sorted(root.glob("*.h5"))}
    jroot = base / "av2_runner_jax"
    shutil.copytree(root, jroot)
    for cap in (None, CAP):
        j_estimate(str(jroot), model="seflowpp", params=jparams, output_key=f"ff_{cap}",
                   verbose=False, max_estimation_points=cap, **TINY)
    return dict(root=root, jroot=jroot, state=state, before=before)


def _runner_slots(root, calls, cap):
    """Each estimated frame's slot ids per point, from the recorded
    forwards in the runner's order; under ``cap`` a point takes the slot of
    the estimation point its flow was upsampled from."""
    from himo_tpu_torch.core.transforms import rigid_flow
    from himo_tpu_torch.data.dataset import SceneFlowDataset

    ds = SceneFlowDataset(root, with_pc1=True)
    out, k = {}, 0
    for i in range(len(ds)):
        data = ds[i]
        if not data["has_next"]:
            continue
        est, slot = calls[k][0][0], calls[k][1][0]
        k += 1
        xyz = data["pc0"][:, :3]
        if cap is None:
            out[(data["scene_id"], str(data["timestamp"]))] = slot[: len(xyz)]
            continue
        comp = xyz + rigid_flow(xyz, data["pose0"], data["pose1"]).astype(np.float32)
        _, idx = PN.KDTree(est[:cap]).query(comp)
        out[(data["scene_id"], str(data["timestamp"]))] = slot[idx]
    assert k == len(calls)
    return out


def test_runner_writes_the_reference_flows(setup, capsys, monkeypatch):
    """``estimate_scene_flow`` at full resolution, then again under
    ``max_estimation_points`` to the same key: each run's flows within the
    tolerance above of the reference's, the second replacing the first; a
    flow for every frame with a successor and none for a scene's last
    frame; every other dataset unchanged."""
    s = setup
    want = {p.stem: _read(p) for p in sorted(s["jroot"].glob("*.h5"))}
    for cap in (None, CAP):
        with recorded_slots(monkeypatch) as calls:
            stats = PR.estimate_scene_flow(
                str(s["root"]), model="seflowpp", params=s["state"], output_key="ff",
                device="cpu", max_estimation_points=cap, **TINY)
        assert stats["frames"] == 6 and stats["repaired"] == 0
        slots = _runner_slots(s["root"], calls, cap)
        n_flows = 0
        for scene, groups in s["before"].items():
            got = _read(s["root"] / f"{scene}.h5")
            assert got.keys() == groups.keys()
            last = max(groups, key=int)
            for key, arrays in groups.items():
                extra = set(got[key]) - set(arrays)
                if key == last:
                    assert not extra
                    continue
                assert extra == {"ff"}
                flow = got[key]["ff"]
                assert flow.dtype == np.float32 and flow.shape == (len(arrays["lidar"]), 3)
                assert_flows_match(flow, want[scene][key][f"ff_{cap}"], slots[(scene, key)],
                                   (scene, key))
                n_flows += 1
                for name, arr in arrays.items():
                    assert got[key][name].dtype == arr.dtype
                    assert got[key][name].tobytes() == arr.tobytes(), (scene, key, name)
        assert n_flows == 6
    out = capsys.readouterr().out
    assert "seflowpp: 6 frames" in out and "stage" in out


def test_write_method_flow_adds_and_replaces(setup, tmp_path):
    """``write_method_flow`` (one frame) and ``write_method_flows`` (a
    scene): float32 (N, 3) under the method name, an existing one replaced,
    the rest of the file as it was; h5py reads the result."""
    from himo_tpu_torch.data import schema

    root = tmp_path / "av2_write"
    shutil.copytree(setup["root"], root)
    scene = sorted(setup["before"])[0]
    groups = _read(root / f"{scene}.h5")
    keys = sorted(groups, key=int)
    rng = np.random.default_rng(0)
    flows = {k: rng.normal(size=(len(groups[k]["lidar"]), 3)) for k in keys}  # float64
    schema.write_method_flows(root, scene, "m", flows)
    schema.write_method_flow(root, scene, int(keys[1]), "m", flows[keys[1]] * 2)
    got = _read(root / f"{scene}.h5")
    for k in keys:
        want = (flows[k] * (2 if k == keys[1] else 1)).astype(np.float32)
        assert got[k]["m"].dtype == np.float32
        np.testing.assert_array_equal(got[k]["m"], want)
        for name, arr in groups[k].items():
            assert got[k][name].dtype == arr.dtype and got[k][name].tobytes() == arr.tobytes()
    with pytest.raises(KeyError):
        schema.write_method_flow(root, scene, 12345, "m", flows[keys[0]])
    assert not list(root.glob("*.tmp"))


def test_runner_rng_split_and_upsample():
    """The generator split gives each call its own seed from the master's
    stream, and the upsampling takes each point's nearest estimated
    neighbour's flow."""
    import torch

    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, b = PR._split(g1), PR._split(g2)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=PR._split(g1)),
                           torch.rand(4, generator=PR._split(torch.Generator().manual_seed(4))))
    rng = np.random.default_rng(0)
    sub = rng.uniform(-10, 10, (50, 3)).astype(np.float32)
    full = np.concatenate([sub, sub + 0.01]).astype(np.float32)
    flow = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(PR._upsample_flow(full, sub, flow), np.concatenate([flow, flow]))
