"""The port's batched fleet (``himo_tpu_torch/parallel/fleet.py``) against
the JAX package's, on the CPU.

Scenes: the JAX package's ``make_dataset`` (2 scenes x 5 frames, 700
background points, so every cloud is longer than the 1,024-point budget
below), copied so that each package writes its own; the network:
``seflowpp`` at the toy width of ``tests/test_config5_chain.py`` with the
JAX model's initial weights, converted by ``flax_to_torch``. The reference
runs on its 8-device CPU mesh (8 frames a step, the second step partial);
the port on one device, 3 frames a batch (the fourth batch partial, padded
by repeating its last frame).

Tolerances: frame arrays and stacked batches bitwise (the same numpy, the
same native packer); written flows within 1e-4 m (the slice tests' bound)
outside the instance slots, and within a slot either so or moved as a
whole by the refine head's chaos, as ``tests/test_torch_runner.py`` states
it; zero beyond the point budget; every other dataset bitwise."""

import shutil

import h5py
import jax
import numpy as np
import pytest
from test_torch_runner import TINY, assert_flows_match, recorded_slots

from himo_tpu.data.dataset import SceneFlowDataset as JDataset
from himo_tpu.data.synthetic import make_dataset
from himo_tpu.models import feedforward as JF
from himo_tpu.parallel import fleet as JFL
from himo_tpu_torch.data.dataset import SceneFlowDataset as PDataset
from himo_tpu_torch.models import feedforward as PF
from himo_tpu_torch.parallel import fleet as PFL
from himo_tpu_torch.utils.convert import flax_to_torch

NUM_POINTS = 1024
GATE = 0.05


def _read(path):
    with h5py.File(path, "r") as f:
        return {key: {name: f[key][name][()] for name in f[key]} for key in f}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet")
    root = base / "av2_fleet"
    make_dataset(root, num_scenes=2, num_frames=5, seed=9, num_background=700)
    jm, _ = JF.make_model("seflowpp", **TINY)
    jparams = jax.tree_util.tree_map(np.asarray, JF.init_params(jm, jax.random.PRNGKey(0), 2048))
    _, pcfg = PF.make_model("seflowpp", device="cpu", **TINY)
    before = {p.stem: _read(p) for p in sorted(root.glob("*.h5"))}
    jroot = base / "av2_fleet_jax"
    shutil.copytree(root, jroot)
    jstats = {}
    for gate in (0.0, GATE):
        jstats[gate] = JFL.fleet_save(
            str(jroot), model="seflowpp", params=jparams, output_key=f"fleet_{gate}",
            config=JFL.FleetConfig(num_points=NUM_POINTS, batch_per_device=1,
                                   static_gate=gate),
            model_overrides=TINY, verbose=False)
    return dict(root=root, jroot=jroot, state=flax_to_torch(jparams, pcfg), before=before,
                jstats=jstats)


@pytest.mark.parametrize("defer_pack", [False, True])
def test_frame_arrays_and_batches_match_reference(setup, defer_pack):
    """``frame_to_arrays`` (with the history sweep and the refine head's
    sweep times) and ``stack_fleet_batch`` of three frames, bitwise."""
    jds = JDataset(setup["root"], with_pc1=True, with_history=True, next_keys=("lidar_dt",))
    pds = PDataset(setup["root"], with_pc1=True, with_history=True, next_keys=("lidar_dt",))
    frames = {"jax": [], "port": []}
    for i in (0, 4, 7):
        j = JFL.frame_to_arrays(jds[i], NUM_POINTS, True, defer_pack=defer_pack, with_dts=True)
        p = PFL.frame_to_arrays(pds[i], NUM_POINTS, True, defer_pack=defer_pack, with_dts=True)
        assert j.keys() == p.keys()
        for k in j:
            a, b = np.asarray(p[k]), np.asarray(j[k])
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
        assert p["num_total"] > NUM_POINTS == p["num_real"]
        frames["jax"].append(j)
        frames["port"].append(p)
    got = PFL.stack_fleet_batch(frames["port"], NUM_POINTS)
    want = JFL.stack_fleet_batch(frames["jax"], NUM_POINTS)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
        assert got[k].shape[:2] == (3, NUM_POINTS) or k == "rel_pose"


@pytest.mark.parametrize("gate", [0.0, GATE])
def test_fleet_save_writes_the_reference_flows(setup, gate, capsys, monkeypatch):
    """``fleet_save`` (3 frames a batch, the last batch partial) with and
    without ``static_gate``: every frame's flow within the tolerance above
    of the reference's, zero past the point budget, the other datasets
    unchanged, the stats the reference's."""
    s = setup
    with recorded_slots(monkeypatch) as calls:
        stats = PFL.fleet_save(
            str(s["root"]), model="seflowpp", params=s["state"], output_key=f"fleet_{gate}",
            config=PFL.FleetConfig(num_points=NUM_POINTS, batch_per_device=3, static_gate=gate),
            model_overrides=TINY, device="cpu")
    # Batches of 3 in dataset order; the last one repeats frame 9.
    slots = np.concatenate([slot for _, slot in calls])
    index = PDataset(s["root"]).data_index
    jstats = s["jstats"][gate]
    assert stats["frames"] == jstats["frames"] == 10
    assert stats["points"] == jstats["points"] == 10 * NUM_POINTS
    assert stats["mesh_shards"] == 1 and stats["write_s"] >= 0
    want = {p.stem: _read(p) for p in sorted(s["jroot"].glob("*.h5"))}
    for scene, groups in s["before"].items():
        got = _read(s["root"] / f"{scene}.h5")
        for key, arrays in groups.items():
            flow = got[key][f"fleet_{gate}"]
            assert flow.dtype == np.float32 and flow.shape == (len(arrays["lidar"]), 3)
            i = index.index([scene, int(key)])
            assert_flows_match(flow[:NUM_POINTS], want[scene][key][f"fleet_{gate}"][:NUM_POINTS],
                               slots[i], (scene, key))
            assert not flow[NUM_POINTS:].any()
            for name, arr in arrays.items():
                assert got[key][name].dtype == arr.dtype
                assert got[key][name].tobytes() == arr.tobytes(), (scene, key, name)
    assert "fleet_" in capsys.readouterr().out


def test_run_fleet_hands_each_frame_to_the_consumer(setup):
    """``run_fleet`` with a consumer: every frame once, outputs trimmed to
    the real points, ``refined = pc0 + comp_dis``."""
    s = setup
    net, cfg = PF.make_model("seflowpp", device="cpu", **TINY)
    net.load_state_dict(s["state"])
    net.eval()
    ds = PDataset(s["root"], with_pc1=True, with_history=True, next_keys=("lidar_dt",))
    seen = {}

    def consumer(i, host, out):
        seen[i] = (host, out)

    config = PFL.FleetConfig(num_points=NUM_POINTS, batch_per_device=4, static_gate=GATE)
    stats = PFL.run_fleet(ds, net, config=config, consumer=consumer)
    assert sorted(seen) == list(range(len(ds))) and stats["frames"] == len(ds)
    for host, out in seen.values():
        n = host["num_real"]
        assert {k: v.shape for k, v in out.items()} == {k: (n, 3) for k in
                                                        ("comp_dis", "refined", "flow")}
        np.testing.assert_array_equal(out["refined"], host["pc0"][:n] + out["comp_dis"])
