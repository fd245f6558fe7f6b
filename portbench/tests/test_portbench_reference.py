"""The plain reference and the traffic generators against ``himo_tpu_torch``
at a small size on the CPU (where the program runs its kernels' plain
versions)."""

import numpy as np
import torch

from conftest import small_cell


def _infer_pair(seed):
    import weights
    from reference import seflowpp as ref
    from traffic.synthetic import make_item

    from himo_tpu_torch.models import feedforward

    cell = small_cell("seflowpp-512.infer-65k")
    model_cfg = dict(cell.config["model"])
    preset = model_cfg.pop("preset")
    cfg = ref.net_config(model_cfg)
    w = weights.make(ref.param_shapes(cfg), seed, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             make_item(cell.traffic, np.random.default_rng(seed)).items()}
    reference = ref.SeFlowPP(cfg)
    reference.load_state_dict(w)
    shift = ref.calibrate(reference, batch["pc0"], batch["pc1"], batch["pc_hist"],
                          batch["valid"], **cell.config["calibration"])
    w["unet.head.bias"][cfg.base_channels * 2] -= shift["dyn"]
    w["decoder.out.bias"][3] -= shift["gate"]
    reference.load_state_dict(w)
    program, _ = feedforward.make_model(preset, device="cpu", **model_cfg)
    program.load_state_dict(w)
    program.eval()
    args = (batch["pc0"], batch["pc1"], batch["pc_hist"], batch["valid"], batch["dt0"])
    return ref.deskew(reference, *args), feedforward.frame(program, *args), batch


def test_the_reference_network_gives_the_programs_flow_and_deskew():
    for seed in (3, 2**31 + 5):
        (flow, refined), (pflow, _, prefined), batch = _infer_pair(seed)
        valid = batch["valid"]
        moved = (flow.abs().sum(-1) > 0) & valid
        assert 0.05 < float(moved.sum()) / float(valid.sum()) < 0.9
        assert torch.equal(flow, pflow)
        assert torch.equal(refined, prefined)


def test_the_traffic_copies_give_the_programs_arrays():
    from traffic import synthetic as mine

    from himo_tpu_torch.data import synthetic

    a = mine.lidar_like_cloud(np.random.default_rng(1), 2, 1000)
    b = synthetic.lidar_like_cloud(np.random.default_rng(1), 2, 1000)
    np.testing.assert_array_equal(a, b)
    a = mine.train_batch(np.random.default_rng(2), 2, 512, 64)
    b = synthetic.train_batch(np.random.default_rng(2), 2, 512, 64)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_every_seed_draws_the_same_sizes():
    from traffic.synthetic import make_item

    cell = small_cell("seflowpp-512.infer-65k")
    shapes = None
    for seed in (0, 1, 2**33 + 7):
        item = make_item(cell.traffic, np.random.default_rng(seed))
        got = {k: (v.shape, int(v.sum()) if v.dtype == bool else None) for k, v in item.items()}
        assert shapes in (None, got)
        shapes = got
        step = (item["pc1"] - item["pc0"])[..., :2]
        speed = np.linalg.norm(step, axis=-1) / 0.1
        moving = speed > 0
        assert 0.05 < moving.mean() < 0.15
        assert speed[moving].min() >= 5.0 - 1e-3 and speed[moving].max() <= 30.0 + 1e-3
