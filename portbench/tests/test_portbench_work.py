"""The yardstick's counts: the products and convolutions of the
reference, as ``torch.utils.flop_counter.FlopCounterMode`` counts them,
and the kernel table's least times at its shapes."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import small_cell


def _counted(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def test_seflowpp_products_match_the_flop_counter():
    import weights
    import work
    from reference import seflowpp as ref
    from traffic.synthetic import make_item

    cell = small_cell("seflowpp-512.infer-65k")
    model = dict(cell.config["model"])
    model.pop("preset")
    cfg = ref.net_config(model)
    net = ref.SeFlowPP(cfg)
    net.load_state_dict(weights.make(ref.param_shapes(cfg), 1, torch.device("cpu")))
    b = {k: torch.from_numpy(v) for k, v in
         make_item(cell.traffic, np.random.default_rng(1)).items()}
    got = _counted(lambda: ref.deskew(net, b["pc0"], b["pc1"], b["pc_hist"], b["valid"], b["dt0"]))
    want = work.seflowpp_infer_flops(cell.config["model"], cell.traffic["batch"],
                                     cell.traffic["points"])
    assert got == want["bf16"] + want["fp32"]


def test_train_step_products_match_the_flop_counter():
    import weights
    import work
    from reference import seflowpp as ref
    from reference import train as ref_train
    from traffic.synthetic import make_item

    cell = small_cell("seflowpp-512.train-65k")
    model = dict(cell.config["model"])
    model.pop("preset")
    cfg = ref.net_config(model)
    net = ref.SeFlowPP(cfg)
    net.load_state_dict(weights.make(ref.param_shapes(cfg), 1, torch.device("cpu")))
    b = {k: torch.from_numpy(v) for k, v in
         make_item(cell.traffic, np.random.default_rng(1)).items()}
    step = ref_train.Step(net, cell.config["train"])
    got = _counted(lambda: step(b))
    t = cell.traffic
    want = work.seflowpp_train_flops(cell.config["model"], t["batch"], t["points"],
                                     t["loss_points"])
    assert got == want["bf16"] + want["fp32"]


def test_kernel_rules_give_the_kernel_tables_bounds():
    import work

    live = int(65536 * 0.92) * 8
    k1 = {"shapes": [(8, 65536), (8, 65536, 32), None], "ints": [512 * 512], "live": live}
    k7 = {"shapes": [(8, 4096, 3), (8, 8192, 3)], "ints": []}
    k8 = {"shapes": [(8, 16384, 3), (8, 16384, 3)] + [(8, 16384)] * 4, "ints": []}
    assert round(work.call_least_seconds("scatter_max_rows", k1) * 1e3, 4) == 0.0992
    assert round(work.call_least_seconds("nn_argmin_rows", k7) * 1e3, 4) == 0.0401
    assert round(work.call_least_seconds("fused_nn_idx", k8) * 1e3, 4) == 0.5128


def test_every_kernel_wrapper_of_the_program_has_a_rule():
    import work

    from himo_tpu_torch.ops import knn, mxu_scatter, nn, voxelize

    wrappers = {name for mod in (knn, mxu_scatter, nn, voxelize) for name, fn in vars(mod).items()
                if callable(fn) and hasattr(fn, "launches")}
    assert wrappers == set(work.OP_RULES)
