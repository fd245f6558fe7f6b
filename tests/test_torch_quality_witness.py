"""Both packages' quality training side by side on the CPU, through
``tests/torch_quality_witness.py`` at a toy size (2 + 1 scenes of the
suite at 1,500 + 6 x 100 points a frame, the network cut as
``tests/test_torch_scripts.py`` cuts it, two epochs of one step): the port
trains from JAX's initial weights, converted by ``utils/convert``."""

import sys
from pathlib import Path

import numpy as np

import himo_tpu.native
import himo_tpu_torch.native

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_quality_witness as qw  # noqa: E402

SUITE = dict(num_scenes=2, adversarial_scenes=1)
FLAGS = ["--epochs", "2", "--bg-points", "1500", "--obj-points", "100", "--num-points", "2048",
         "--device", "cpu"]
TOY = {"pillar.voxel_size": (0.8, 0.8), "depths": (16, 32), "refine.num_query": 64,
       "refine.num_ref": 128}


def test_quality_training_matches_jax_step_by_step(tmp_path, monkeypatch):
    """``tests/torch_quality_witness.py`` at a toy size: both packages'
    train branches on one suite, the port from JAX's initial weights. The
    suites and their DUFO labels are bitwise equal, every train step's loss
    agrees within 1e-5 relative, and the tables within 1e-3 (the raw rows
    exactly)."""
    # Both packages on scipy's cKDTree, as in tests/test_torch_scripts.py.
    monkeypatch.setattr(himo_tpu.native, "available", lambda: False)
    monkeypatch.setattr(himo_tpu_torch.native, "available", lambda: False)
    out = qw.witness(tmp_path, SUITE, TOY, FLAGS,
                     echo=lambda line: None)
    assert out["suites"] == {"data": True, "labels": True}
    assert out["train_steps"] == {"jax": 2, "port": 2}
    assert [k for k, *_ in out["steps"]] == [1, 2]
    for _, want, got in out["steps"]:
        assert np.isfinite(want) and abs(got - want) <= 1e-5 * abs(want)
    jax_table, table = out["tables"]["jax"], out["tables"]["port"]
    assert list(table) == list(jax_table) == ["raw", "seflowpp", "raw [adv]", "seflowpp [adv]"]
    assert table["raw"] == jax_table["raw"] and table["raw [adv]"] == jax_table["raw [adv]"]
    for m, row in jax_table.items():
        np.testing.assert_allclose([table[m][c] for c in row], list(row.values()), atol=1e-3,
                                   rtol=0, err_msg=m)
