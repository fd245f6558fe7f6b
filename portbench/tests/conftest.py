"""Puts the benchmark's modules and the checkout on the path, and builds
cells cut to a size a CPU test run can hold."""

import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def small_cell(name: str):
    """The cell ``name`` of ``BENCHMARK.json`` on the CPU, at a tiny size:
    a 32 x 32 grid, 2 frames of 2,048 points, and in training 256 chamfer
    samples and a read every 2 steps."""
    import harness

    cell = harness.load_cell(name)
    cell.device = "cpu"
    model = cell.config["model"]
    model["pillar"]["voxel_size"] = [3.2, 3.2]
    model["refine"]["num_query"] = 256
    model["refine"]["num_ref"] = 512
    cell.traffic.update(batch=2, points=2048, trace_items=2)
    if cell.traffic["kind"] == "train":
        cell.traffic.update(loss_points=256, read_every=2, trace_items=1)
        cell.config["train"].update(num_points=2048, loss_points=256, batch_size=2)
    return cell


def run_small(cell, seed: int, seconds: float = 1.0, trace: bool = False) -> dict:
    import harness

    return harness.run(cell, seed, seconds, trace, time.perf_counter(), log=lambda s: None)


@pytest.fixture
def cuda_device():
    """Skips the test unless a CUDA device is present (decided here, in
    the test, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
