"""The harness's plumbing: cells, configurations, traffic and metrics
found by name, the result line's keys, and no run without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_small, small_cell

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_the_result_line_holds_the_drivers_keys_with_the_compared_numbers_last():
    result = run_small(small_cell("seflowpp-512.infer-65k"), seed=51, seconds=0.3)
    assert list(result) == KEYS + ["compared"]
    assert set(result["metrics"]) == {"compensated_pts_per_s", "batch_ms_p95", "setup_s"}
    traced = run_small(small_cell("seflowpp-512.infer-65k"), seed=52, seconds=0.3, trace=True)
    assert list(traced) == KEYS + ["breakdown", "compared"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert traced["correct"] and result["correct"]


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "seflowpp-512.json").read_text())
    config["name"] = "seflowpp-512-small"
    (tmp_path / "portbench" / "configs" / "seflowpp-512-small.json").write_text(json.dumps(config))
    traffic = json.loads((BENCH / "workloads" / "infer-65k.json").read_text())
    (tmp_path / "portbench" / "workloads" / "infer-2k.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "items_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['cell'].traffic['trace_items'])\n")
    bench["configs"].append({"name": "seflowpp-512-small", "source": "https://example.org",
                             "file": "portbench/configs/seflowpp-512-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "seflowpp-512-small.infer-2k", "config": "seflowpp-512-small",
                               "traffic": "infer-2k", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "items_traced", "unit": "items", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "compensated_pts_per_s",
                               "workloads": ["seflowpp-512-small.infer-2k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path / 'portbench')!r}, "
        f"{str(tmp_path / 'portbench' / 'tests')!r}, {str(ROOT)!r}]\n"
        "from conftest import small_cell, run_small\n"
        "cell = small_cell('seflowpp-512-small.infer-2k')\n"
        "print(json.dumps(run_small(cell, 61, 0.2, trace=True)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["items_traced"]["value"] == 2.0


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "seflowpp-512.infer-65k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT), env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_checkout_with_only_the_benchmark_exits_non_zero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "seflowpp-512.infer-65k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "seflowpp-512.infer-65k", "--seed", "71", "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_the_idle_share_reads_busy_per_traced_item_against_the_untraced_window():
    import readers

    # 20 traced items busy 0.8 s in all, against 100 untraced items in 5 s:
    # 40 ms busy of 50 ms an item, whatever the traced items' own wall.
    ctx = {"window": {"items": 100, "seconds": 5.0}, "traced_items": 20, "busy_s": 0.8,
           "window_s": 1.6}
    assert readers.device_idle(ctx) == pytest.approx(20.0)
    assert readers.device_idle(dict(ctx, busy_s=0.0)) is None


def test_set_up_leaves_out_the_references_calibration_pass():
    import time

    import harness

    logged = []
    cell = small_cell("seflowpp-512.infer-65k")
    harness.run(cell, 53, 0.2, False, time.perf_counter(), log=logged.append)
    assert cell.extra["reference_s"] > 0
    line = next(s for s in logged if "left out" in s)
    assert f"{cell.extra['reference_s']:.3f} s of it, left out" in line
