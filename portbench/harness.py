"""One run of one cell: set-up, the measured window, the traced part,
the check against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration's file, its traffic file ``workloads/<traffic>.json``
(whose ``kind`` names the driver ``drivers/<kind>.py``) and each per-layer
metric's reader ``metrics/<name>.py``. A driver provides ``setup(cell)``
returning an object with ``item(i)``, which runs the ``i``-th item of the
window to its completion on the host, ``units_per_item`` and
``steps_per_item``, ``flops_per_item`` (``work``'s count), and
``check()``, which compares what the window produced with the
reference once the window has closed.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "himo_tpu")  # top-level module names


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    device: str = "cuda"
    seed: int = 0
    extra: dict = field(default_factory=dict)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in {bench_path.name}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((bench_path.parent / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{cell['traffic']}.json").read_text())
    return Cell(name, cell["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def quantile_p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``' inclusive method)."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def end_to_end(name: str, window: dict, setup_s: float, driver) -> float:
    """An end-to-end metric from the window's host-clock record."""
    if name == "setup_s":
        return setup_s
    if name == "compensated_pts_per_s":
        return driver.units_per_item * window["items"] / window["seconds"]
    if name == "batch_ms_p95":
        return quantile_p95(window["item_s"]) * 1e3
    if name == "train_step_ms":
        return window["seconds"] / (window["items"] * driver.steps_per_item) * 1e3
    raise KeyError(f"no end-to-end metric {name!r}")


def run_window(driver, seconds: float, start_index: int = 0) -> dict:
    """Items until ``seconds`` have passed, one in flight: the window runs
    from the first item's start to the last one's completion."""
    item_s = []
    start = time.perf_counter()
    i = start_index
    while True:
        t0 = time.perf_counter()
        driver.item(i)
        t1 = time.perf_counter()
        item_s.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            break
    return {"items": len(item_s), "seconds": time.perf_counter() - start, "item_s": item_s,
            "next": i}


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, log=print) -> dict:
    """One run of ``cell``: returns the result line's object, with the
    compared numbers last."""
    import torch

    from tracing import Tracer

    cell.seed = seed
    tracer = Tracer()
    cell.extra["marks"] = [("imports", time.perf_counter())]
    driver = load_module(HERE / "drivers" / f"{cell.traffic['kind']}.py").setup(cell, tracer)
    # The reference's pass in set-up (the weights' calibration) is the
    # benchmark's, not the program's: set-up leaves it out.
    reference_s = cell.extra.get("reference_s", 0.0)
    setup_s = time.perf_counter() - t_start - reference_s
    marks = [(name, at - t_start) for name, at in cell.extra["marks"]]
    log(f"[{cell.name}] set-up: " + ", ".join(
        f"{name} by {at:.3f} s" for name, at in marks + [("warm-up", setup_s + reference_s)]))
    log(f"[{cell.name}] set-up {setup_s:.3f} s: the reference's calibration pass, "
        f"{reference_s:.3f} s of it, left out")
    if cell.device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    traced_events = None
    traced_calls = []
    start_index = 0
    if trace:
        n = cell.traffic["trace_items"]

        def traced_items():
            for i in range(n):
                with tracer.item():
                    driver.item(i)

        t0 = time.perf_counter()
        _, traced_events = tracer.traced(traced_items)
        traced_calls = tracer.finish_calls()
        start_index = n
        seconds = max(seconds - (time.perf_counter() - t0), 1.0)
    window = run_window(driver, seconds, start_index)
    attempted = window["items"] + start_index

    device = {"platform": "gpu" if cell.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if cell.device == "cuda" else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
              if cell.device == "cuda" else 0}
    log(f"[{cell.name}] seed {seed}: {attempted} items, window {window['seconds']:.3f} s, "
        f"set-up {setup_s:.3f} s, peak memory {device['memory_peak_bytes'] / 2**30:.3f} GiB")

    metrics, breakdown = {}, None
    if trace:
        from tracing import breakdown as make_breakdown, busy_in_window

        busy_s, window_s = busy_in_window(traced_events)
        device["busy_s"], device["window_s"] = busy_s, window_s
        ctx = {"events": traced_events, "calls": traced_calls, "window": window,
               "driver": driver, "cell": cell, "busy_s": busy_s, "window_s": window_s,
               "traced_items": cell.traffic["trace_items"]}
        for m in cell.per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = make_breakdown(traced_events)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], window, setup_s, driver),
                                  "unit": m["unit"]}

    compared = driver.check()
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result
