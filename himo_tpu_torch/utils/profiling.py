"""Tracing and profiling (port of ``himo_tpu/utils/profiling.py``).

- :class:`Timer` — named accumulating wall-clock timers with a summary table.
- :func:`stage_timer` — context manager for one stage.
- :func:`trace` — a ``torch.profiler`` trace of the block (host and, where
  there is a GPU, device activity) written as a Chrome trace; a no-op when
  profiling is disabled.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional


class Timer:
    """Accumulating named wall-clock timers."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["stage                          total_s    calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(
                f"{name:<30} {total:>8.3f} {count:>8d} {1e3 * total / max(count, 1):>9.2f}"
            )
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.summary())


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        print(f"[timing] {name}: {time.perf_counter() - start:.3f} s")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``{log_dir}/trace.json`` (Chrome trace format) when ``log_dir`` is set,
    else do nothing. CUDA activity is traced when a GPU is present."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
