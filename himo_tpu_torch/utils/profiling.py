"""Tracing and profiling (port of ``himo_tpu/utils/profiling.py``).

- :class:`Timer` — named accumulating wall-clock timers with a summary table.
- :func:`stage_timer` — context manager for one stage.
- :func:`trace` — a ``torch.profiler`` trace of the block (host and, where
  there is a GPU, device activity) written as a Chrome trace; a no-op when
  profiling is disabled.
- :func:`span` — a named range of the program (``himo.frame``,
  ``himo.backbone``, ...) in whatever ``torch.profiler`` trace is recording,
  on the device events' clock; one flag read when none is.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

_NO_SPAN = contextlib.nullcontext()
_autograd_profiler = torch.autograd.profiler


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


def span(name: str):
    """A context manager that marks the block as ``name`` in the recording
    ``torch.profiler`` trace (``record_function``): the device work the
    block launches is tied to the range by its launches' correlation ids,
    and ranges nest as the blocks do. With no profiler recording it reads
    one flag and returns a shared no-op context. The range lives in the
    profiler's trace alone (:func:`trace` writes it out)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)
