"""The CPU rehearsal of ``chip_smoke.py``'s phases, shared by
``tests/test_torch_smoke.py`` and ``tests/test_torch_smoke_paths.py``.

The script needs a card to run; the ``rehearsal`` fixture lets its phase
functions run here: the CUDA-only calls stubbed (synchronize, events,
memory statistics), a toy grid and batch, and every kernel wrapper replaced
by a counting call of its plain version (the real wrappers count only
kernel launches). It imports no JAX, like the script."""

import ctypes
import ctypes.util
import functools
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

import himo_tpu_torch.cli.train  # noqa: E402,F401 - bound to TrainConfig before the rehearsal

# The rehearsals are many small ops. Beside the other test workers, torch's
# default of one intra-op thread per core puts several threads on each core.
# In whole runs on 8 cores (6 workers) the kernel phases' rehearsal took
# 649 s with the default (and malloc's default thresholds, below); with the
# thresholds raised, 133-138 s with one thread and 150 s with two.
REHEARSAL_THREADS = 1
# glibc's malloc hands blocks above its mmap threshold back to the kernel
# when they are freed, and trims the heap's top above its trim threshold.
# The rehearsals make and free many large tensors, and with the defaults
# about 40 % of their time went to the kernel's page faults. The rehearsal
# raises both thresholds to 1 GiB; afterwards it sets them to what glibc's
# own adjustment reaches at most (32 MiB, trim 64 MiB) and trims the heap.
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
REHEARSAL_THRESHOLD = 1 << 30
MMAP_THRESHOLD_MAX = 32 << 20


def _libc():
    """glibc, or None where the C library is another."""
    name = ctypes.util.find_library("c")
    lib = ctypes.CDLL(name) if name else None
    return lib if lib is not None and hasattr(lib, "malloc_trim") else None


TOY = {"pillar.voxel_size": (0.4, 0.4), "depths": (16, 32),
       "refine.num_query": 64, "refine.num_ref": 128}


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def toy_patches() -> list:
    """``(object, attribute, value)`` of the phases' toy setting on the CPU:
    the CUDA-only calls stubbed (synchronize, events, memory statistics), a
    toy grid and batch, and every kernel wrapper replaced by a counting call
    of its plain version (the correlation's CPU images routed through its
    wrappers, as CUDA images are)."""
    from himo_tpu_torch.models import feedforward as pf
    from himo_tpu_torch.ops import correlation as pc
    from himo_tpu_torch.ops import voxelize as pv
    from himo_tpu_torch.ops.dt import DTConfig
    from himo_tpu_torch.training import trainer as pt

    # Route thresholds shrunk with the shapes: the main paths' toy 256x256
    # grid at 2,048 points takes the table route (as 512x512 at 65,536),
    # path A's 128x128 grid the resident route, path B's 4,096 points the
    # stream route; 3 x 2,048 points do not fuse.
    patches = [(pv, "_RESIDENT_BYTES", 16 * 1024 * 1024), (pv, "_TABLE_BYTES", 1536 * 1024)]
    for name, value in (("BATCH", 2), ("NUM_POINTS", 2048), ("FUSED_POINTS", 256),
                        ("GRID_256", {"pillar.voxel_size": (0.8, 0.8)}),
                        ("BIG_POINTS", 4096),
                        ("NN_SHAPES", ((128, 256), (256, 128))),
                        ("NN_NSFP_SHAPE", (1, 512, 512)),
                        ("SEGMENT_SHAPES", ((256, 2048), (512, 256))),
                        ("NSFP_POINTS", 512), ("NSFP_ITERS", 6), ("NSFP_PROFILE_ITERS", 2),
                        ("KNN_DUPLICATES", 16), ("HOST_POINTS", 64), ("HOST_ROWS", 128),
                        ("FASTNSF_DT", DTConfig(voxel_size=(3.2, 3.2, 1.6))),
                        ("CORR_SHAPE", (2, 32, 48, 32))):
        patches.append((cs, name, value))
    patches += [(torch.cuda, "synchronize", lambda *a, **k: None),
                (torch.cuda, "Event", _Event),
                (torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None),
                (torch.cuda, "max_memory_allocated", lambda *a, **k: 0),
                (torch.cuda, "empty_cache", lambda: None)]
    # No device to trace or to queue launches on: one timed call stands in.
    patches += [(cs, "device_ms", lambda fn, iters=20: cs.cuda_ms(fn, 1, 0)),
                (cs, "device_split", lambda fn, iters=20: {"kernel": cs.cuda_ms(fn, 1, 0)}),
                (cs, "cold_device_ms", lambda fn, iters=20: cs.cuda_ms(fn, 1, 0)),
                (cs, "host_us", lambda fn: cs.cuda_ms(fn, 1, 0) * 1e3)]
    make = pf.make_model
    patches += [
        (pf, "make_model", lambda name, device=None, **kw: make(
            name, device="cpu", **{**TOY, **kw})),
        (pt, "TrainConfig", functools.partial(
            pt.TrainConfig, batch_size=2, num_points=2048, loss_points=256)),
        (pv, "_run_max_kernel", lambda p, f, rows, flagged=None:
         pv._scatter_max_rows_plain(p, f, rows)),
        # The correlation's CPU images take the wrappers' path, as on the card.
        (pc, "_takes_kernels", lambda img: True),
    ]
    for (mod, name), plain in cs._wrappers().items():
        def counted(*args, _plain=plain, _name=name, _mod=mod):
            fn = getattr(_mod, _name)
            fn.launches += 1
            if _name == "sorted_segment_sum":  # K10 also counts by width
                c = args[1].shape[-1]
                fn.launches_by_c[c] = fn.launches_by_c.get(c, 0) + 1
            if _name == "correlation_backward":  # a launch a level with a cotangent
                fn.launches += sum(g is not None for g in args[0]) - 1
            return _plain(*args)

        counted.launches = 0
        counted.launches_by_c = {}
        patches.append((mod, name, counted))
    return patches


def rank_toy_setup() -> None:
    """The toy setting in a rank that ``chip_smoke.phase_data_parallel``
    spawns (``chip_smoke.DP_RANK_SETUP``): a fresh process, so the patches
    stay for its life; one torch thread."""
    for obj, name, value in toy_patches():
        setattr(obj, name, value)
    torch.set_num_threads(REHEARSAL_THREADS)


@pytest.fixture()
def rehearsal(monkeypatch):
    """The phases' toy setting on the CPU (:func:`toy_patches`); yields the
    device. The torch thread count is restored afterwards."""
    for obj, name, value in toy_patches():
        monkeypatch.setattr(obj, name, value)
    threads = torch.get_num_threads()
    torch.set_num_threads(REHEARSAL_THREADS)
    libc = _libc()
    if libc is not None:
        libc.mallopt(M_MMAP_THRESHOLD, REHEARSAL_THRESHOLD)
        libc.mallopt(M_TRIM_THRESHOLD, REHEARSAL_THRESHOLD)
    yield torch.device("cpu")
    torch.set_num_threads(threads)
    if libc is not None:
        libc.mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD_MAX)
        libc.mallopt(M_TRIM_THRESHOLD, 2 * MMAP_THRESHOLD_MAX)
        libc.malloc_trim(0)


def cpu_traced(fn):
    """``chip_smoke.traced`` on the CPU: the trace holds the host ranges and
    no device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, cs._trace_events(prof)
