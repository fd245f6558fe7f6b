"""ctypes bindings for the himo_native C++ host library (port of
``himo_tpu/native.py`` over the package's own copy of the source,
``csrc/himo_native.cpp``).

The library holds the host-side hot loops: a 3-D KD-tree (float32, the
reference's bucketed tree) with multi-threaded k-NN queries, the symmetric
Chamfer distance of the eval, raw attribute-file reads, io_uring page-cache
warming of scene files, the threaded pad-and-stack batch packer, and the
LZ4 frame decoder of the feather reader (``io/arrow.py``). ctypes
releases the interpreter lock for the length of each call, so the packer
and the preload run beside the thread that dispatches to the GPU.

It is built with the reference's flags (``native/Makefile``)

    g++ -O3 -march=native -fPIC -std=c++17 -pthread -Wall -shared

into ``_build/himo_native-<hash>.so`` at first use. The name carries a hash
of the source, the flags and what ``-march=native`` means on this machine
(a checkout copied to another host builds its own), so a changed source is
rebuilt. :func:`available` is False only where no C++ compiler exists (and
nothing was built); every consumer then takes the reference's scipy branch,
as the reference does where its library is absent. A compiler that fails,
or a library that does not load, raises with the compiler's output: nothing
quietly degrades.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "himo_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def compiler() -> Optional[str]:
    """The C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on ``PATH``;
    None when there is none."""
    cxx = os.environ.get("CXX")
    if cxx:
        return shutil.which(cxx) or cxx
    return shutil.which("g++") or shutil.which("c++")


def _library_path(cxx: str) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((cxx, *CXX_FLAGS)).encode())
    # What -march=native selects here: a library built for one CPU may not
    # run on another that shares the checkout.
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True)
    digest.update(target.stdout.encode())
    return BUILD_DIR / f"himo_native-{digest.hexdigest()[:16]}.so"


def build(cxx: str) -> Path:
    """Compile the library unless a build of the same content exists; return
    its path (the compiler's output beside it, ``.log``). Raises with the
    compiler's output on failure."""
    from himo_tpu_torch.kernels._build import compile_library

    return compile_library(_library_path(cxx), cxx, CXX_FLAGS, SOURCE)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    i32 = ctypes.c_int32
    lib.himo_kd_build.restype = ctypes.c_void_p
    lib.himo_kd_build.argtypes = [f32p, i32]
    lib.himo_kd_free.restype = None
    lib.himo_kd_free.argtypes = [ctypes.c_void_p]
    lib.himo_kd_query.restype = None
    lib.himo_kd_query.argtypes = [ctypes.c_void_p, f32p, i32, f32p, i32p, i32]
    lib.himo_kd_query_k.restype = None
    lib.himo_kd_query_k.argtypes = [ctypes.c_void_p, f32p, i32, i32, f32p, i32p, i32]
    lib.himo_chamfer.restype = None
    lib.himo_chamfer.argtypes = [f32p, i32, f32p, i32, ctypes.POINTER(ctypes.c_double), i32]
    lib.himo_read_attr.restype = ctypes.c_int64
    lib.himo_read_attr.argtypes = [ctypes.c_char_p, i32, ctypes.c_void_p, ctypes.c_int64]
    lib.himo_preload_files.restype = ctypes.c_int64
    lib.himo_preload_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32, i32]
    lib.himo_pack_frames.restype = None
    lib.himo_pack_frames.argtypes = [ctypes.POINTER(f32p), i32p, i32, i32, i32, f32p,
                                     ctypes.POINTER(ctypes.c_uint8), i32]
    lib.himo_lz4_frame_decode.restype = ctypes.c_int64
    lib.himo_lz4_frame_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                          ctypes.c_int64]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once per process; None when there is no
    compiler."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            cxx = compiler()
            if cxx is None:
                return None
            _lib = _bind(ctypes.CDLL(str(build(cxx))))
    return _lib


def available() -> bool:
    """True when the library is (or can be) built here."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("himo_native: no C++ compiler (set CXX or install g++)")
    return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _default_threads() -> int:
    return min(os.cpu_count() or 1, 16)


class KDTree:
    """Native 3-D KD-tree; drop-in for the NN part of scipy's ``cKDTree``."""

    def __init__(self, points: np.ndarray):
        self._lib = _require()
        self._points = np.ascontiguousarray(points[:, :3], dtype=np.float32)
        self._handle = self._lib.himo_kd_build(_fptr(self._points), len(self._points))

    def query(self, queries: np.ndarray, k: int = 1, nthreads: Optional[int] = None):
        """(distances, indices) of the ``k`` nearest tree points per query
        row, ``cKDTree.query``'s form: ``k=1`` gives (n,) arrays, ``k>1``
        (n, k) sorted ascending (unfilled slots: inf / -1). Distances are
        float32, indices int32."""
        q = np.ascontiguousarray(queries[:, :3], dtype=np.float32)
        n = len(q)
        threads = nthreads or _default_threads()
        i32p = ctypes.POINTER(ctypes.c_int32)
        if k == 1:
            d2 = np.empty(n, dtype=np.float32)
            idx = np.empty(n, dtype=np.int32)
            self._lib.himo_kd_query(self._handle, _fptr(q), n, _fptr(d2),
                                    idx.ctypes.data_as(i32p), threads)
            return np.sqrt(d2), idx
        d2 = np.empty((n, k), dtype=np.float32)
        idx = np.empty((n, k), dtype=np.int32)
        self._lib.himo_kd_query_k(self._handle, _fptr(q), n, k, _fptr(d2),
                                  idx.ctypes.data_as(i32p), threads)
        d2[idx < 0] = np.inf  # unfilled slots (tree smaller than k)
        return np.sqrt(d2), idx

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.himo_kd_free(self._handle)
            self._handle = None


def chamfer(pc1: np.ndarray, pc2: np.ndarray, nthreads: Optional[int] = None) -> float:
    """Symmetric mean-NN Chamfer distance, the eval's definition:
    ``(mean(min_dist(pc1->pc2)) + mean(min_dist(pc2->pc1))) / 2``."""
    lib = _require()
    a = np.ascontiguousarray(pc1[:, :3], dtype=np.float32)
    b = np.ascontiguousarray(pc2[:, :3], dtype=np.float32)
    out = np.empty(2, dtype=np.float64)
    lib.himo_chamfer(_fptr(a), len(a), _fptr(b), len(b),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     nthreads or _default_threads())
    return float((out[0] + out[1]) / 2.0)


def read_attr(path, dtype: str) -> np.ndarray:
    """A raw attribute file (``float32``, ``int32`` or ``int8``, read as
    int32) as a flat array."""
    lib = _require()
    code = {"float32": 0, "int32": 1, "int8": 2}[dtype]
    size = os.path.getsize(path)
    n = size // 4 if code in (0, 1) else size
    out = np.empty(n, dtype=np.float32 if code == 0 else np.int32)
    got = lib.himo_read_attr(str(path).encode(), code, out.ctypes.data_as(ctypes.c_void_p), n)
    if got < 0:
        raise IOError(f"failed to read {path}")
    return out[:got]


def preload_files(paths, queue_depth: int = 32) -> int:
    """Warm the page cache for upcoming scene files (io_uring reads, or
    ``posix_fadvise(WILLNEED)`` where io_uring is unavailable); returns the
    bytes read or advised. The fleet's and the trainer's producers call it
    for the scenes they read next."""
    lib = _require()
    encoded = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    return int(lib.himo_preload_files(arr, len(encoded), queue_depth))


def pack_frames(frames, target: int,
                nthreads: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (zeros) and stack (n_i, C) float32 frames, each cut to ``target``
    rows: ((B, target, C) float32, (B, target) bool valid rows)."""
    lib = _require()
    frames = [np.ascontiguousarray(f, dtype=np.float32) for f in frames]
    cols = frames[0].shape[1]
    if any(f.ndim != 2 or f.shape[1] != cols for f in frames):
        raise ValueError(f"pack_frames: frames of shapes {[f.shape for f in frames]}")
    b = len(frames)
    batch = np.empty((b, target, cols), dtype=np.float32)
    valid = np.empty((b, target), dtype=np.uint8)
    ptrs = (ctypes.POINTER(ctypes.c_float) * b)(*[_fptr(f) for f in frames])
    ns = np.array([len(f) for f in frames], dtype=np.int32)
    lib.himo_pack_frames(ptrs, ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), b, cols,
                         target, _fptr(batch.reshape(-1)),
                         valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         nthreads or _default_threads())
    return batch, valid.astype(bool)


LZ4_ERRORS = {-1: "a malformed frame", -2: "more output than expected",
              -3: "a corrupt block", -4: "a frame that needs a dictionary",
              -5: "a content size that differs from the output", -6: "a truncated frame"}


def lz4_frame_decode(data: bytes, size: int) -> bytes:
    """The ``size`` bytes that the LZ4 frame ``data`` holds (the format
    ``io/lz4.decode_frame`` decodes); raises unless the frame holds exactly
    ``size`` bytes."""
    lib = _require()
    data = bytes(data)
    out = bytearray(size)
    buf = (ctypes.c_char * size).from_buffer(out) if size else None
    got = lib.himo_lz4_frame_decode(data, len(data), buf, size)
    if got < 0:
        raise ValueError(f"lz4: {LZ4_ERRORS.get(got, f'error {got}')}")
    if got != size:
        raise ValueError(f"lz4: frame holds {got} bytes, not the {size} expected")
    return bytes(out)
