"""Compile ``himo_tpu_torch/csrc/<name>.cu`` with ``nvcc`` and load it with ctypes.

Each source becomes one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so a library is
built on first use and again whenever its source changes; an existing
library for the same content is loaded as it is. The build goes through a
temporary file and an atomic rename, so processes that build the same
source at once never load a half-written library. ``nvcc``'s output (the
``-Xptxas -v`` register and shared-memory report) is kept beside the
library as ``<name>-<hash>.log``.

Kernels are bound with ``ctypes`` and not through PyTorch's C++ extension
builder: a source that includes PyTorch's headers takes minutes to compile,
one with a plain C interface seconds. Pointers and the CUDA stream pass as
``ctypes.c_void_p``; every entry point returns ``cudaGetLastError()``, and
:func:`check` raises when it is not 0.

Every kernel wrapper launches through an :class:`Entry`, which keeps its
per-call host work small (kernels at the train step's small shapes take
about 5 us of device time, so the wrapper's host time is what a caller
waits for): the entry point is built, loaded and given its ``argtypes`` on
its first launch and called as a cached ctypes function afterwards, and
PyTorch's current stream is read as a raw handle, with no
``torch.cuda.Stream`` object made per call. The launch runs with the
tensors' device current (a ``<<<>>>`` launch goes to the calling thread's
current device, whatever device its stream and pointers belong to); when
that device is already current, the guard is one comparison. :func:`check_args` is the
wrappers' shared argument check, one pass over the tensors when they are
what the kernels take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, then ``PATH``, then the toolkit's
    standard install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_library(lib: Path, compiler: str, flags, source: Path) -> Path:
    """``compiler flags -o lib source`` unless ``lib`` exists, through a
    temporary file and an atomic rename; the compiler's output is kept
    beside the library (``.log``). Raises with that output on failure."""
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{Path(compiler).name} failed for {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same content exists;
    return the library's path (nvcc's output is beside it, ``.log``).
    Raises with nvcc's output on failure."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    return compile_library(lib, nvcc_path(), NVCC_FLAGS, CSRC_DIR / f"{name}.cu")


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} (a cudaError_t)")


def library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library, built if needed and loaded once per
    process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib


class Entry:
    """One C entry point ``name`` of ``csrc/<source>.cu`` taking ``argtypes``
    and then the CUDA stream, returning a ``cudaError_t``.

    The first :meth:`launch` builds and loads the library and sets the
    entry point's ``argtypes`` (without them ctypes would pass pointers as
    32-bit ints); later launches reuse that ctypes function. Two entries of
    one library share its one load."""

    __slots__ = ("source", "name", "argtypes", "_fn", "_stream", "_get_device",
                 "_set_device")

    def __init__(self, source: str, name: str, argtypes):
        self.source, self.name = source, name
        self.argtypes = (*argtypes, PTR)
        self._fn = None
        self._stream = self._get_device = self._set_device = None

    def bind(self):
        """Bind the entry point (once) and return its ctypes function."""
        if self._fn is None:
            fn = getattr(library(self.source), self.name)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            # PyTorch's current stream on a device index, as an int: what
            # ``torch.cuda.current_stream(i).cuda_stream`` gives, without
            # the Stream object (torch._inductor launches its kernels the
            # same way).
            self._stream = torch._C._cuda_getCurrentRawStream
            # The calling thread's current device, and its setter: what
            # ``torch.cuda.device(i)`` exchanges, without the context
            # manager.
            self._get_device = torch._C._cuda_getDevice
            self._set_device = torch._C._cuda_setDevice
            self._fn = fn
        return self._fn

    def launch(self, device_index: int, *args) -> None:
        """Call the entry point with ``args`` and PyTorch's current stream
        on CUDA device ``device_index`` (a ``torch.cuda.stream(...)``
        context is honoured), with that device current for the call; raise
        on a CUDA error.

        A ``<<<>>>`` launch runs on the calling thread's current device, so
        when ``device_index`` is not current it is made current for the
        call and the previous device restored afterwards, also when the
        call raises, as PyTorch's device guard does; when it is current
        (the usual case) the guard costs one comparison."""
        fn = self._fn or self.bind()
        current = self._get_device()
        switch = current != device_index
        if switch:
            self._set_device(device_index)
        try:
            code = fn(*args, self._stream(device_index))
        finally:
            if switch:
                self._set_device(current)
        check(code, self.name)


def check_args(what: str, f32=(), i32=()) -> None:
    """Raise unless every tensor of ``f32`` is float32 and every tensor of
    ``i32`` int32 (``TypeError``), all contiguous and on one device
    (``ValueError``): what the kernels take. Shapes are the caller's to
    check. One pass when the tensors pass."""
    tensors = (*f32, *i32)
    device = tensors[0].device
    for want, group in ((torch.float32, f32), (torch.int32, i32)):
        for t in group:
            if t.dtype is not want or not t.is_contiguous() or t.device != device:
                break
        else:
            continue
        break
    else:
        return
    if any(t.dtype is not torch.float32 for t in f32) or any(
            t.dtype is not torch.int32 for t in i32):
        raise TypeError(f"{what} takes float32 values and int32 ids, got "
                        f"{[t.dtype for t in f32]} and {[t.dtype for t in i32]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous inputs")
    raise ValueError(f"{what}: inputs on different devices "
                     f"{sorted({str(t.device) for t in tensors})}")


PTR = ctypes.c_void_p
INT = ctypes.c_int
