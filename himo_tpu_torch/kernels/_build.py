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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same content exists;
    return the library's path (nvcc's output is beside it, ``.log``).
    Raises with nvcc's output on failure."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its ``argtypes``. Every entry point returns an int
    (a ``cudaError_t``)."""
    if name not in _LOADED:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} (a cudaError_t)")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


PTR = ctypes.c_void_p
INT = ctypes.c_int
