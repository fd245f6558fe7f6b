#!/usr/bin/env python3
"""Split K9's device time into the reference walk and the inserts, on one
NVIDIA GPU.

    python3 scripts/torch_knn_probe.py

Builds three copies of ``himo_tpu_torch/csrc/knn.cu`` (nvcc, sm_90a, into a
temporary directory), each derived from the source by text substitution:

- ``kernel``: the source as it is (with the counters' definitions, unused);
- ``walk only``: the step's compare against the insert limit made against
  a limit read from device memory that is -inf, so that no step goes on to
  its inserts (the output is wrong; what is left is the walk: the
  distances, the `fminf`, the compare, the limit exchange and the merge);
- ``counted``: the kernel with three device counters, summed over warps:
  (query slot, step) pairs walked, those in which some lane of the warp
  had a distance below its limit (the step went on), and the lane
  distances inserted (the hits). The atomics slow it down: its time is
  not the kernel's.

and times each with CUDA events on ``nsfp``'s pair as ``knn_distance_sq``
pads it (1 x 65,536 x 65,537) at k = 1, 4, 8 and 16, and on the falling
cloud of ``scripts/torch_nn_ab.py`` at k = 4. One JSON object per variant
goes to standard output and all of them to ``chiprun_out/knn_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

KS = (1, 4, 8, 16)
COUNTERS = """
__device__ unsigned long long g_probe[3];
__device__ float g_floor = -INFINITY;
}  // namespace
extern "C" int probe_counters(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[3] = {0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe)));
}
namespace {
"""
TEST = "          if (low < lim[k]) {"
HITS = "            while (hits) {"


def variants(source: str) -> dict:
    """The three sources; raises if the kernel's text no longer has the
    lines the substitutions expect."""
    for line in (TEST, HITS, "namespace {\n"):
        if line not in source:
            raise RuntimeError(f"knn.cu changed: {line.strip()!r} not found")
    head = source.replace("namespace {\n", "namespace {\n" + COUNTERS, 1)
    walk = head.replace(TEST, "          if (low < g_floor) {")
    counted = head.replace(TEST, (
        "          if (lane == 0) atomicAdd(&g_probe[0], 1ull);\n"
        "          if (__any_sync(0xffffffffu, low < lim[k]) && lane == 0)\n"
        "            atomicAdd(&g_probe[1], 1ull);\n" + TEST))
    counted = counted.replace(HITS, (
        "            atomicAdd(&g_probe[2], static_cast<unsigned long long>(__popc(hits)));\n"
        + HITS))
    return {"kernel": head, "walk only": walk, "counted": counted}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_knn_probe.py needs a CUDA device", file=sys.stderr)
        return 2
    from himo_tpu_torch.kernels import _build
    from himo_tpu_torch.ops import nn as pnn

    device, smi = cs.phase_device()
    tmp = Path(tempfile.mkdtemp())
    sources = variants((_build.CSRC_DIR / "knn.cu").read_text())

    def build(item):
        name, text = item
        src = tmp / f"{name.replace(' ', '_')}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{proc.stdout}{proc.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(pool.map(build, sources.items()))
    pair = cs._nsfp_pair(device)
    pc0, pc1, _, _, v0, v1 = pair
    q = pnn._pad_coords(pc0[None], v0[None])
    r = pnn._pad_coords(pc1[None], v1[None])
    r = torch.cat([r, torch.full_like(r[:, :1], pnn.SENTINEL)], dim=1).contiguous()
    gen = torch.Generator(device=device).manual_seed(9)
    fq = torch.rand(1, 65536, 3, device=device, generator=gen)
    fr = torch.zeros(1, 65536, 3, device=device)
    fr[..., 0] = 2.0 + torch.arange(65536, 0, -1, device=device, dtype=torch.float32) * 1e-3
    cases = [(f"nsfp pair k={k}", q, r, k) for k in KS]
    cases.append(("falling k=4", fq, fr.contiguous(), 4))
    rows = []
    for name, lib in libs.items():
        fn = lib.himo_knn_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        counters = lib.probe_counters
        counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
        row = dict(variant=name, card=smi)
        for case, a, b, k in cases:
            out = torch.empty(1, a.shape[1], k, device=device)

            def call():
                code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, a.shape[1], b.shape[1],
                          k, torch.cuda.current_stream().cuda_stream)
                assert code == 0, code

            entry = dict(ms=cs.cuda_ms(call, iters=10, warmup=2))
            if name == "counted":
                buf = (ctypes.c_ulonglong * 3)()
                counters(buf, 1)
                call()
                torch.cuda.synchronize()
                counters(buf, 0)
                steps, went_on, hits = list(buf)
                entry.update(steps=steps, steps_went_on=went_on, hits=hits,
                             hits_per_query=hits / a.shape[1])
            row[case] = entry
        cs.log(json.dumps(row))
        rows.append(row)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "knn_probe.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
