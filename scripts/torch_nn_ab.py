#!/usr/bin/env python3
"""Hold the port's NN kernels against another checkout's, on one NVIDIA GPU.

    python3 scripts/torch_nn_ab.py ROOT [ROOT ...]

K7 (``nn_argmin_rows``, ``csrc/nn.cu``) and K8 (``fused_nn_idx`` and
``fused_nn``, ``csrc/fused_nn.cu``) of this checkout run through their
wrappers; each ROOT's ``himo_tpu_torch/csrc/nn.cu`` and ``fused_nn.cu`` are
built with nvcc (sm_90a) into a temporary directory and called through
ctypes at their own C signatures (the fused entry points took no scratch
pointer before this checkout's one-pass kernel). On the same inputs every
ROOT's outputs must equal this checkout's bit for bit, values and indices,
and on quarter-metre grid coordinates (every squared distance exact in both
forms) this checkout's must equal the plain versions' bit for bit.

Inputs, all made on the card from fixed seeds:

- K7 on ``chip_smoke.py``'s uniform clouds (B8 4096x8192 and 8192x4096),
  on the ten calls one 512² ``seflowpp`` forward makes (captured from the
  refine head, random weights from seed 0), on ``nsfp``'s frame pair
  (1 x 65,536 x 65,536, invalid points at the sentinel), on grid
  coordinates, and on a cloud whose distance falls with the index (every
  chunk lowers every query's min);
- K8 on the train step's chamfer samples (B8 16,384x16,384 with its masks
  as penalties) and on grid coordinates with random masks.

Each case is timed by traced device time (``chip_smoke.device_ms``:
kernels and memsets) in turns, this checkout then each ROOT, then back. One
JSON object per case goes to standard output and to ``chiprun_out/nn_ab.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

PTR, INT = ctypes.c_void_p, ctypes.c_int
ROUNDS = 2  # A, B..., B..., A: each side timed twice


class Library:
    """A checkout's nn.cu and fused_nn.cu, built and bound at their ABI."""

    def __init__(self, root: Path, out: Path):
        from himo_tpu_torch.kernels import _build

        self.root = root
        src = root / "himo_tpu_torch" / "csrc"
        procs = {}
        for name in ("nn", "fused_nn"):
            lib = out / f"{name}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / f"{name}.cu")]
            procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        self.libs = {}
        for name, (lib, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {root} {name}.cu:\n{log}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {root.name}/{name}: {line.strip()}")
            self.libs[name] = ctypes.CDLL(str(lib))
        scratch = "void* scratch" in (src / "fused_nn.cu").read_text()
        self.argmin = self._bind("nn", "himo_nn_argmin_f32", 4)
        self.fused = self._bind("fused_nn", "himo_fused_nn_f32", 10 + scratch)
        self.fused_idx = self._bind("fused_nn", "himo_fused_nn_idx_f32", 14 + scratch)
        self.scratch = scratch

    def _bind(self, lib, name, ptrs):
        fn = getattr(self.libs[lib], name)
        fn.argtypes = [PTR] * ptrs + [INT] * 3 + [PTR]
        fn.restype = ctypes.c_int
        return fn

    def nn_argmin_rows(self, q, r):
        import torch

        b, n, m = q.shape[0], q.shape[1], r.shape[1]
        d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
        idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
        code = self.argmin(q.data_ptr(), r.data_ptr(), d2.data_ptr(), idx.data_ptr(), b, n, m,
                           torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return d2, idx

    def _fused(self, fn, with_idx, q, r, *pens):
        import torch

        b, n, m = q.shape[0], q.shape[1], r.shape[1]
        outs = [torch.empty((b, k), dtype=torch.float32, device=q.device) for k in (n, n, m, m)]
        if with_idx:
            outs += [torch.empty((b, k), dtype=torch.int32, device=q.device)
                     for k in (n, n, m, m)]
        extra = []
        if self.scratch:
            extra = [torch.empty(2 * b * (n + m), dtype=torch.int64, device=q.device)]
        code = fn(q.data_ptr(), r.data_ptr(), *(p.data_ptr() for p in pens),
                  *(o.data_ptr() for o in outs), *(e.data_ptr() for e in extra), b, n, m,
                  torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return tuple(outs)

    def fused_nn(self, *args):
        return self._fused(self.fused, False, *args)

    def fused_nn_idx(self, *args):
        return self._fused(self.fused_idx, True, *args)


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def k7_cases(device):
    """(name, [(q, r), ...]) for K7; a case of several calls is timed as
    their sum."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    cases = []
    for n, m in cs.NN_SHAPES:
        q, r, _ = cs._nn_inputs(device, n, m, seed=n + m)
        cases.append((f"uniform B{cs.BATCH} {n}x{m}", [(q, r)]))
    cases.append(("slice 512² forward, its 10 calls", _slice_calls(device)))
    pc0, pc1, _, _, v0, v1 = cs._nsfp_pair(device)
    cases.append(("nsfp pair 1x65536x65536",
                  [(pnn._pad_coords(pc0[None], v0[None]), pnn._pad_coords(pc1[None], v1[None]))]))
    rng = cs.np.random.default_rng(5)
    q, r = (torch.from_numpy(a).to(device) for a in _grid(rng, cs.BATCH, 4096, 8192))
    cases.append((f"grid B{cs.BATCH} 4096x8192", [(q, r)]))
    gen = torch.Generator(device=device).manual_seed(6)
    q = torch.rand(cs.BATCH, 4096, 3, device=device, generator=gen)
    steps = torch.arange(8192, 0, -1, device=device, dtype=torch.float32)
    r = torch.zeros(cs.BATCH, 8192, 3, device=device)
    r[..., 0] = 2.0 + steps * 0.01  # farther first: every chunk lowers the min
    cases.append((f"falling B{cs.BATCH} 4096x8192", [(q, r.contiguous())]))
    return cases


def _grid(rng, b, n, m):
    q = rng.integers(-32, 33, size=(b, n, 3)).astype(cs.np.float32) / 4
    r = rng.integers(-32, 33, size=(b, m, 3)).astype(cs.np.float32) / 4
    r[:, m // 2 : m // 2 + 20] = r[:, :20]
    q[:, :10] = r[:, :10]
    return q, r


def _slice_calls(device):
    """The (q, r) of every ``nn_argmin_rows`` call of one 512² forward."""
    import torch

    from himo_tpu_torch.models.feedforward import frame, init_params, make_model
    from himo_tpu_torch.ops import nn as pnn

    pc0, pc1, pch, valid, dt0, _ = cs._clouds(device)
    model, _ = make_model("seflowpp", device=device, dtype="bfloat16")
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    calls, original = [], pnn.nn_argmin_rows

    def record(q, r):
        calls.append((q.clone(), r.clone()))
        return original(q, r)

    record.launches = 0  # the wrapper counts on the module's attribute
    pnn.nn_argmin_rows = record
    try:
        with torch.no_grad():
            frame(model, pc0, pc1, pch, valid, dt0)
    finally:
        pnn.nn_argmin_rows = original
    torch.cuda.synchronize()
    return calls


def k8_cases(device):
    import torch

    from himo_tpu_torch.ops import nn as pnn

    cases = [(f"train samples B{cs.BATCH} 16384x16384", cs._fused_inputs(device))]
    rng = cs.np.random.default_rng(7)
    q, r = (torch.from_numpy(a).to(device) for a in _grid(rng, cs.BATCH, 16384, 16384))
    pens = [torch.from_numpy(cs.np.where(rng.random((cs.BATCH, k)) < 0.8, 0.0, pnn._MASK_BIG)
                             .astype(cs.np.float32)).to(device) for k in (16384,) * 4]
    cases.append((f"grid B{cs.BATCH} 16384x16384", (q, r, *pens)))
    return cases


def main(argv) -> int:
    import torch

    if not argv or not torch.cuda.is_available():
        print("usage: torch_nn_ab.py ROOT [ROOT ...] (needs a CUDA device)", file=sys.stderr)
        return 2
    from himo_tpu_torch.ops import nn as pnn

    device, smi = cs.phase_device()
    cs.phase_build()
    tmp = tempfile.TemporaryDirectory()
    roots = []
    for k, root in enumerate(argv):
        out = Path(tmp.name) / str(k)
        out.mkdir()
        roots.append(Library(Path(root).resolve(), out))
    results = []

    def run(name, calls, here, there, plain=None):
        """``here`` is this checkout's wrapper, ``there(lib)`` a ROOT's."""
        got = [here(*a) for a in calls]
        for lib in roots:
            other = [there(lib)(*a) for a in calls]
            torch.cuda.synchronize()
            for g, o in zip(got, other):
                if not _same(g, o):
                    raise AssertionError(f"{name}: differs from {lib.root}")
        if plain is not None:
            for g, a in zip(got, calls):
                if not _same(g, plain(*a)):
                    raise AssertionError(f"{name}: differs from the plain version")
        sides = [("this", lambda: [here(*a) for a in calls])]
        sides += [(str(lib.root), (lambda fn=there(lib): [fn(*a) for a in calls]))
                  for lib in roots]
        times = {label: [] for label, _ in sides}
        for order in (sides, sides[::-1]) * (ROUNDS // 2):
            for label, call in order:
                times[label].append(cs.device_ms(call, iters=10))
        row = dict(case=name, bitwise_vs_roots=True, bitwise_vs_plain=plain is not None,
                   device_ms=times, card=smi)
        cs.log(json.dumps(row))
        results.append(row)

    for name, calls in k7_cases(device):
        plain = pnn._nn_argmin_plain if name.startswith("grid") else None
        run(f"K7 {name}", calls, pnn.nn_argmin_rows, lambda lib: lib.nn_argmin_rows, plain)
    for name, args in k8_cases(device):
        grid = name.startswith("grid")
        run(f"K8 idx {name}", [args], pnn.fused_nn_idx, lambda lib: lib.fused_nn_idx,
            pnn._fused_nn_plain if grid else None)
        run(f"K8 min {name}", [args], pnn.fused_nn, lambda lib: lib.fused_nn,
            (lambda *a: pnn._fused_nn_plain(*a)[:4]) if grid else None)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "nn_ab.json").write_text(json.dumps(results, indent=1))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
