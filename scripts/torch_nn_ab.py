#!/usr/bin/env python3
"""Hold the port's streaming-NN, k-NN, sorted-scatter and sorted-take
kernels against another checkout's, on one NVIDIA GPU.

    python3 scripts/torch_nn_ab.py [--only K6,K7,K8,K9,K2,K5] ROOT [ROOT ...]

K6 (``nn_min_rows``) and K7 (``nn_argmin_rows``, both ``csrc/nn.cu``), K8
(``fused_nn_idx`` and ``fused_nn``, ``csrc/fused_nn.cu``), K9
(``knn_rows``, ``csrc/knn.cu``) and K2 (``sorted_scatter_max_rows`` and
``sorted_scatter_sum_rows``, with K10's ``sorted_segment_sum``,
``csrc/sorted_scatter.cu``) and K5 (``sorted_gather_rows``,
``csrc/sorted_gather.cu``) of this checkout run through their wrappers;
each ROOT's sources that the chosen kernels need are built with nvcc
(sm_90a) into a temporary directory and called through ctypes at their own
C signatures (the fused entry points took no scratch pointer before the
one-pass K8; the sorted max took a scratch map of run starts before the
run-based K2 max, the sorted sums before the run-based sums). On the same
inputs every ROOT's outputs must equal this checkout's bit for bit, values
and indices, and on quarter-metre grid coordinates (every squared distance
exact in both forms) this checkout's K6, K7, K8 and K9 must equal the plain
versions' bit for bit; K6 must also equal K7's d2 on every input; K2 max
must equal its plain version on every input, and the sums must equal
themselves from launch to launch; K5 must equal its plain version on every
input. ``--only`` runs the named kernels' cases alone.

Inputs, all made on the card from fixed seeds:

- K6 on the one call one 512² ``seflowpp`` forward makes (captured from
  the refine head's score pass, random weights from seed 0), on
  ``chip_smoke.py``'s uniform clouds (B8 4096x8192 and 8192x4096), on grid
  coordinates, on a cloud whose distance falls with the index (every
  reference lowers every query's min), on coordinates with NaN and +-inf
  entries (B2 1000x3000: such distances never win, a query with none
  finite gets +inf), and on ``nsfp``'s frame pair (1 x 65,536 x 65,536, off
  the path today: the chamfer of the eval port);

- K7 on ``chip_smoke.py``'s uniform clouds (B8 4096x8192 and 8192x4096),
  on the ten calls one 512² ``seflowpp`` forward makes (captured from the
  refine head, random weights from seed 0), on ``nsfp``'s frame pair
  (1 x 65,536 x 65,536, invalid points at the sentinel), on grid
  coordinates, and on a cloud whose distance falls with the index (every
  chunk lowers every query's min);
- K8 on the train step's chamfer samples (B8 16,384x16,384 with its masks
  as penalties) and on grid coordinates with random masks;
- K9 on ``nsfp``'s pair as ``knn_distance_sq`` pads it (1 x 65,536 x
  65,537) at k = 1, 4, 8 and 16, on ``chip_smoke.phase_knn``'s duplicate
  case (k = 4), on grid coordinates (B2 4096x8192, k = 4 and 16) and on a
  cloud whose distance falls with the index (1 x 65,536 x 65,536, k = 4:
  every reference enters every list);
- K2 max on path B's three pools (B8 x 131,072 x 32, ReLU'd features, the
  sweeps' pillar ids sorted as the stream route sorts them), the
  dynamic-image loss's max (C = 1, values 0 or 1), signed features (-0.0,
  -inf) and a frame with a 50,000-point run beside a frame of ids >= rows;
  this checkout's device time also split by pass;
- K2 sum on path B's gather backward (B8 x 131,072 x 65 cotangents), K10
  on ``mean_sorted``'s pool (B8 x 65,536 x 33, rounding off and on) and on
  the ``mean_sorted`` train step's gather backward (B8 x 65,536 x 65
  cotangents at the same sorted ids, rounding off and on), and both on the
  50,000-point run beside a frame of ids >= rows (K2 sum at C = 65, K10 at
  C = 33 rounding on); this checkout's device time split by pass;
- K5 on the 512² train step's take (a B8 x 65,536 x 64 (cotangent, max)
  image at the stable sort of the main path's first-sweep pillar ids), on
  path B's (B8 x 131,072), on SegNet's shape (1 x 32,768 x 64, the first
  frame of 32,768-point clouds), on a 50,000-id run beside a frame whose
  ids are all >= rows (B2 x 60,000 x 64), and on the 512² ids at C = 65
  and C = 1 (rows of single-float words); SegNet's shape also with a cold
  L2.

Each case is timed by traced device time (``chip_smoke.device_ms``:
kernels and memsets) in turns, this checkout then each ROOT, then back,
four times a side (designs differ by 2-5 %, about the spread between
runs); while K6's cases run back to back, ``nvidia-smi`` samples the SM
clock and power draw. One JSON object per case goes to standard output
and to ``chiprun_out/nn_ab.json``.
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
ROUNDS = 4  # (A, B..., B..., A) twice: each side timed four times
CLOCK_SECONDS = 2.0  # K6: this checkout's calls looped while nvidia-smi samples
SOURCE_OF = {"K6": "nn", "K7": "nn", "K8": "fused_nn", "K9": "knn", "K2": "sorted_scatter",
             "K5": "sorted_gather"}
KERNELS = tuple(SOURCE_OF)


class Library:
    """A checkout's nn.cu, fused_nn.cu, knn.cu, sorted_scatter.cu and
    sorted_gather.cu (those of ``sources``), built and bound at their ABI."""

    def __init__(self, root: Path, out: Path, sources):
        from himo_tpu_torch.kernels import _build

        self.root = root
        src = root / "himo_tpu_torch" / "csrc"
        procs = {}
        for name in sources:
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
        if "nn" in self.libs:
            self.min = self._bind("nn", "himo_nn_min_f32", 3)
            self.argmin = self._bind("nn", "himo_nn_argmin_f32", 4)
        if "fused_nn" in self.libs:
            scratch = "void* scratch" in (src / "fused_nn.cu").read_text()
            self.fused = self._bind("fused_nn", "himo_fused_nn_f32", 10 + scratch)
            self.fused_idx = self._bind("fused_nn", "himo_fused_nn_idx_f32", 14 + scratch)
            self.scratch = scratch
        if "knn" in self.libs:
            self.knn = self._bind("knn", "himo_knn_f32", 3, ints=4)
        if "sorted_scatter" in self.libs:
            self._bind_sorted(src)
        if "sorted_gather" in self.libs:
            self.take = self._bind("sorted_gather", "himo_sorted_gather_rows_f32", 4, ints=4)

    def _bind_sorted(self, src):
        # The run-based max takes (spids, sfeats, out, B, N, C, rows); the
        # earlier one a scratch map `first` after sfeats.
        text = (src / "sorted_scatter.cu").read_text()
        signature = text[text.index("himo_sorted_scatter_max_f32("):].split(")")[0]
        self.first_max = "first" in signature
        self.smax = self._bind("sorted_scatter", "himo_sorted_scatter_max_f32",
                               3 + self.first_max, ints=4)
        # The run-based sums take no scratch; the earlier ones `first`.
        signature = text[text.index("himo_sorted_scatter_sum_f32("):].split(")")[0]
        self.first_sum = "first" in signature
        self.ssum = self._bind("sorted_scatter", "himo_sorted_scatter_sum_f32",
                               3 + self.first_sum, ints=4)
        self.segsum = self._bind("sorted_scatter", "himo_sorted_segment_sum_f32",
                                 3 + self.first_sum, ints=5)

    def _bind(self, lib, name, ptrs, ints=3):
        fn = getattr(self.libs[lib], name)
        fn.argtypes = [PTR] * ptrs + [INT] * ints + [PTR]
        fn.restype = ctypes.c_int
        return fn

    def knn_rows(self, q, r, k):
        import torch

        b, n, m = q.shape[0], q.shape[1], r.shape[1]
        out = torch.empty((b, n, k), dtype=torch.float32, device=q.device)
        code = self.knn(q.data_ptr(), r.data_ptr(), out.data_ptr(), b, n, m, k,
                        torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out

    def _sorted(self, fn, spids, svals, rows, *flags, first=True):
        import torch

        b, n, c = svals.shape
        out = torch.empty((b, rows, c), dtype=torch.float32, device=svals.device)
        scratch = torch.empty((b, rows), dtype=torch.int32, device=svals.device)
        ptrs = [spids.data_ptr(), svals.data_ptr()] + [scratch.data_ptr()] * first
        code = fn(*ptrs, out.data_ptr(), b, n, c, rows, *flags,
                  torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out

    def sorted_max(self, spids, sfeats, rows):
        return self._sorted(self.smax, spids, sfeats, rows, first=self.first_max)

    def sorted_sum(self, spids, svals, rows):
        return self._sorted(self.ssum, spids, svals, rows, first=self.first_sum)

    def segment_sum(self, spids, svals, rows, bf16):
        return self._sorted(self.segsum, spids, svals, rows, int(bf16), first=self.first_sum)

    def sorted_gather(self, image, spids, order):
        import torch

        b, rows, c = image.shape
        n = spids.shape[1]
        out = torch.empty((b, n, c), dtype=torch.float32, device=image.device)
        code = self.take(spids.data_ptr(), order.data_ptr(), image.data_ptr(), out.data_ptr(),
                         b, n, c, rows, torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out

    def nn_min_rows(self, q, r):
        import torch

        b, n, m = q.shape[0], q.shape[1], r.shape[1]
        d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
        code = self.min(q.data_ptr(), r.data_ptr(), d2.data_ptr(), b, n, m,
                        torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return d2

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


def _device_ms(call, tries: int = 3) -> float:
    """``chip_smoke.device_ms`` of ``call`` over 10 calls, taken again (up
    to ``tries`` times) when the trace lacked device events in half its
    calls or more."""
    for attempt in range(tries):
        try:
            return cs.device_ms(call, iters=10)
        except AssertionError as err:
            cs.log(f"  trace lost events ({err}); again")
            if attempt == tries - 1:
                raise


def _clocks_under(call, seconds: float = CLOCK_SECONDS) -> dict:
    """The card's SM clock (MHz) and power draw (W), sampled every 100 ms by
    ``nvidia-smi`` while ``call`` runs back to back for ``seconds``: the
    median of each and the number of samples."""
    import statistics
    import time

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return dict(sm_mhz=None, power_w=None, samples=0)
    return dict(sm_mhz=statistics.median(r[0] for r in rows),
                power_w=statistics.median(r[1] for r in rows), samples=len(rows))


def _same(a, b) -> bool:
    """Bit for bit: value tuples by ``torch.equal`` (indices, and floats
    where +0.0 and -0.0 never meet), a single fp32 tensor by its bits."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def k6_cases(device):
    """(name, [(q, r), ...]) for K6; a case of several calls is timed as
    their sum."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    cases = [("slice 512² forward, its call", _slice_calls(device, "nn_min_rows"))]
    for n, m in cs.NN_SHAPES:
        q, r, _ = cs._nn_inputs(device, n, m, seed=n + m)
        cases.append((f"uniform B{cs.BATCH} {n}x{m}", [(q, r)]))
    rng = cs.np.random.default_rng(15)
    q, r = (torch.from_numpy(a).to(device) for a in _grid(rng, cs.BATCH, 4096, 8192))
    cases.append((f"grid B{cs.BATCH} 4096x8192", [(q, r)]))
    cases.append((f"falling B{cs.BATCH} 4096x8192", [_falling(device, 16)]))
    gen = torch.Generator(device=device).manual_seed(17)
    q = torch.rand(2, 1000, 3, device=device, generator=gen) * 20.0 - 10.0
    r = torch.rand(2, 3000, 3, device=device, generator=gen) * 20.0 - 10.0
    for pts, k in ((q, 1000), (r, 3000)):
        draw = torch.rand(2, k, 3, device=device, generator=gen)
        pts[draw < 0.05] = float("nan")
        pts[(draw > 0.95) & (draw < 0.97)] = float("inf")
        pts[draw > 0.98] = float("-inf")
    r[1] = float("nan")  # frame 1: no finite reference
    cases.append(("non-finite B2 1000x3000", [(q, r)]))
    pc0, pc1, _, _, v0, v1 = cs._nsfp_pair(device)
    cases.append(("nsfp pair 1x65536x65536",
                  [(pnn._pad_coords(pc0[None], v0[None]), pnn._pad_coords(pc1[None], v1[None]))]))
    return cases


def _falling(device, seed):
    """B8 4,096 queries in the unit cube and 8,192 references on a line,
    farther first: every reference lowers every query's min."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(cs.BATCH, 4096, 3, device=device, generator=gen)
    steps = torch.arange(8192, 0, -1, device=device, dtype=torch.float32)
    r = torch.zeros(cs.BATCH, 8192, 3, device=device)
    r[..., 0] = 2.0 + steps * 0.01
    return q, r.contiguous()


def k7_cases(device):
    """(name, [(q, r), ...]) for K7; a case of several calls is timed as
    their sum."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    cases = []
    for n, m in cs.NN_SHAPES:
        q, r, _ = cs._nn_inputs(device, n, m, seed=n + m)
        cases.append((f"uniform B{cs.BATCH} {n}x{m}", [(q, r)]))
    cases.append(("slice 512² forward, its 10 calls", _slice_calls(device, "nn_argmin_rows")))
    pc0, pc1, _, _, v0, v1 = cs._nsfp_pair(device)
    cases.append(("nsfp pair 1x65536x65536",
                  [(pnn._pad_coords(pc0[None], v0[None]), pnn._pad_coords(pc1[None], v1[None]))]))
    rng = cs.np.random.default_rng(5)
    q, r = (torch.from_numpy(a).to(device) for a in _grid(rng, cs.BATCH, 4096, 8192))
    cases.append((f"grid B{cs.BATCH} 4096x8192", [(q, r)]))
    cases.append((f"falling B{cs.BATCH} 4096x8192", [_falling(device, 6)]))
    return cases


def _grid(rng, b, n, m):
    q = rng.integers(-32, 33, size=(b, n, 3)).astype(cs.np.float32) / 4
    r = rng.integers(-32, 33, size=(b, m, 3)).astype(cs.np.float32) / 4
    r[:, m // 2 : m // 2 + 20] = r[:, :20]
    q[:, :10] = r[:, :10]
    return q, r


def _slice_calls(device, wrapper):
    """The (q, r) of every call of ``ops.nn``'s ``wrapper`` in one 512²
    forward."""
    import torch

    from himo_tpu_torch.models.feedforward import frame, init_params, make_model
    from himo_tpu_torch.ops import nn as pnn

    pc0, pc1, pch, valid, dt0, _ = cs._clouds(device)
    model, _ = make_model("seflowpp", device=device, dtype="bfloat16")
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    calls, original = [], getattr(pnn, wrapper)

    def record(q, r):
        calls.append((q.clone(), r.clone()))
        return original(q, r)

    record.launches = 0  # the wrapper counts on the module's attribute
    setattr(pnn, wrapper, record)
    try:
        with torch.no_grad():
            frame(model, pc0, pc1, pch, valid, dt0)
    finally:
        setattr(pnn, wrapper, original)
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


def k9_cases(device):
    """(name, k, [(q, r), ...], plain or None) for K9."""
    import torch

    from himo_tpu_torch.ops import nn as pnn

    pair = cs._nsfp_pair(device)
    pc0, pc1, _, _, v0, v1 = pair
    q = pnn._pad_coords(pc0[None], v0[None])
    r = pnn._pad_coords(pc1[None], v1[None])
    r = torch.cat([r, torch.full_like(r[:, :1], pnn.SENTINEL)], dim=1).contiguous()
    cases = [(f"nsfp pair 1x65536x65537 k={k}", k, [(q, r)], None) for k in (1, 4, 8, 16)]
    dq, dr, _ = cs._knn_inputs(pair)
    cases.append((f"duplicates (phase_knn) 1x65536x65537 k={cs.KNN_K}", cs.KNN_K,
                  [(dq, dr)], None))
    rng = cs.np.random.default_rng(8)
    gq, gr = (torch.from_numpy(a).to(device) for a in _grid(rng, 2, 4096, 8192))
    cases += [(f"grid B2 4096x8192 k={k}", k, [(gq, gr)], True) for k in (4, 16)]
    gen = torch.Generator(device=device).manual_seed(9)
    fq = torch.rand(1, 65536, 3, device=device, generator=gen)
    steps = torch.arange(65536, 0, -1, device=device, dtype=torch.float32)
    fr = torch.zeros(1, 65536, 3, device=device)
    fr[..., 0] = 2.0 + steps * 1e-3  # farther first: every reference enters
    cases.append(("falling 1x65536x65536 k=4", 4, [(fq, fr.contiguous())], None))
    return cases


def k2_cases(device):
    """(name, [(spids, svals, rows), ...]) for K2 max, then (name, calls,
    flags) for K2 sum (flags None) and K10 (its rounding flags): sorted
    streams on the card."""
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    big = cs._clouds(device, cs.BIG_POINTS)
    valid = big[3]
    cfg = pvox.PillarConfig()
    rows = cfg.num_pillars
    pids = [pvox.voxelize_pillars(pc, valid, cfg).pillar_ids.contiguous() for pc in big[:3]]
    n = pids[0].shape[1]
    pools = []
    for seed, ids in enumerate(pids):
        feats = cs._relu_feats(device, (cs.BATCH, n, cs.SCATTER_CHANNELS), 20 + seed)
        pools.append((*pvox._sort_rows(ids, feats), rows))
    gen = torch.Generator(device=device).manual_seed(23)
    pos = (torch.rand(cs.BATCH, n, 1, device=device, generator=gen) < 0.3).float()
    signed = torch.randn(cs.BATCH, n, cs.SCATTER_CHANNELS, device=device, generator=gen)
    draw = torch.rand(signed.shape, device=device, generator=gen)
    signed = torch.where(draw < 0.1, torch.full_like(signed, -0.0), signed)
    signed = torch.where(draw > 0.999, torch.full_like(signed, float("-inf")), signed)
    # Frame 0: a 50,000-point run crossing many spans, gaps of thousands of
    # rows; frame 1: every id >= rows.
    lrng = cs.np.random.default_rng(24)
    ids = lrng.integers(0, rows, size=(2, 60000)).astype(cs.np.int32)
    ids[0, :50000] = 7
    ids[0, 50000:50100] = rows - 1
    ids[1] = rows + lrng.integers(0, 3, size=60000)
    lvals = lrng.normal(size=(2, 60000, cs.GATHER_CHANNELS)).astype(cs.np.float32)
    lids = torch.from_numpy(ids).to(device)
    lsorted = pvox._sort_rows(lids, torch.from_numpy(lvals).to(device))
    maxes = [
        ("path B's 3 pools B8x131072x32", pools),
        ("loss max B8x131072x1", [(*pvox._sort_rows(pids[0], pos), rows)]),
        ("signed B8x131072x32", [(*pvox._sort_rows(pids[0], signed), rows)]),
        ("long run + all trash B2x60000x32",
         [(lsorted[0], lsorted[1][..., :cs.SCATTER_CHANNELS].contiguous(), rows)]),
    ]
    cot = cs._sparse_cotangents(device, (cs.BATCH, n, cs.GATHER_CHANNELS), 25)
    clouds = cs._clouds(device)
    mids, mrows = cs._pillar_ids(clouds)
    mvals = cs._sparse_cotangents(device, (cs.BATCH, mids.shape[1], cs.MEAN_CHANNELS), 26)
    mcot = cs._sparse_cotangents(device, (cs.BATCH, mids.shape[1], cs.GATHER_CHANNELS), 27)
    sums = [
        ("K2 sum path B B8x131072x65", [(*pvox._sort_rows(pids[0], cot), rows)], None),
        ("K2 sum long run + all trash B2x60000x65", [(*lsorted, rows)], None),
        ("K10 mean_sorted B8x65536x33", [(*pvox._sort_rows(mids, mvals), mrows)],
         (False, True)),
        ("K10 step C=65 B8x65536x65", [(*pvox._sort_rows(mids, mcot), mrows)],
         (False, True)),
        ("K10 long run + all trash B2x60000x33",
         [(lsorted[0], lsorted[1][..., :cs.MEAN_CHANNELS].contiguous(), rows)], (True,)),
    ]
    return maxes, sums


def k5_cases(device):
    """(name, [(image, spids, order)]) for K5: sorted ids and the stable
    sort's order, images of normal values."""
    import torch

    from himo_tpu_torch.ops import voxelize as pvox

    gen = torch.Generator(device=device).manual_seed(31)

    def case(pids, rows, c):
        spids, order = pvox._stable_sort(pids)
        image = torch.randn(pids.shape[0], rows, c, device=device, generator=gen)
        return [(image, spids, order)]

    pids, rows = cs._pillar_ids(cs._clouds(device))
    bpids, _ = cs._pillar_ids(cs._clouds(device, cs.BIG_POINTS))
    seg, _ = cs._pillar_ids(cs._clouds(device, cs.DOWNSTREAM_POINTS))
    lrng = cs.np.random.default_rng(32)
    lids = lrng.integers(0, rows, size=(2, 60000)).astype(cs.np.int32)
    lids[0, :50000] = 7
    lids[1] = rows + lrng.integers(0, 3, size=60000)
    width = 2 * cs.SCATTER_CHANNELS
    return [
        (f"512² step's take B{cs.BATCH}x{pids.shape[1]}x{width}", case(pids, rows, width)),
        (f"path B's take B{cs.BATCH}x{bpids.shape[1]}x{width}", case(bpids, rows, width)),
        (f"SegNet's shape 1x{seg.shape[1]}x{width}", case(seg[:1].contiguous(), rows, width)),
        (f"long run + all past rows B2x60000x{width}",
         case(torch.from_numpy(lids).to(device), rows, width)),
        (f"512² ids C=65 B{cs.BATCH}x{pids.shape[1]}x65", case(pids, rows, 65)),
        (f"512² ids C=1 B{cs.BATCH}x{pids.shape[1]}x1", case(pids, rows, 1)),
    ]


def main(argv) -> int:
    import torch

    only = set(KERNELS)
    if argv[:1] == ["--only"] and len(argv) > 1:
        only, argv = set(argv[1].split(",")), argv[2:]
    if not argv or not only <= set(KERNELS) or not torch.cuda.is_available():
        print("usage: torch_nn_ab.py [--only K6,K7,K8,K9,K2,K5] ROOT [ROOT ...] "
              "(needs a CUDA device)", file=sys.stderr)
        return 2
    from himo_tpu_torch.ops import knn as pknn
    from himo_tpu_torch.ops import mxu_scatter as pms
    from himo_tpu_torch.ops import nn as pnn
    from himo_tpu_torch.ops import voxelize as pvox

    device, smi = cs.phase_device()
    cs.phase_build()
    tmp = tempfile.TemporaryDirectory()
    sources = sorted({SOURCE_OF[k] for k in only})
    roots = []
    for k, root in enumerate(argv):
        out = Path(tmp.name) / str(k)
        out.mkdir()
        roots.append(Library(Path(root).resolve(), out, sources))
    results = []

    def run(name, calls, here, there, plain=None, split=False, twice=False,
            ref="plain", clocks=False, cold=False):
        """``here`` is this checkout's wrapper, ``there(lib)`` a ROOT's, and
        ``plain`` what this checkout must equal bit for bit (named ``ref``).
        With ``split``, this checkout's device time is also split by pass;
        with ``twice``, this checkout must give the same bits on a second
        launch; with ``clocks``, the card's SM clock and power are sampled
        while this checkout's calls run back to back; with ``cold``, every
        side is also timed with a cold L2 (``chip_smoke.cold_device_ms``)."""
        got = [here(*a) for a in calls]
        if twice:
            again = [here(*a) for a in calls]
            torch.cuda.synchronize()
            if not all(_same(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{name}: differs from launch to launch")
            del again
        for lib in roots:
            other = [there(lib)(*a) for a in calls]
            torch.cuda.synchronize()
            for g, o in zip(got, other):
                if not _same(g, o):
                    raise AssertionError(f"{name}: differs from {lib.root}")
            del other
        if plain is not None:
            for g, a in zip(got, calls):
                if not _same(g, plain(*a)):
                    raise AssertionError(f"{name}: differs from the {ref} version")
        del got
        sides = [("this", lambda: [here(*a) for a in calls])]
        sides += [(str(lib.root), (lambda fn=there(lib): [fn(*a) for a in calls]))
                  for lib in roots]
        times = {label: [] for label, _ in sides}
        cold_times = {label: [] for label, _ in sides}
        for order in (sides, sides[::-1]) * (ROUNDS // 2):
            for label, call in order:
                times[label].append(_device_ms(call))
                if cold:
                    cold_times[label].append(cs.cold_device_ms(call, iters=10))
        row = dict(case=name, bitwise_vs_roots=True,
                   bitwise_vs=ref if plain is not None else None,
                   bitwise_launch_to_launch=twice, device_ms=times, card=smi)
        if cold:
            row["cold_device_ms"] = cold_times
        if split:
            row["split"] = cs.device_split(sides[0][1], iters=10)
        if clocks:
            row["clocks_this"] = _clocks_under(sides[0][1])
        cs.log(json.dumps(row))
        results.append(row)

    if "K6" in only:
        def k7_d2(q, r):
            return pnn.nn_argmin_rows(q, r)[0]

        def plain_and_k7(q, r):
            want = pnn._nn_min_plain(q, r)
            if not _same(k7_d2(q, r), want):
                raise AssertionError("K7's d2 differs from K6's plain version on the grid")
            return want

        for name, calls in k6_cases(device):
            grid = name.startswith("grid")
            run(f"K6 {name}", calls, pnn.nn_min_rows, lambda lib: lib.nn_min_rows,
                plain_and_k7 if grid else k7_d2, ref="plain and K7 d2" if grid else "K7 d2",
                clocks=True)
    if "K7" in only:
        for name, calls in k7_cases(device):
            plain = pnn._nn_argmin_plain if name.startswith("grid") else None
            run(f"K7 {name}", calls, pnn.nn_argmin_rows, lambda lib: lib.nn_argmin_rows,
                plain)
    if "K8" in only:
        for name, args in k8_cases(device):
            grid = name.startswith("grid")
            run(f"K8 idx {name}", [args], pnn.fused_nn_idx, lambda lib: lib.fused_nn_idx,
                pnn._fused_nn_plain if grid else None)
            run(f"K8 min {name}", [args], pnn.fused_nn, lambda lib: lib.fused_nn,
                (lambda *a: pnn._fused_nn_plain(*a)[:4]) if grid else None)
    if "K9" in only:
        for name, k, calls, grid in k9_cases(device):
            run(f"K9 {name}", calls, lambda q, r, _k=k: pknn.knn_rows(q, r, _k),
                lambda lib, _k=k: (lambda q, r: lib.knn_rows(q, r, _k)),
                (lambda q, r, _k=k: pknn._knn_plain(q, r, _k)) if grid else None)
    if "K2" in only:
        maxes, sums = k2_cases(device)
        for name, calls in maxes:
            run(f"K2 max {name}", calls, pvox.sorted_scatter_max_rows,
                lambda lib: lib.sorted_max, pvox._scatter_max_rows_plain, split=True)
        del maxes
        for name, calls, flags in sums:
            if flags is None:
                run(name, calls, pvox.sorted_scatter_sum_rows, lambda lib: lib.sorted_sum,
                    split=True, twice=True)
                continue
            for bf16 in flags:
                run(f"{name} bf16={int(bf16)}", calls,
                    lambda i, v, r, _b=bf16: pms.sorted_segment_sum(i, v, r, _b),
                    lambda lib, _b=bf16: (lambda i, v, r: lib.segment_sum(i, v, r, _b)),
                    split=True, twice=True)
    if "K5" in only:
        for name, calls in k5_cases(device):
            run(f"K5 {name}", calls, pvox.sorted_gather_rows, lambda lib: lib.sorted_gather,
                pvox._sorted_gather_rows_plain, cold=name.startswith("SegNet"))
            del calls
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "nn_ab.json").write_text(json.dumps(results, indent=1))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
