// Per-pillar max or sum of a point stream already sorted by pillar id (fp32).
//
//   out[b * rows + r, :] = max (or sum) of sfeats[b, j, :] over the run of
//   sorted positions j with spids[b, j] == r, the sum taken in stream order
//   from +0.0; rows that no run reaches read 0; ids outside [0, rows) are
//   skipped (ids >= rows sort to the end of each frame).
//
// Replaces the TPU kernel himo_tpu/ops/voxelize.py
// `_sorted_scatter_band_kernel` (called through `_sorted_scatter_call` from
// `_sorted_scatter_forward`), the stream route: taken when a frame's point
// table, padded to 2,048 rows, passes the reference's 40 MiB route threshold
// (`_TABLE_BUDGET_BYTES`), i.e. at 512x512 with more than 81,920 points per
// cloud. There it serves the per-sweep pillar max (C = 32), the
// dynamic-image loss's max (C = 1) and `gather_pillars`' backward sum
// (C = 65). The reference argsorts the ids, takes the rows in that order, and
// walks the sorted stream chunk by chunk with one read-modify-write of a
// VMEM-resident band row per point; bands and chunks fit the TPU's VMEM and
// are not carried over. The caller sorts here too (a stable argsort and one
// row take, `ops.voxelize._sort_rows`); the wrappers are
// `ops.voxelize.sorted_scatter_max_rows` / `sorted_scatter_sum_rows`.
//
// What bounds both: bytes (the live part of the sorted stream read once, the
// B x rows x C table written once; the max writes the reached rows twice).
// On path B's clouds a run holds one or two points and the runs reach about
// a third of the rows (`chip_smoke.py`'s phase_sorted logs both).
//
// The max (`himo_sorted_scatter_max_f32`) works over runs, not rows:
// - one warp per span of kSpan sorted positions, one id per lane; a ballot
//   on "my id (ids < 0 taken as -1, ids > rows as rows) differs from the one
//   before" finds the span's run boundaries, compacted into the warp's
//   shared list of (id, start). A run is reduced by the warp whose span holds
//   its start, to its end, which may lie past the span (the next 32 ids,
//   then a binary search). Runs of ids outside [0, rows) are skipped
//   without reading their values;
// - lanes form groups of G (a power of two up to 32, the row's channel
//   vectors: 16 bytes when C % 4 == 0, else 4); each group takes a row, so
//   at C = 32 a warp writes four 128-byte rows per store and at C = 1
//   thirty-two rows, and its loads are one vector per lane per point;
// - a run longer than kLongRun (only the span's last run can be: the others
//   end inside the span) is reduced by the whole warp, groups over its
//   points with several loads in flight, then a shuffle max;
// - a group writes its run's row once: -inf as the start, fmaxf, then
//   -inf -> 0 and `__fadd_rn(v, 0.0f)` so that -0.0 comes out as +0.0;
// - rows no run reaches read the zeros of one cudaMemsetAsync of `out`,
//   issued before the kernel. (Having the warps also write the empty rows
//   between their runs, every row once, measured slower: a frame's head and
//   tail gaps of thousands of rows fall to one warp each; PERF.md.)
// Max does not depend on order and the sign of zero is fixed at the write,
// so the result is bitwise the plain version's (`_scatter_max_rows_plain`)
// and the earlier one-warp-per-row kernel's on every input.
//
// The sum (`himo_sorted_scatter_sum_f32`, and K10 below) keeps the first
// design, a sorted segmented reduce over rows:
// 1. fill a scratch map `first` (B * rows int32, from the wrapper) with -1;
// 2. mark: one thread per sorted position; a position that starts a run
//    (its id differs from the one before, and is < rows) writes its position
//    into first[b * rows + id];
// 3. reduce: one warp per output row, lanes over channels. A row no run
//    reaches writes zeros. Otherwise the warp finds the run's end 32 ids at
//    a time with a ballot (sorted ids: the lanes still in the run are a
//    prefix), then walks the run in stream order, 32 channels at a time, and
//    writes the row once: sequential fp32 adds in stream order, the
//    reference's order, so two launches are bitwise equal, and equal to a
//    sequential sum of the same stream.
// It spends a warp on every row, reached or not, and 8 bytes per row of
// `first` (ROADMAP.md lists its redesign).
//
// The same sum also replaces himo_tpu/ops/mxu_scatter.py
// `_scatter_sum_band_kernel` (K10, called through `_scatter_sum_call` from
// `scatter_sum_sorted`): the per-pillar sum of `pooling='mean_sorted'`, over
// a stream the model sorts itself (PFN features plus a count column, C = 33),
// and the backward of that mode's sorted gather (C = 65). The TPU kernel
// accumulates one-hot matmuls over a window of rows; with `mxu_bf16` it
// rounds its operands to bf16 first. Here `himo_sorted_segment_sum_f32`
// takes that as a flag: each value is rounded to bf16 (round to nearest
// even) as it is loaded, then added in fp32 in stream order. The wrapper is
// `ops.mxu_scatter.sorted_segment_sum`.
//
// Inputs: spids (B, N) int32 sorted in each frame, sfeats (B, N, C) fp32 in
// the same order, out (B * rows, C) fp32, the sums' first (B * rows) int32
// scratch, all contiguous on one device. The Python wrappers check them
// (not the order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kFull = 0xffffffffu;

// ---------------------------------------------------------------- the max

constexpr int kSpan = 32;      // sorted positions per warp: one id per lane
constexpr int kMaxWarps = 8;   // warps per block
constexpr int kLongRun = 32;   // a longer run is reduced by its whole warp
constexpr int kUnroll = 8;     // a long run's loads in flight per lane

__device__ __forceinline__ int clamp_id(int id, int rows) {
  return id < 0 ? -1 : (id > rows ? rows : id);
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}
__device__ __forceinline__ float decode(float a) {
  return a == -INFINITY ? 0.0f : __fadd_rn(a, 0.0f);
}
__device__ __forceinline__ float4 decode(float4 a) {
  return make_float4(decode(a.x), decode(a.y), decode(a.z), decode(a.w));
}
__device__ __forceinline__ float shfl_xor(float a, int off) {
  return __shfl_xor_sync(kFull, a, off);
}
__device__ __forceinline__ float4 shfl_xor(float4 a, int off) {
  return make_float4(shfl_xor(a.x, off), shfl_xor(a.y, off), shfl_xor(a.z, off),
                     shfl_xor(a.w, off));
}
template <typename T> __device__ __forceinline__ T splat(float v);
template <> __device__ __forceinline__ float splat<float>(float v) { return v; }
template <> __device__ __forceinline__ float4 splat<float4>(float v) {
  return make_float4(v, v, v, v);
}

// The first position at or after `from` whose id is not `id` (a live id
// whose run holds position from - 1), or n: the next 32 ids by a ballot
// (sorted ids: the lanes still in the run are a prefix), then a binary
// search. Warp-collective; every lane returns the same position.
__device__ int run_end(const int* __restrict__ ids, int from, int n, int id, int lane) {
  const int j = from + lane;
  const unsigned int same = __ballot_sync(kFull, j < n && ids[j] == id);
  if (same != kFull) return from + __ffs(~same) - 1;
  int lo = from + 32, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (ids[mid] == id) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// T is one load of `cv`-vector rows: float (any C) or float4 (C % 4 == 0).
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
max_runs(const int* __restrict__ spids, const T* __restrict__ sfeats, T* __restrict__ out,
         long long warps, int spans, int n, int cv, int rows, int group) {
  __shared__ int run_id[kMaxWarps][kSpan + 1];
  __shared__ int run_at[kMaxWarps][kSpan + 1];
  const long long wid = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (wid >= warps) return;  // the whole warp: blockDim is a multiple of 32
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(wid / spans);
  const int s = static_cast<int>(wid - static_cast<long long>(b) * spans) * kSpan;
  const int* ids = spids + static_cast<long long>(b) * n;
  const int j = s + lane;
  const int id = j < n ? clamp_id(ids[j], rows) : rows;
  int prev = __shfl_up_sync(kFull, id, 1);
  if (lane == 0) prev = s == 0 ? -1 : clamp_id(ids[s - 1], rows);
  const unsigned int starts = __ballot_sync(kFull, id != prev);
  const int runs = __popc(starts);
  if (id != prev) {
    const int k = __popc(starts & ((1u << lane) - 1u));
    run_id[warp][k] = id;
    run_at[warp][k] = j;
  }
  // The span's last run (the one holding position s + kSpan - 1) may go on.
  const int last = __shfl_sync(kFull, id, 31);
  const bool live_last = last >= 0 && last < rows;
  const int end = live_last ? run_end(ids, s + kSpan, n, last, lane) : s + kSpan;
  if (lane == 0) run_at[warp][runs] = end;
  __syncwarp();
  const bool long_last =
      runs > 0 && live_last && end - run_at[warp][runs - 1] > kLongRun;
  const int groups = 32 / group;
  const int grp = lane / group;
  const int h = lane - grp * group;
  const T* frame = sfeats + static_cast<long long>(b) * n * cv;
  T* image = out + static_cast<long long>(b) * rows * cv;
  // Each group takes a run that starts in the span (ids clamped to
  // [-1, rows], so a run's id is never below 0: only ids >= rows skip).
  for (int k = grp; k < runs; k += groups) {
    const int row = run_id[warp][k];
    if (row >= rows || (long_last && k == runs - 1)) continue;  // long: below
    const int p = run_at[warp][k];
    const int e = run_at[warp][k + 1];
    T* dst = image + static_cast<long long>(row) * cv;
    for (int v = h; v < cv; v += group) {
      T acc = splat<T>(-INFINITY);
      const T* x = frame + static_cast<long long>(p) * cv + v;
      for (int i = p; i < e; ++i, x += cv) acc = vmax(acc, *x);
      dst[v] = decode(acc);
    }
  }
  if (!long_last) return;
  // The long run: groups over its points, kUnroll loads in flight per lane,
  // then a shuffle max across the groups; group 0 writes the row.
  const int p = run_at[warp][runs - 1];
  T* dst = image + static_cast<long long>(last) * cv;
  for (int base = 0; base < cv; base += group) {
    const int v = base + h;
    T acc = splat<T>(-INFINITY);
    if (v < cv) {
      const T* x = frame + v;
      int i = p + grp;
      for (; i + (kUnroll - 1) * groups < end; i += kUnroll * groups) {
        T vals[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          vals[u] = x[static_cast<long long>(i + u * groups) * cv];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = vmax(acc, vals[u]);
      }
      for (; i < end; i += groups) acc = vmax(acc, x[static_cast<long long>(i) * cv]);
    }
    for (int off = group; off < 32; off <<= 1) acc = vmax(acc, shfl_xor(acc, off));
    if (grp == 0 && v < cv) dst[v] = decode(acc);
  }
}

template <typename T>
int launch_max(const void* spids, const void* sfeats, void* out, int batch, int n,
               int cv, int rows, cudaStream_t s) {
  int group = 1;
  while (group * 2 <= (cv < 32 ? cv : 32)) group *= 2;
  const int spans = (n + kSpan - 1) / kSpan;
  const long long warps = static_cast<long long>(batch) * spans;
  const long long blocks = (warps + kMaxWarps - 1) / kMaxWarps;
  max_runs<T><<<static_cast<unsigned int>(blocks), kMaxWarps * 32, 0, s>>>(
      static_cast<const int*>(spids), static_cast<const T*>(sfeats), static_cast<T*>(out),
      warps, spans, n, cv, rows, group);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- the sums

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void mark_runs(const int* __restrict__ spids, int* __restrict__ first,
                          long long points, int n, int rows) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= points) return;
  const int id = spids[i];
  if (static_cast<unsigned int>(id) >= static_cast<unsigned int>(rows)) return;
  const long long b = i / n;
  const int j = static_cast<int>(i - b * n);
  if (j > 0 && spids[i - 1] == id) return;
  first[b * rows + id] = j;
}

template <bool kRound>
__global__ void reduce_runs(const int* __restrict__ spids,
                            const float* __restrict__ sfeats,
                            const int* __restrict__ first,
                            float* __restrict__ out, long long cells, int n,
                            int c, int rows) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= cells) return;  // the whole warp: blockDim is a multiple of 32
  float* dst = out + warp * static_cast<long long>(c);
  const int start = first[warp];
  if (start < 0) {
    for (int ch = lane; ch < c; ch += 32) dst[ch] = 0.0f;
    return;
  }
  const long long b = warp / rows;
  const int row = static_cast<int>(warp - b * rows);
  const int* ids = spids + b * n;
  int end = start;
  for (;;) {
    const int j = end + lane;
    const unsigned int same = __ballot_sync(kFull, j < n && ids[j] == row);
    if (same != kFull) {
      end += __ffs(~same) - 1;
      break;
    }
    end += 32;
  }
  const float* src = sfeats + (b * n + start) * static_cast<long long>(c);
  const int len = end - start;
  for (int ch = lane; ch < c; ch += 32) {
    float acc = 0.0f;
    const float* p = src + ch;
    for (int k = 0; k < len; ++k, p += c) acc = __fadd_rn(acc, kRound ? round_bf16(*p) : *p);
    dst[ch] = acc;
  }
}

template <bool kRound>
int sorted_sum(const void* spids, const void* sfeats, void* first, void* out,
               int batch, int n, int c, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(batch) * rows;
  const long long points = static_cast<long long>(batch) * n;
  if (cells == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int* ids = static_cast<const int*>(spids);
  int* marks = static_cast<int*>(first);
  cudaError_t err = cudaMemsetAsync(marks, 0xff, cells * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (points > 0) {
    const long long blocks = (points + kThreads - 1) / kThreads;
    mark_runs<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        ids, marks, points, n, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (cells * 32 + kThreads - 1) / kThreads;
  reduce_runs<kRound><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      ids, static_cast<const float*>(sfeats), marks, static_cast<float*>(out),
      cells, n, c, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The max: zeroes `out` (cudaMemsetAsync), then writes the reached rows.
extern "C" int himo_sorted_scatter_max_f32(const void* spids, const void* sfeats,
                                           void* out, int batch, int n, int c,
                                           int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(batch) * rows;
  if (cells == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaMemsetAsync(out, 0, cells * c * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const bool vec4 = c % 4 == 0 && reinterpret_cast<size_t>(sfeats) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec4) return launch_max<float4>(spids, sfeats, out, batch, n, c / 4, rows, s);
  return launch_max<float>(spids, sfeats, out, batch, n, c, rows, s);
}

extern "C" int himo_sorted_scatter_sum_f32(const void* spids, const void* sfeats,
                                           void* first, void* out, int batch,
                                           int n, int c, int rows, void* stream) {
  return sorted_sum<false>(spids, sfeats, first, out, batch, n, c, rows, stream);
}

// K10: the sum above, each value rounded to bf16 on load when round_bf16 != 0.
extern "C" int himo_sorted_segment_sum_f32(const void* spids, const void* svals,
                                           void* first, void* out, int batch,
                                           int n, int c, int rows, int round_bf16,
                                           void* stream) {
  if (round_bf16) {
    return sorted_sum<true>(spids, svals, first, out, batch, n, c, rows, stream);
  }
  return sorted_sum<false>(spids, svals, first, out, batch, n, c, rows, stream);
}
