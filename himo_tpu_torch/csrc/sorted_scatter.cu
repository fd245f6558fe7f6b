// Per-pillar max or sum of a point stream already sorted by pillar id (fp32).
//
//   out[b * rows + r, :] = max (or sum) of sfeats[b, j, :] over the run of
//   sorted positions j with spids[b, j] == r, the sum taken in stream order
//   from +0.0; rows that no run reaches read 0; ids outside [0, rows) are
//   skipped (ids >= rows sort to the end of each frame, ids < 0 to its head).
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
// What bounds all three: bytes (the live part of the sorted stream read
// once, the B x rows x C table written once; the reached rows are written
// twice, by the memset and by the kernel, see below). On path B's clouds a
// run holds one or two points and the runs reach about a third of the
// rows, at 65,536 points about a fifth (`chip_smoke.py`'s phase_sorted and
// phase_sorted_sum log both).
//
// Both work over runs, not rows (`find_runs`):
// - one warp per span of kSpan sorted positions, one id per lane; a ballot
//   on "my id (ids < 0 taken as -1, ids > rows as rows) differs from the one
//   before" finds the span's run boundaries, compacted into the warp's
//   shared list of (id, start). A run is reduced by the warp whose span holds
//   its start, to its end, which may lie past the span (the next 32 ids,
//   then a binary search). Runs of ids outside [0, rows) are skipped
//   without reading their values;
// - rows no run reaches read the zeros of one cudaMemsetAsync of `out`,
//   issued before the kernel; the kernel writes each reached row once.
//   (Having the warps also write the empty rows between their runs, every
//   row once, measured slower for the max: a frame's head and tail gaps of
//   thousands of rows fall to one warp each; PERF.md.)
//
// The max (`max_runs`):
// - lanes form groups of G (a power of two up to 32, the row's channel
//   vectors: 16 bytes when C % 4 == 0, else 4); each group takes a row, so
//   at C = 32 a warp writes four 128-byte rows per store and at C = 1
//   thirty-two rows, and its loads are one vector per lane per point;
// - a run longer than kLongRun (only the span's last run can be: the others
//   end inside the span) is reduced by the whole warp, groups over its
//   points with several loads in flight, then a shuffle max;
// - a group writes its run's row once: -inf as the start, fmaxf, then
//   -inf -> 0 and `__fadd_rn(v, 0.0f)` so that -0.0 comes out as +0.0.
// Max does not depend on order and the sign of zero is fixed at the write,
// so the result is bitwise the plain version's (`_scatter_max_rows_plain`).
//
// The sums (`sum_runs`) must add each channel in stream order from +0.0
// with `__fadd_rn` (the reference's order, and what keeps two launches
// bitwise equal to each other, to the earlier kernel and to a sequential
// sum), so a run's points stay in one lane; only its channels spread:
// - a span's runs form a list of items, run-major, walked by the warp 32
//   at a time: run k's items are its row's c floats (each the sum of one
//   channel) with pad zeros around them, so that consecutive lanes take
//   consecutive floats of one row, then the next run's. Runs sit one after
//   the other in the stream: where runs hold one point a warp's loads are
//   128 contiguous bytes. C = 33 and 65 are odd, so rows are neither
//   16-byte sized nor aligned, and a power-of-two group of lanes per run
//   would leave one lane busy in its last pass;
// - pad zeros: a row of 132 or 260 bytes starts and ends inside 32-byte
//   sectors. Where the row beside it is one no run reaches (a zero of the
//   memset, long since written back), the write reaches out to the sector
//   boundary with zeros, so every sector the kernel touches is written
//   whole (a sector written in part costs a read of device memory to
//   merge). Not below 8 channels (a sector would span more than two rows);
// - a lane takes kSumItems items at once: all their first points' loads
//   are issued before the first add, then each adds its run's other points
//   (a run ending inside the span holds at most 32) and writes its value.
//   `kRound` (K10 with `mxu_bf16`) rounds each value to bf16 after the
//   loads, so that no load waits on the one before it;
// - a long run (the span's last, over kLongRun points) goes to the whole
//   warp, lanes over channels, kLongChannels channels per lane at once,
//   kUnroll points' loads in flight, the adds in order. Its time is load
//   latency (a dependent chain per channel): 50,000 points take
//   milliseconds, half the earlier kernel's time.
// Tried (PERF.md; device ms by `scripts/torch_nn_ab.py`, each variant a
// copy of the sources given as a ROOT; NVIDIA H100 80GB HBM3, 700 W; K10 at
// B8 x 65,536 x 33 / K10 at x 65 / K2 sum at B8 x 131,072 x 65): the
// earlier design, a scratch map of run starts, a marking pass and one warp
// per output row: 0.3345 / 0.4227 / 0.5257. This one without pads:
// 0.2038 / 0.3522 / 0.4647; with them: 0.1698 / 0.3063 / 0.4113. Also
// measured, and slower or no better: a run per warp pass with lanes over
// channels; kSumItems 1, 2 and 8; bf16 rounding as each value loads (0.1955
// at C = 33); each span's values staged in shared memory by cp.async
// (0.1635 / 0.3155 / 0.4196, 24 warps a multiprocessor at C = 65); every row
// written once, with no memset, by warps that zero the gaps between the
// runs over 256-row slices (0.2048 / 0.3797 / 0.4411) or with each run's
// warp also zeroing the 8 rows after it (0.2289 / 0.3993 / 0.4812). With
// the pads, slice warps zeroing whole sectors, timed four times a side in
// one run beside this kernel (0.1707 / 0.3090 / 0.4135): 256-row slices
// 0.1673 / 0.3124 / 0.3993, 1,024-row slices 0.1893 / 0.3051 / 0.4116.
// Neither is faster at both widths (256 loses at K10's C = 65, 1,024 at
// C = 33), and the slice warps took about 80 lines more: not kept.
//
// Inputs: spids (B, N) int32 sorted in each frame, sfeats (B, N, C) fp32 in
// the same order, out (B * rows, C) fp32, all contiguous on one device. The
// Python wrappers check them (not the order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned int kFull = 0xffffffffu;
constexpr int kSpan = 32;      // sorted positions per warp: one id per lane
constexpr int kMaxWarps = 8;   // warps per block
constexpr int kLongRun = 32;   // a longer run is reduced by its whole warp
constexpr int kUnroll = 8;     // a long run's loads in flight per lane
constexpr int kSumItems = 4;       // a sum's items a lane takes at once
constexpr int kLongChannels = 2;   // a long run's channels a lane takes at once
constexpr int kSector = 8;         // floats in a 32-byte sector

__device__ __forceinline__ int clamp_id(int id, int rows) {
  return id < 0 ? -1 : (id > rows ? rows : id);
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

// The runs that start in the span of positions [s, s + kSpan) of one
// frame's sorted `ids`.
struct Span {
  int runs;        // runs listed: run_id[0, runs), run_at[0, runs]
  int last;        // the id at position s + kSpan - 1 (clamped), rows past n
  bool live_last;  // last is in [0, rows): its run may go on past the span
  int end;         // run_at[runs]
};

// Warp-collective. Fills run_id[k] (the k-th run's id, clamped to [-1,
// rows]) and run_at[k] (its first position); run_at[runs] is the end of
// the last run, past the span when that run goes on. A run's id is never
// -1: ids < 0 sort first, and position 0 counts -1 as the id before it.
__device__ __forceinline__ Span find_runs(const int* __restrict__ ids, int s, int n,
                                          int rows, int lane, int* run_id, int* run_at) {
  const int j = s + lane;
  const int id = j < n ? clamp_id(ids[j], rows) : rows;
  int prev = __shfl_up_sync(kFull, id, 1);
  if (lane == 0) prev = s == 0 ? -1 : clamp_id(ids[s - 1], rows);
  const unsigned int starts = __ballot_sync(kFull, id != prev);
  Span span;
  span.runs = __popc(starts);
  if (id != prev) {
    const int k = __popc(starts & ((1u << lane) - 1u));
    run_id[k] = id;
    run_at[k] = j;
  }
  // The span's last run (the one holding position s + kSpan - 1) may go on.
  span.last = __shfl_sync(kFull, id, 31);
  span.live_last = span.last >= 0 && span.last < rows;
  span.end = span.live_last ? run_end(ids, s + kSpan, n, span.last, lane) : s + kSpan;
  if (lane == 0) run_at[span.runs] = span.end;
  __syncwarp();
  return span;
}

// ---------------------------------------------------------------- the max

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
  const Span span = find_runs(ids, s, n, rows, lane, run_id[warp], run_at[warp]);
  const int runs = span.runs;
  const int end = span.end;
  const bool long_last =
      runs > 0 && span.live_last && end - run_at[warp][runs - 1] > kLongRun;
  const int groups = 32 / group;
  const int grp = lane / group;
  const int h = lane - grp * group;
  const T* frame = sfeats + static_cast<long long>(b) * n * cv;
  T* image = out + static_cast<long long>(b) * rows * cv;
  // Each group takes a run that starts in the span (only ids >= rows skip).
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
  T* dst = image + static_cast<long long>(span.last) * cv;
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

// A value as the sum adds it: rounded to bf16 (round to nearest even) when
// kRound.
template <bool kRound>
__device__ __forceinline__ float rounded(float x) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Writes each reached row of the zeroed table, with its pad zeros, as a
// list of (run, float) items (see the header).
template <bool kRound>
__global__ void __launch_bounds__(kMaxWarps * 32)
sum_runs(const int* __restrict__ spids, const float* __restrict__ svals,
         float* __restrict__ out, long long warps, int spans, int n, int c, int rows) {
  __shared__ int run_id[kMaxWarps][kSpan + 1];
  __shared__ int run_at[kMaxWarps][kSpan + 1];
  __shared__ int run_off[kMaxWarps][kSpan + 1];  // a run's first item
  __shared__ int run_pad[kMaxWarps][kSpan + 1];  // its zeros before its row
  const long long wid = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  if (wid >= warps) return;  // the whole warp: blockDim is a multiple of 32
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(wid / spans);
  const int s = static_cast<int>(wid - static_cast<long long>(b) * spans) * kSpan;
  const int* ids = spids + static_cast<long long>(b) * n;
  const int* at = run_at[warp];
  const int* id_of = run_id[warp];
  const Span span = find_runs(ids, s, n, rows, lane, run_id[warp], run_at[warp]);
  const bool long_last =
      span.runs > 0 && span.live_last && span.end - at[span.runs - 1] > kLongRun;
  const float* frame = svals + static_cast<long long>(b) * n * c;
  float* image = out + static_cast<long long>(b) * rows * c;
  // Lane k sizes run k's items: pad zeros to the sector boundary before its
  // row where the row before is unreached, its c sums, pad zeros to the
  // boundary after where the row after is unreached (at c >= kSector a
  // sector holds parts of two rows at most). The long run (summed below)
  // and a run of ids >= rows (those sort last) take none.
  int size = 0;
  int pad = 0;
  if (lane < span.runs && id_of[lane] < rows && !(long_last && lane == span.runs - 1)) {
    const int row = id_of[lane];
    if (c >= kSector) {
      const int before = lane > 0 ? id_of[lane - 1] : s == 0 ? -1 : clamp_id(ids[s - 1], rows);
      const int after = lane + 1 < span.runs ? id_of[lane + 1]
                        : span.end < n       ? clamp_id(ids[span.end], rows)
                                             : rows;
      const float* start = image + static_cast<long long>(row) * c;
      const int lo = static_cast<int>(reinterpret_cast<size_t>(start) / 4 % kSector);
      const int hi = static_cast<int>(reinterpret_cast<size_t>(start + c) / 4 % kSector);
      pad = before == row - 1 ? 0 : lo;
      size = after == row + 1 || hi == 0 ? 0 : kSector - hi;
    }
    size += pad + c;
  }
  int off = size;  // inclusive prefix sum over the lanes
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, off, d);
    if (lane >= d) off += v;
  }
  const int total = __shfl_sync(kFull, off, 31);
  if (lane < span.runs) {
    run_off[warp][lane] = off - size;
    run_pad[warp][lane] = pad;
  }
  if (lane == 0) run_off[warp][span.runs] = total;
  __syncwarp();
  // Item t of run k (run_off[k] <= t < run_off[k + 1]) is the sum of channel
  // ch = t - run_off[k] - run_pad[k] when 0 <= ch < c, else a pad zero. A
  // lane takes kSumItems items at once: all their first loads, then the
  // adds (rounding after the loads, so that none waits on another's load).
  int k = 0;
  for (int t0 = lane; t0 < total; t0 += 32 * kSumItems) {
    int ks[kSumItems], chs[kSumItems];
    float first[kSumItems];
#pragma unroll
    for (int u = 0; u < kSumItems; ++u) {
      const int t = t0 + 32 * u;
      first[u] = 0.0f;
      chs[u] = -1;
      if (t < total) {
        while (t >= run_off[warp][k + 1]) ++k;
        chs[u] = t - run_off[warp][k] - run_pad[warp][k];
        if (chs[u] >= 0 && chs[u] < c) first[u] = frame[static_cast<long long>(at[k]) * c + chs[u]];
      }
      ks[u] = k;
    }
#pragma unroll
    for (int u = 0; u < kSumItems; ++u) {
      if (t0 + 32 * u < total) {
        const int ch = chs[u];
        float* dst = image + static_cast<long long>(id_of[ks[u]]) * c + ch;
        if (ch >= 0 && ch < c) {
          const int p = at[ks[u]];
          const int e = at[ks[u] + 1];
          const float* x = frame + static_cast<long long>(p) * c + ch;
          float acc = __fadd_rn(0.0f, rounded<kRound>(first[u]));
          for (int i = p + 1; i < e; ++i) {
            x += c;
            acc = __fadd_rn(acc, rounded<kRound>(*x));
          }
          *dst = acc;
        } else {
          *dst = 0.0f;
        }
      }
    }
  }
  if (!long_last) return;
  // The long run: lanes over channels, kLongChannels at once, kUnroll
  // points' loads in flight, each channel's adds in stream order.
  const int p = at[span.runs - 1];
  const int e = span.end;
  float* dst = image + static_cast<long long>(span.last) * c;
  for (int base = lane; base < c; base += 32 * kLongChannels) {
    float acc[kLongChannels];
#pragma unroll
    for (int q = 0; q < kLongChannels; ++q) acc[q] = 0.0f;
    const float* x = frame + static_cast<long long>(p) * c + base;
    int i = p;
    for (; i + kUnroll <= e; i += kUnroll, x += kUnroll * c) {
      float vals[kUnroll][kLongChannels];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int q = 0; q < kLongChannels; ++q)
          vals[u][q] = base + 32 * q < c ? x[u * c + 32 * q] : 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int q = 0; q < kLongChannels; ++q)
          acc[q] = __fadd_rn(acc[q], rounded<kRound>(vals[u][q]));
    }
    for (; i < e; ++i, x += c) {
#pragma unroll
      for (int q = 0; q < kLongChannels; ++q)
        if (base + 32 * q < c) acc[q] = __fadd_rn(acc[q], rounded<kRound>(x[32 * q]));
    }
#pragma unroll
    for (int q = 0; q < kLongChannels; ++q)
      if (base + 32 * q < c) dst[base + 32 * q] = acc[q];
  }
}

template <bool kRound>
int launch_sum(const void* spids, const void* svals, void* out, int batch, int n, int c,
               int rows, cudaStream_t s) {
  const int spans = (n + kSpan - 1) / kSpan;
  const long long warps = static_cast<long long>(batch) * spans;
  const long long blocks = (warps + kMaxWarps - 1) / kMaxWarps;
  sum_runs<kRound><<<static_cast<unsigned int>(blocks), kMaxWarps * 32, 0, s>>>(
      static_cast<const int*>(spids), static_cast<const float*>(svals),
      static_cast<float*>(out), warps, spans, n, c, rows);
  return static_cast<int>(cudaGetLastError());
}

// Zeroes the (batch * rows, c) table `out`. Returns false, with `code` the
// entry's result, when no kernel is to follow: an error, no table, or no
// points.
bool zero_table(void* out, int batch, int n, int c, int rows, cudaStream_t s, int* code) {
  const long long cells = static_cast<long long>(batch) * rows;
  if (cells == 0 || c == 0) {
    *code = static_cast<int>(cudaGetLastError());
    return false;
  }
  const cudaError_t err = cudaMemsetAsync(out, 0, cells * c * sizeof(float), s);
  *code = static_cast<int>(err);
  return err == cudaSuccess && n > 0;
}

}  // namespace

// Each entry zeroes `out` (cudaMemsetAsync), then writes the reached rows.
extern "C" int himo_sorted_scatter_max_f32(const void* spids, const void* sfeats,
                                           void* out, int batch, int n, int c,
                                           int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  if (!zero_table(out, batch, n, c, rows, s, &code)) return code;
  const bool vec4 = c % 4 == 0 && reinterpret_cast<size_t>(sfeats) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec4) return launch_max<float4>(spids, sfeats, out, batch, n, c / 4, rows, s);
  return launch_max<float>(spids, sfeats, out, batch, n, c, rows, s);
}

extern "C" int himo_sorted_scatter_sum_f32(const void* spids, const void* sfeats,
                                           void* out, int batch, int n, int c,
                                           int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  if (!zero_table(out, batch, n, c, rows, s, &code)) return code;
  return launch_sum<false>(spids, sfeats, out, batch, n, c, rows, s);
}

// K10: the sum above, each value rounded to bf16 on load when round_bf16 != 0.
extern "C" int himo_sorted_segment_sum_f32(const void* spids, const void* svals,
                                           void* out, int batch, int n, int c,
                                           int rows, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  if (!zero_table(out, batch, n, c, rows, s, &code)) return code;
  if (round_bf16) return launch_sum<true>(spids, svals, out, batch, n, c, rows, s);
  return launch_sum<false>(spids, svals, out, batch, n, c, rows, s);
}
