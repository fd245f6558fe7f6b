// Per-pillar max or sum of a point stream already sorted by pillar id (fp32).
//
//   out[b * rows + r, :] = max (or sum) of sfeats[b, j, :] over the run of
//   sorted positions j with spids[b, j] == r, the sum taken in stream order
//   from +0.0; rows that no run reaches read 0; ids >= rows are skipped
//   (they sort to the end of each frame).
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
// Design on the H100: a sorted segmented reduce, no atomics (the alternative
// to scatter_max.cu's and scatter_sum.cu's atomics).
// 1. fill a scratch map `first` (B * rows int32, from the wrapper) with -1;
// 2. mark: one thread per sorted position; a position that starts a run
//    (its id differs from the one before, and is < rows) writes its position
//    into first[b * rows + id];
// 3. reduce: one warp per output row, lanes over channels. A row no run
//    reaches writes zeros. Otherwise the warp finds the run's end 32 ids at
//    a time with a ballot (sorted ids: the lanes still in the run are a
//    prefix), then walks the run in stream order, 32 channels at a time, and
//    writes the row once.
// Rows are written once each, in row order, so the output writes are
// coalesced; a run's point rows are contiguous in the stream.
//
// Max: -inf as the start, fmaxf, then -inf -> 0 and -0.0 -> +0.0 (as
// scatter_max.cu's decode). Sum: sequential fp32 adds in stream order,
// the reference's order, so two launches are bitwise equal, and equal to a
// sequential sum of the same stream.
//
// What bounds it: bytes (the sorted stream read once, the B x rows x C table
// written once, 8 bytes per row of `first`). A long run (a near-sensor
// pillar) is walked by one warp alone; that imbalance is not tuned here.
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
// the same order, first (B * rows) int32 scratch, out (B * rows, C) fp32,
// all contiguous on one device. The Python wrappers check them (not the
// order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

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

template <bool kMax, bool kRound>
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
    const unsigned int same = __ballot_sync(0xffffffffu, j < n && ids[j] == row);
    if (same != 0xffffffffu) {
      end += __ffs(~same) - 1;
      break;
    }
    end += 32;
  }
  const float* src = sfeats + (b * n + start) * static_cast<long long>(c);
  const int len = end - start;
  for (int ch = lane; ch < c; ch += 32) {
    float acc = kMax ? -INFINITY : 0.0f;
    const float* p = src + ch;
    for (int k = 0; k < len; ++k, p += c) {
      const float v = kRound ? round_bf16(*p) : *p;
      acc = kMax ? fmaxf(acc, v) : __fadd_rn(acc, v);
    }
    if (kMax) acc = acc == -INFINITY ? 0.0f : __fadd_rn(acc, 0.0f);
    dst[ch] = acc;
  }
}

template <bool kMax, bool kRound>
int sorted_scatter(const void* spids, const void* sfeats, void* first, void* out,
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
  reduce_runs<kMax, kRound><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      ids, static_cast<const float*>(sfeats), marks, static_cast<float*>(out),
      cells, n, c, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int himo_sorted_scatter_max_f32(const void* spids, const void* sfeats,
                                           void* first, void* out, int batch,
                                           int n, int c, int rows, void* stream) {
  return sorted_scatter<true, false>(spids, sfeats, first, out, batch, n, c, rows,
                                     stream);
}

extern "C" int himo_sorted_scatter_sum_f32(const void* spids, const void* sfeats,
                                           void* first, void* out, int batch,
                                           int n, int c, int rows, void* stream) {
  return sorted_scatter<false, false>(spids, sfeats, first, out, batch, n, c, rows,
                                      stream);
}

// K10: the sum above, each value rounded to bf16 on load when round_bf16 != 0.
extern "C" int himo_sorted_segment_sum_f32(const void* spids, const void* svals,
                                           void* first, void* out, int batch,
                                           int n, int c, int rows, int round_bf16,
                                           void* stream) {
  if (round_bf16) {
    return sorted_scatter<false, true>(spids, svals, first, out, batch, n, c, rows,
                                       stream);
  }
  return sorted_scatter<false, false>(spids, svals, first, out, batch, n, c, rows,
                                      stream);
}
