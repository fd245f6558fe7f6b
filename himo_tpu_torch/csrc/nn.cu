// Streaming nearest-neighbour search: per query, the min squared distance
// to a reference cloud (K6), and the min with the index of that reference
// point (K7).
//
// Replaces the TPU kernels himo_tpu/ops/nn.py `_nn_kernel` (called from
// `_nn_distance_sq_padded`) and `_nn_idx_kernel` (from `_nn_argmin_padded`).
// Those tile queries x references through VMEM and compute each distance
// block on the MXU as |q|^2 + |r|^2 - 2 q.r; the cancellation in that form is
// why the reference forces HIGHEST matmul precision. This port computes
// sum((q - r)^2) directly in fp32 on the CUDA cores (3 subtracts and
// 1 multiply + 2 FMAs per pair; no tensor cores, no TF32), so its rounding is
// NOT the reference's: distances agree within a few ulps of |q|^2 + |r|^2,
// and an exact near-tie may resolve to another index.
//
// Semantics kept from the reference:
// - the full N x M distance matrix is never materialised;
// - among equal distances the lowest index wins (the first-min rule of
//   `jnp.argmin`);
// - masking is the caller's: invalid rows sit at SENTINEL (1e6 m), so
//   invalid references lose every race and invalid queries are masked after.
//
// What bounds both: the fp32 instruction rate of the CUDA cores. A pair costs at
// least the distance (6 instructions) and a min (1).
//
// K6 (`nn_min_kernel`): one thread per query, frames of a batch on grid.y.
// A block stages a tile of references through shared memory as float4 (one
// 16-byte broadcast load per reference for the whole warp) and every thread
// folds the tile into its running min with a strict `<`.
//
// K7 (`nn_argmin_kernel`), laid out against the two limits of K6's layout
// (one 16-byte load per pair; at 8 frames x 4096 queries only 32k threads,
// a quarter of the card's resident threads, with a serial compare-and-select
// chain that tracks the index per pair):
// - each thread keeps kArgQueries queries in registers, so one broadcast
//   load of a reference feeds that many distances;
// - a block holds 32 x kArgQueries queries and its kArgWarps warps split
//   the reference walk into contiguous segments, one per warp, each staged
//   through the warp's own shared-memory tile; at 8 x 4096 queries that is
//   256 blocks of 256 threads, 1,024 at 1 x 65,536. The segments are merged
//   in shared memory by the lexicographic (value, chunk) minimum, which in
//   index order is the first-min rule; the merge costs a few shared loads
//   per query, so one layout serves every shape;
// - the inner loop is min-only: `fminf` folds each chunk of kArgChunk
//   references, and only at a chunk's end is the running min compared with
//   the value recorded before it; when it is strictly lower the chunk's
//   start is recorded. A query's answer lies in the first chunk that
//   reached its final min, so after the merge a warp walks that one chunk
//   again (from global memory) for the first index at that value, one
//   reference per lane and a ballot. The walk repeats the same
//   arithmetic, so the test is exact, and it costs kArgChunk pairs per
//   query, whatever the order of the cloud.
// About 7.3 instructions per pair remain (the distance, one `fminf`,
// a quarter of a broadcast load). `nvcc -Xptxas -v` for sm_90a: 60
// registers, 24,576 bytes of shared memory, no spills (K6: 32 registers).
// Tuned on the H100 among 2 or 4 queries per thread, 4, 8 or 16 warps per
// block and 32- or 64-reference chunks (scripts/torch_nn_ab.py).
//
// Inputs: q (B, N, 3) fp32, r (B, M, 3) fp32, contiguous; outputs d2 (B, N)
// fp32 and idx (B, N) int32. The Python wrapper checks them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float rx,
                                         float ry, float rz) {
  const float dx = qx - rx;
  const float dy = qy - ry;
  const float dz = qz - rz;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // references per shared-memory tile (16 KiB)

__global__ void __launch_bounds__(kThreads)
nn_min_kernel(const float* __restrict__ q, const float* __restrict__ r,
              float* __restrict__ d_out, int n, int m) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* qb = q + static_cast<long long>(b) * n * 3;
  const float* rb = r + static_cast<long long>(b) * m * 3;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (i < n) {
    qx = qb[3 * i];
    qy = qb[3 * i + 1];
    qz = qb[3 * i + 2];
  }
  float best = INFINITY;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const float* p = rb + 3LL * (base + t);
      tile[t] = make_float4(p[0], p[1], p[2], 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < count; ++t) {
      const float4 p = tile[t];
      const float d = sq_dist(qx, qy, qz, p.x, p.y, p.z);
      if (d < best) best = d;
    }
  }
  if (i < n) d_out[static_cast<long long>(b) * n + i] = best;
}

constexpr int kArgWarps = 8;      // reference segments per block, one per warp
constexpr int kArgQueries = 4;    // queries per thread, in registers
constexpr int kArgChunk = 32;     // references folded between index checks
constexpr int kArgTile = 128;     // references per warp's shared tile (2 KiB)
constexpr int kArgBlockQueries = 32 * kArgQueries;
static_assert(kArgTile % kArgChunk == 0 && kArgChunk % 32 == 0, "chunks fill tiles and warps");

__global__ void __launch_bounds__(kArgWarps * 32)
nn_argmin_kernel(const float* __restrict__ q, const float* __restrict__ r,
                 float* __restrict__ d_out, int* __restrict__ i_out, int n,
                 int m, int seg) {
  __shared__ float4 tile[kArgWarps][kArgTile];
  __shared__ float part_d[kArgWarps][kArgBlockQueries];
  __shared__ int part_c[kArgWarps][kArgBlockQueries];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kArgBlockQueries;
  const float* qb = q + static_cast<long long>(b) * n * 3;
  const float* rb = r + static_cast<long long>(b) * m * 3;
  const int begin = warp * seg;
  const int end = min(m, begin + seg);
  float qx[kArgQueries], qy[kArgQueries], qz[kArgQueries];
  float best[kArgQueries], rec[kArgQueries];
  int chunk[kArgQueries];
#pragma unroll
  for (int k = 0; k < kArgQueries; ++k) {
    const int i = q0 + 32 * k + lane;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (i < n) {
      qx[k] = qb[3 * i];
      qy[k] = qb[3 * i + 1];
      qz[k] = qb[3 * i + 2];
    }
    best[k] = rec[k] = INFINITY;
    chunk[k] = begin;
  }
  for (int base = begin; base < end; base += kArgTile) {
    const int count = min(kArgTile, end - base);
    __syncwarp();
    // Past the segment's end the tile holds +inf points: their distance is
    // +inf and never lowers a min, so every chunk is folded whole.
    for (int t = lane; t < kArgTile; t += 32) {
      float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
      if (t < count) {
        const float* s = rb + 3LL * (base + t);
        p = make_float4(s[0], s[1], s[2], 0.0f);
      }
      tile[warp][t] = p;
    }
    __syncwarp();
    for (int c = 0; c < count; c += kArgChunk) {
#pragma unroll
      for (int t = 0; t < kArgChunk; ++t) {
        const float4 p = tile[warp][c + t];
#pragma unroll
        for (int k = 0; k < kArgQueries; ++k)
          best[k] = fminf(best[k], sq_dist(qx[k], qy[k], qz[k], p.x, p.y, p.z));
      }
#pragma unroll
      for (int k = 0; k < kArgQueries; ++k) {
        if (best[k] < rec[k]) {
          rec[k] = best[k];
          chunk[k] = base + c;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kArgQueries; ++k) {
    part_d[warp][32 * k + lane] = rec[k];
    part_c[warp][32 * k + lane] = chunk[k];
  }
  __syncthreads();
  // Each warp takes every kArgWarps-th query of the block: the segments'
  // merge in index order with a strict `<` (the first chunk at the min),
  // then one reference of that chunk per lane and a ballot for the first.
  for (int t = warp; t < kArgBlockQueries; t += kArgWarps) {
    const int i = q0 + t;
    if (i >= n) break;
    float v = part_d[0][t];
    int c = part_c[0][t];
    for (int w = 1; w < kArgWarps; ++w) {
      if (part_d[w][t] < v) {
        v = part_d[w][t];
        c = part_c[w][t];
      }
    }
    int found = c;
    for (int lo = c; lo < c + kArgChunk; lo += 32) {
      const int j = lo + lane;
      bool hit = false;
      if (j < m) {
        const float* s = rb + 3LL * j;
        hit = sq_dist(qb[3 * i], qb[3 * i + 1], qb[3 * i + 2], s[0], s[1], s[2]) == v;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot) {
        found = lo + __ffs(ballot) - 1;
        break;
      }
    }
    if (lane == 0) {
      const long long o = static_cast<long long>(b) * n + i;
      d_out[o] = v;
      i_out[o] = found;
    }
  }
}

}  // namespace

extern "C" int himo_nn_min_f32(const void* q, const void* r, void* d2,
                               int batch, int n, int m, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  nn_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<float*>(d2), n, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int himo_nn_argmin_f32(const void* q, const void* r, void* d2,
                                  void* idx, int batch, int n, int m,
                                  void* stream) {
  // Each warp's segment: a whole number of chunks, so chunks start at
  // multiples of kArgChunk; trailing warps may get none.
  const int per_warp = (m + kArgWarps - 1) / kArgWarps;
  const int seg = (per_warp + kArgChunk - 1) / kArgChunk * kArgChunk;
  const dim3 grid((n + kArgBlockQueries - 1) / kArgBlockQueries, batch);
  nn_argmin_kernel<<<grid, kArgWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<float*>(d2), static_cast<int*>(idx), n, m, seg);
  return static_cast<int>(cudaGetLastError());
}
