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
// least the distance (6 instructions) and a min (1): at 8 frames x 4,096
// queries x 8,192 references, 268.4 M pairs x 7 instructions over 132 SMs x
// 128 lanes at about 1.98 GHz is about 0.056 ms.
//
// Both kernels share one layout, against the limits of a thread-per-query
// walk (one 16-byte shared load per pair; at 8 frames x 4,096 queries only
// 32k threads, each a serial chain; two block-wide barriers around every
// tile, staged while the block waits):
// - each thread keeps several queries in registers, so one broadcast load
//   of a reference feeds that many distances;
// - a block holds 32 x (queries a thread) queries and its warps split the
//   reference walk into contiguous segments, one per warp, each staged
//   through the warp's own shared-memory tile padded with +inf points, so
//   no block barrier falls inside the walk; the segments meet once, in
//   shared memory, at the end.
//
// K6 (`nn_min_kernel`) folds with `fminf` alone (one instruction where a
// compare and a select were two), with no chunk record and no re-walk:
// 8 queries a thread, 16 warps a block (256 queries; 128 blocks at 8 frames
// x 4,096 queries, one per SM), 128-reference warp tiles whose next points
// are loaded into registers while the current tile is folded. About 7.1
// instructions a pair remain (the distance, one `fminf`, an eighth of a
// broadcast load). The min of a set does not depend on the order of the
// fold, the direct form never gives -0.0, and `fminf` skips a NaN as a
// strict `<` does, so any walk order gives the same bits: K6 equals K7's d2
// bit for bit. A query whose distances are all NaN or +inf gets +inf.
// `nvcc -Xptxas -v` for sm_90a: 84 registers, 32,768 bytes of shared
// memory, no spills. Tuned on the H100 among 2, 4 or 8 queries a thread,
// 4, 8, 16 or 32 warps a block, 64-, 128- or 256-reference tiles, 16-, 32-
// or 64-reference steps, with and without the prefetch
// (scripts/torch_nn_ab.py).
//
// K7 (`nn_argmin_kernel`) tracks the index too:
// - the inner loop is min-only: `fminf` folds each chunk of kArgChunk
//   references, and only at a chunk's end is the running min compared with
//   the value recorded before it; when it is strictly lower the chunk's
//   start is recorded. The segments are merged in shared memory by the
//   lexicographic (value, chunk) minimum, which in index order is the
//   first-min rule. A query's answer lies in the first chunk that
//   reached its final min, so after the merge a warp walks that one chunk
//   again (from global memory) for the first index at that value, one
//   reference per lane and a ballot. The walk repeats the same
//   arithmetic, so the test is exact, and it costs kArgChunk pairs per
//   query, whatever the order of the cloud.
// About 7.3 instructions per pair remain (the distance, one `fminf`,
// a quarter of a broadcast load). `nvcc -Xptxas -v` for sm_90a: 60
// registers, 24,576 bytes of shared memory, no spills. Tuned on the H100
// among 2 or 4 queries per thread, 4, 8 or 16 warps per block and 32- or
// 64-reference chunks (scripts/torch_nn_ab.py).
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

constexpr int kMinWarps = 16;     // reference segments per block, one per warp
constexpr int kMinQueries = 8;    // queries per thread, in registers
constexpr int kMinTile = 128;     // references per warp's shared tile (2 KiB)
constexpr int kMinStep = 32;      // references folded per unrolled step
constexpr int kMinBlockQueries = 32 * kMinQueries;
static_assert(kMinTile % kMinStep == 0 && kMinTile % 32 == 0, "steps and lanes fill tiles");
static_assert(4 * kMinTile >= kMinBlockQueries, "a warp's tile holds its segment mins");

// A lane's points of the tile at `base`: references base + lane + 32 j,
// +inf past `end`. An +inf point's distance is +inf (or NaN) and never
// lowers a min, so a tile's padding is folded like any point.
template <int kPer>
__device__ __forceinline__ void fetch_points(const float* __restrict__ rb, int base, int end,
                                             int lane, float (&x)[kPer], float (&y)[kPer],
                                             float (&z)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int t = base + lane + 32 * j;
    x[j] = y[j] = z[j] = INFINITY;
    if (t < end) {
      const float* s = rb + 3LL * t;
      x[j] = s[0];
      y[j] = s[1];
      z[j] = s[2];
    }
  }
}

__global__ void __launch_bounds__(kMinWarps * 32)
nn_min_kernel(const float* __restrict__ q, const float* __restrict__ r,
              float* __restrict__ d_out, int n, int m, int seg) {
  __shared__ float4 tile[kMinWarps][kMinTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kMinBlockQueries;
  const float* qb = q + static_cast<long long>(b) * n * 3;
  const float* rb = r + static_cast<long long>(b) * m * 3;
  const int begin = warp * seg;
  const int end = min(m, begin + seg);
  float qx[kMinQueries], qy[kMinQueries], qz[kMinQueries], best[kMinQueries];
#pragma unroll
  for (int k = 0; k < kMinQueries; ++k) {
    const int i = q0 + 32 * k + lane;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (i < n) {
      qx[k] = qb[3 * i];
      qy[k] = qb[3 * i + 1];
      qz[k] = qb[3 * i + 2];
    }
    best[k] = INFINITY;
  }
  // Each lane stages kMinTile / 32 points of a tile; the next tile's loads
  // are issued before the current one is folded.
  constexpr int kPer = kMinTile / 32;
  float nx[kPer], ny[kPer], nz[kPer];
  fetch_points(rb, begin, end, lane, nx, ny, nz);
  for (int base = begin; base < end; base += kMinTile) {
    const int count = min(kMinTile, end - base);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      tile[warp][lane + 32 * j] = make_float4(nx[j], ny[j], nz[j], 0.0f);
    __syncwarp();
    fetch_points(rb, base + kMinTile, end, lane, nx, ny, nz);
    for (int c = 0; c < count; c += kMinStep) {
#pragma unroll
      for (int t = 0; t < kMinStep; ++t) {
        const float4 p = tile[warp][c + t];
#pragma unroll
        for (int k = 0; k < kMinQueries; ++k)
          best[k] = fminf(best[k], sq_dist(qx[k], qy[k], qz[k], p.x, p.y, p.z));
      }
    }
  }
  // Each warp leaves its segment mins in its own tile, then the block
  // meets once: one thread per query folds the warps' mins.
  __syncwarp();
  float* part = reinterpret_cast<float*>(tile[warp]);
#pragma unroll
  for (int k = 0; k < kMinQueries; ++k) part[32 * k + lane] = best[k];
  __syncthreads();
  for (int t = threadIdx.x; t < kMinBlockQueries; t += kMinWarps * 32) {
    const int i = q0 + t;
    if (i >= n) break;
    float v = reinterpret_cast<const float*>(tile[0])[t];
    for (int w = 1; w < kMinWarps; ++w)
      v = fminf(v, reinterpret_cast<const float*>(tile[w])[t]);
    d_out[static_cast<long long>(b) * n + i] = v;
  }
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
  // Each warp's segment: a whole number of steps; trailing warps may get none.
  const int per_warp = (m + kMinWarps - 1) / kMinWarps;
  const int seg = (per_warp + kMinStep - 1) / kMinStep * kMinStep;
  const dim3 grid((n + kMinBlockQueries - 1) / kMinBlockQueries, batch);
  nn_min_kernel<<<grid, kMinWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<float*>(d2), n, m, seg);
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
