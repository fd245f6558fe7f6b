// Streaming k-nearest-neighbour distances: per query, the k smallest
// DISTINCT squared distances to a reference cloud, ascending; slots with no
// distance left read 3.0e38.
//
// Replaces the TPU kernel himo_tpu/ops/knn.py `_knn_kernel(k)` (called from
// `_knn_padded`). That kernel computes each (128 x 1024) distance block on
// the MXU as |q|^2 + |r|^2 - 2 q.r, takes the block's k smallest by k passes
// of (row min, mask every entry <= the min), and merges them into the
// running k-best with the same k passes over the 2k candidates. Masking
// every entry equal to the min makes exact-equal distances collapse into one
// slot, within a block and across blocks: the result is the k smallest
// distinct values, not a top-k (the reference's XLA fallback, lax.top_k,
// keeps duplicates; this kernel follows the TPU kernel).
//
// This port computes sum((q - r)^2) directly in fp32 on the CUDA cores, as
// nn.cu does (no tensor cores, no TF32), so its rounding is NOT the
// reference's: distances agree within a few ulps of |q|^2 + |r|^2. The
// collapse rule is the same, but it acts on each form's own rounding: two
// distinct references whose distances round to one value in one form and to
// two values in the other collapse in one and not the other. Exact duplicate
// references give equal distances in both forms and collapse in both.
//
// Design on the H100: one thread per query, frames of a batch on grid.y.
// A block stages a tile of 1,024 references through shared memory as float4
// (one 16-byte broadcast load per reference for the whole warp). Each thread
// keeps its k best in a sorted register array (k is a template parameter,
// 1..16, and the insert is fully unrolled, so the array stays in registers).
// A candidate below the current k-th value is inserted unless it equals a
// held value (the collapse rule); the insert is rare once the array is
// warm, so the inner loop is the distance, one compare and a branch. What
// bounds it: fp32 instruction throughput on the CUDA cores (about 8 per
// pair), as for nn.cu.
//
// Inputs: q (B, N, 3) fp32, r (B, M, 3) fp32, contiguous; output (B, N, k)
// fp32. The Python wrapper checks them and k.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;     // references per shared-memory tile (16 KiB)
constexpr float kEmpty = 3.0e38f;  // the reference's _INF

// Insert d into the ascending array best[0..K) unless it equals a held
// value; the caller has checked d < best[K - 1]. Every index is a
// compile-time constant after unrolling.
template <int K>
__device__ __forceinline__ void insert_distinct(float (&best)[K], float d) {
  bool held = false;
#pragma unroll
  for (int j = 0; j < K; ++j) held |= (best[j] == d);
  if (held) return;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const float prev = best[j - 1];
    best[j] = prev > d ? prev : (best[j] > d ? d : best[j]);
  }
  best[0] = best[0] > d ? d : best[0];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ q, const float* __restrict__ r,
           float* __restrict__ out, int n, int m) {
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
  float best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = kEmpty;
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
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      if (d < best[K - 1]) insert_distinct<K>(best, d);
    }
  }
  if (i < n) {
    float* o = out + (static_cast<long long>(b) * n + i) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) o[j] = best[j];
  }
}

template <int K>
int launch(const void* q, const void* r, void* out, int batch, int n, int m,
           cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for k outside 1..16.
extern "C" int himo_knn_f32(const void* q, const void* r, void* out, int batch,
                            int n, int m, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(q, r, out, batch, n, m, s);
    case 2: return launch<2>(q, r, out, batch, n, m, s);
    case 3: return launch<3>(q, r, out, batch, n, m, s);
    case 4: return launch<4>(q, r, out, batch, n, m, s);
    case 5: return launch<5>(q, r, out, batch, n, m, s);
    case 6: return launch<6>(q, r, out, batch, n, m, s);
    case 7: return launch<7>(q, r, out, batch, n, m, s);
    case 8: return launch<8>(q, r, out, batch, n, m, s);
    case 9: return launch<9>(q, r, out, batch, n, m, s);
    case 10: return launch<10>(q, r, out, batch, n, m, s);
    case 11: return launch<11>(q, r, out, batch, n, m, s);
    case 12: return launch<12>(q, r, out, batch, n, m, s);
    case 13: return launch<13>(q, r, out, batch, n, m, s);
    case 14: return launch<14>(q, r, out, batch, n, m, s);
    case 15: return launch<15>(q, r, out, batch, n, m, s);
    case 16: return launch<16>(q, r, out, batch, n, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
