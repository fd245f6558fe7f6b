// Streaming nearest-neighbour search: per query, the min squared distance
// to a reference cloud, and optionally the index of that reference point.
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
// - references are walked in index order with a strict `<`, so among equal
//   distances the lowest index wins (the first-min rule of `jnp.argmin`);
// - masking is the caller's: invalid rows sit at SENTINEL (1e6 m), so
//   invalid references lose every race and invalid queries are masked after.
//
// Design on the H100: one thread per query, frames of a batch on grid.y.
// A block stages a tile of references through shared memory as float4
// (one 16-byte broadcast load per reference for the whole warp) and every
// thread of the block folds the tile into its running min. What bounds it:
// fp32 issue rate on the CUDA cores (about 8 instructions per pair); at
// 8 frames x 4096 queries there are 32k threads, a quarter of the card's
// resident-thread capacity, so latency hiding is thin. A later version can
// split the reference walk over several threads per query.
//
// Inputs: q (B, N, 3) fp32, r (B, M, 3) fp32, contiguous; outputs d2 (B, N)
// fp32 and idx (B, N) int32. The Python wrapper checks them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // references per shared-memory tile (16 KiB)

template <bool kWithIndex>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q, const float* __restrict__ r,
          float* __restrict__ d_out, int* __restrict__ i_out, int n, int m) {
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
  int best_i = 0;
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
      if (d < best) {
        best = d;
        if (kWithIndex) best_i = base + t;
      }
    }
  }
  if (i < n) {
    const long long o = static_cast<long long>(b) * n + i;
    d_out[o] = best;
    if (kWithIndex) i_out[o] = best_i;
  }
}

template <bool kWithIndex>
int launch(const void* q, const void* r, void* d2, void* idx, int batch,
           int n, int m, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  nn_kernel<kWithIndex><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<float*>(d2), static_cast<int*>(idx), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int himo_nn_min_f32(const void* q, const void* r, void* d2,
                               int batch, int n, int m, void* stream) {
  return launch<false>(q, r, d2, nullptr, batch, n, m, stream);
}

extern "C" int himo_nn_argmin_f32(const void* q, const void* r, void* d2,
                                  void* idx, int batch, int n, int m,
                                  void* stream) {
  return launch<true>(q, r, d2, idx, batch, n, m, stream);
}
