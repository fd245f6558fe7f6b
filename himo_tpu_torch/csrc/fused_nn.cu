// Fused masked nearest-neighbour mins for the SSL chamfer terms (fp32).
//
// For queries q (N, 3) and references r (M, 3), with additive penalties
// qa, qd (N,) and ra, rd (M,) (0 = live, 1e14 = masked out):
//
//   dq_a[i] = min_j d2(i, j) + ra[j]     dq_d[i] = min_j d2(i, j) + rd[j]
//   dr_a[j] = min_i d2(i, j) + qa[i]     dr_d[j] = min_i d2(i, j) + qd[i]
//
// and, in the tracking variant, the index at which each min is reached
// (the lowest index among equal values).
//
// Replaces the TPU kernel himo_tpu/ops/nn.py `_fused_nn_kernel(track_idx)`
// (called from `_fused_pallas`), which computes each (query tile, ref tile)
// distance block once on the MXU as |q|^2 + |r|^2 - 2 q.r and folds it into
// row mins (streamed with the grid) and column mins (a VMEM-resident
// window). The column window relies on the TPU's grid running in order;
// Hopper's blocks run in no order, so this port takes the simplest design:
// two launches of one row-min kernel per call, the second with the roles
// swapped (references as queries, with the queries' penalties). Every
// distance is computed twice.
//
// The distance is sum((q - r)^2) computed directly in IEEE fp32 on the CUDA
// cores (3 subtracts, 1 multiply, 2 FMAs; no tensor cores, no TF32), like
// csrc/nn.cu, so it is not the reference's rounding: the two agree within a
// few ulps of |q|^2 + |r|^2, and a near-tie may resolve to another index.
//
// Design on the H100: one thread per query, frames of the batch on grid.y.
// A block stages a tile of references with both penalties in shared memory
// (a float4 of x, y, z, ra and a float of rd per reference; each warp reads
// one broadcast per reference) and every thread folds the tile into its two
// running mins, walking references in index order with a strict `<`.
//
// What bounds it: fp32 issue rate on the CUDA cores. Per pair and launch
// about 12 instructions (the distance, two penalty adds, two compares, and
// two selects, four with indices); 2 x 16,384 x 16,384 pairs per frame.
// The one-pass alternative (column mins merged across blocks with a 64-bit
// atomicMin on (bits(d2 + penalty) << 32 | index)) would halve the distance
// work; it is left for a later version.
//
// Inputs: q (B, N, 3), r (B, M, 3), qa, qd (B, N), ra, rd (B, M) fp32,
// contiguous; outputs dq_a, dq_d (B, N), dr_a, dr_d (B, M) fp32 and, with
// indices, iq_a, iq_d (B, N), ir_a, ir_d (B, M) int32. The Python wrapper
// checks them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // references per shared-memory tile (20 KiB)

template <bool kWithIndex>
__global__ void __launch_bounds__(kThreads)
masked_min_kernel(const float* __restrict__ q, const float* __restrict__ r,
                  const float* __restrict__ pa, const float* __restrict__ pd,
                  float* __restrict__ out_a, float* __restrict__ out_d,
                  int* __restrict__ idx_a, int* __restrict__ idx_d, int n,
                  int m) {
  __shared__ float4 tile[kTile];
  __shared__ float tile_pd[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* qb = q + static_cast<long long>(b) * n * 3;
  const float* rb = r + static_cast<long long>(b) * m * 3;
  const float* pab = pa + static_cast<long long>(b) * m;
  const float* pdb = pd + static_cast<long long>(b) * m;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (i < n) {
    qx = qb[3 * i];
    qy = qb[3 * i + 1];
    qz = qb[3 * i + 2];
  }
  float best_a = INFINITY, best_d = INFINITY;
  int arg_a = 0, arg_d = 0;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const float* p = rb + 3LL * (base + t);
      tile[t] = make_float4(p[0], p[1], p[2], pab[base + t]);
      tile_pd[t] = pdb[base + t];
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < count; ++t) {
      const float4 p = tile[t];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      const float va = d + p.w;
      const float vd = d + tile_pd[t];
      if (va < best_a) {
        best_a = va;
        if (kWithIndex) arg_a = base + t;
      }
      if (vd < best_d) {
        best_d = vd;
        if (kWithIndex) arg_d = base + t;
      }
    }
  }
  if (i < n) {
    const long long o = static_cast<long long>(b) * n + i;
    out_a[o] = best_a;
    out_d[o] = best_d;
    if (kWithIndex) {
      idx_a[o] = arg_a;
      idx_d[o] = arg_d;
    }
  }
}

template <bool kWithIndex>
int launch_side(const void* q, const void* r, const void* pa, const void* pd,
                void* out_a, void* out_d, void* idx_a, void* idx_d, int batch,
                int n, int m, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  masked_min_kernel<kWithIndex><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<const float*>(pa), static_cast<const float*>(pd),
      static_cast<float*>(out_a), static_cast<float*>(out_d),
      static_cast<int*>(idx_a), static_cast<int*>(idx_d), n, m);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWithIndex>
int launch(const void* q, const void* r, const void* qa, const void* qd,
           const void* ra, const void* rd, void* dq_a, void* dq_d, void* dr_a,
           void* dr_d, void* iq_a, void* iq_d, void* ir_a, void* ir_d,
           int batch, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_side<kWithIndex>(q, r, ra, rd, dq_a, dq_d, iq_a, iq_d,
                                    batch, n, m, s);
  if (err != 0) return err;
  return launch_side<kWithIndex>(r, q, qa, qd, dr_a, dr_d, ir_a, ir_d, batch,
                                 m, n, s);
}

}  // namespace

extern "C" int himo_fused_nn_f32(const void* q, const void* r, const void* qa,
                                 const void* qd, const void* ra,
                                 const void* rd, void* dq_a, void* dq_d,
                                 void* dr_a, void* dr_d, int batch, int n,
                                 int m, void* stream) {
  return launch<false>(q, r, qa, qd, ra, rd, dq_a, dq_d, dr_a, dr_d, nullptr,
                       nullptr, nullptr, nullptr, batch, n, m, stream);
}

extern "C" int himo_fused_nn_idx_f32(const void* q, const void* r,
                                     const void* qa, const void* qd,
                                     const void* ra, const void* rd,
                                     void* dq_a, void* dq_d, void* dr_a,
                                     void* dr_d, void* iq_a, void* iq_d,
                                     void* ir_a, void* ir_d, int batch, int n,
                                     int m, void* stream) {
  return launch<true>(q, r, qa, qd, ra, rd, dq_a, dq_d, dr_a, dr_d, iq_a,
                      iq_d, ir_a, ir_d, batch, n, m, stream);
}
