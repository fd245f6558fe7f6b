// Per-pillar max of point features into a dense pillar image (fp32).
//
// Replaces two TPU kernels of himo_tpu/ops/voxelize.py, one per route of the
// reference (the Python wrappers count their launches apart):
// - `_sorted_scatter_table_band_kernel("max")` (called through
//   `_sorted_scatter_table_call` from `_sorted_scatter_forward`), the table
//   route: the 512x512 pillar pool at up to 81,920 points per cloud (wrapper
//   `ops.voxelize.scatter_max_rows`). It walks points in pillar-sorted order
//   over a VMEM-resident feature table and does one read-modify-write of a
//   pillar row per point.
// - `_scatter_kernel("max")` (called through `_scatter_rows_fn` from
//   `_scatter_rows_pallas`), the resident route: the 256x256 pillar pool,
//   whose whole image stays in VMEM while points stream past in their own
//   order (wrapper `ops.voxelize.scatter_max_resident_rows`).
// That sort/band/table/resident structure exists to fit the TPU's VMEM and
// its scalar unit; on the H100 the two are one computation and share this
// entry point. What is kept is the function:
//
//   out[b * rows + pid[b, i], :] = max over points i of feats[b, i, :]
//   rows that no point reaches read 0; points with pid >= rows are skipped.
//
// Design on the H100:
// - three launches on the caller's stream: fill the image with -inf, scatter,
//   then turn -inf (empty pillars) into 0 and -0.0 into +0.0;
// - one warp per point, lanes over channels: at C = 32 a point's feature row
//   is one coalesced 128-byte read, and its 32 atomics hit one 128-byte
//   output row;
// - float max through integer atomics: for a non-negative float the
//   signed-int order is the float order (atomicMax on int), for a negative
//   float the unsigned order is the reversed float order (atomicMin on
//   unsigned). A plain load first skips the atomic when the stored value is
//   already at least as large: the stored value only grows, so a stale load
//   can only cause a redundant atomic, never a lost update.
//
// What bounds it: random-address atomics on the 50 MB L2 (the 512x512x32
// fp32 image of one frame is 32 MiB; 8 frames are 256 MiB, so rows spill to
// HBM; at 256x256 the 8 frames' images are 64 MiB). Max does not depend on
// order, so the result is bitwise the same as any other order of the same
// maxima.
//
// Inputs: pids (B, N) int32, feats (B, N, C) fp32, out (B * rows, C) fp32,
// all contiguous on one device. The Python wrapper checks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void fill_neg_inf(float* __restrict__ out, long long count) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (; i < count; i += stride) out[i] = -INFINITY;
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__ldcg(addr) >= v) return;
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void scatter_max_rows(const int* __restrict__ pids,
                                 const float* __restrict__ feats,
                                 float* __restrict__ out, long long points,
                                 int n, int c, int rows) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= points) return;
  const int pid = pids[warp];
  if (static_cast<unsigned int>(pid) >= static_cast<unsigned int>(rows)) return;
  const long long b = warp / n;
  const float* src = feats + warp * c;
  float* dst = out + (b * rows + pid) * static_cast<long long>(c);
  for (int ch = lane; ch < c; ch += 32) atomic_max_float(dst + ch, src[ch]);
}

__global__ void finalize(float* __restrict__ out, long long count) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (; i < count; i += stride) {
    const float v = out[i];
    out[i] = v == -INFINITY ? 0.0f : __fadd_rn(v, 0.0f);
  }
}

int grid_for(long long count) {
  long long blocks = (count + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // a few waves over 132 SMs; loops stride
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int himo_scatter_max_f32(const void* pids, const void* feats,
                                    void* out, int batch, int n, int c,
                                    int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(batch) * rows * c;
  const long long points = static_cast<long long>(batch) * n;
  float* o = static_cast<float*>(out);
  fill_neg_inf<<<grid_for(cells), kThreads, 0, s>>>(o, cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (points > 0) {
    const long long threads = points * 32;
    const long long blocks = (threads + kThreads - 1) / kThreads;
    scatter_max_rows<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(pids), static_cast<const float*>(feats), o,
        points, n, c, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finalize<<<grid_for(cells), kThreads, 0, s>>>(o, cells);
  return static_cast<int>(cudaGetLastError());
}
