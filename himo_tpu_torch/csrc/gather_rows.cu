// Row gather from a dense pillar image (fp32).
//
//   out[b, i, :] = image[b * rows + min(max(id[b, i], 0), rows - 1), :]
//
// Replaces the TPU kernel himo_tpu/ops/voxelize.py `_gather_kernel` (called
// through `_gather_rows_fn` from `_diff_gather_resident_fn` in
// `gather_pillars`), the resident route: the 256x256 grid, where the
// reference keeps the whole (rows, C) image in VMEM and copies one row per
// point. The wrapper, `ops.voxelize.gather_rows`, sits behind
// `gather_pillars`' forward; its backward is the resident sum-scatter
// (`scatter_sum.cu` through `ops.nn.segment_rows_sum`), as in the reference.
// The caller zeroes the rows of points outside the grid afterwards.
//
// Design on the H100: one warp per point, lanes over channels. A point's
// output row is one contiguous write and its image row one contiguous read
// (65 channels are 260 bytes, not 16-byte aligned, so loads are scalar); the
// id is one broadcast load per warp. The 8 frames' 256x256 x 65 image is
// 136 MB, so the random row reads come mostly from HBM through the 50 MB L2.
//
// What bounds it: bytes (ids read once, the rows that points reach read, the
// (B, N, C) output written once).
//
// Inputs: ids (B, N) int32, image (B * rows, C) fp32 with rows >= 1, out
// (B, N, C) fp32, all contiguous on one device. The Python wrapper checks
// them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows(const int* __restrict__ ids,
                            const float* __restrict__ image,
                            float* __restrict__ out, long long points, int n,
                            int c, int rows) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= points) return;
  int id = ids[warp];
  id = id < 0 ? 0 : (id >= rows ? rows - 1 : id);
  const long long b = warp / n;
  const float* src = image + (b * rows + id) * static_cast<long long>(c);
  float* dst = out + warp * static_cast<long long>(c);
  for (int ch = lane; ch < c; ch += 32) dst[ch] = src[ch];
}

}  // namespace

extern "C" int himo_gather_rows_f32(const void* ids, const void* image,
                                    void* out, int batch, int n, int c,
                                    int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long points = static_cast<long long>(batch) * n;
  if (points == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (points * 32 + kThreads - 1) / kThreads;
  gather_rows<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(image),
      static_cast<float*>(out), points, n, c, rows);
  return static_cast<int>(cudaGetLastError());
}
