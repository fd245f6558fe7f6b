// Row scatter-add of point values into a dense fp32 table (fp32).
//
//   out[b * rows + id[b, i], :] += vals[b, i, :]   for every i with
//   0 <= id[b, i] < rows; ids outside that range are skipped.
//
// Replaces two TPU kernels of the SSL train step's backward pass:
// - himo_tpu/ops/voxelize.py `_sorted_scatter_table_band_kernel("sum")`
//   (reached from `_sorted_scatter_forward` in `_diff_gather_sorted_fn`'s
//   backward): the 512x512 `gather_pillars` backward, 8 frames x 65,536
//   points x 65 channels into 262,144 pillar rows per frame (Python wrapper
//   `ops.voxelize.scatter_sum_rows`).
// - himo_tpu/ops/voxelize.py `_scatter_kernel("sum")` (reached from
//   `himo_tpu/ops/nn.py::segment_rows_sum`), the backward of `take_rows`
//   and `fused_masked_nn`: 3-channel rows into 65,536 or 16,384 rows per
//   frame (Python wrapper `ops.nn.segment_rows_sum`).
// Both wrappers launch the one entry point `himo_scatter_sum_f32`, and each
// counts its own launches.
// The TPU kernels sort points into row bands and keep a band (or the whole
// image) resident in VMEM, because the TPU has no scatter-add into HBM;
// none of that is carried over. What is kept is the function.
//
// Design on the H100: the wrapper zeroes the output; one launch then adds
// every point's row with fp32 atomics whose result is unused (the compiler
// emits `red.global.add.f32`), at random rows.
// - C >= 32: one warp per point, lanes over channels. A 65-channel row is
//   260 bytes, not 16-byte aligned, so loads are scalar: the warp's reads
//   of one row are still contiguous.
// - C < 32: one thread per (point, channel) element, so consecutive
//   threads read consecutive floats of the (points, C) input.
// - A zero value is not added: the table starts at +0.0 and adding +-0.0
//   to a sum leaves it unchanged, so skipping is exact. Cotangents of the
//   ReLU'd pillar features are zero in about half the channels.
//
// What bounds it: bytes. At the 512x512 shape the table of 8 x 262,144 x
// 65 fp32 (545 MB, zeroed by the wrapper) dwarfs the 136 MB of point rows;
// the atomics land at random rows, mostly in the 50 MB L2. At the 3-channel
// shapes the work is a few MB and the launch itself dominates.
//
// The order of the additions is not fixed, so results differ from a
// sequential sum by rounding, from run to run.
//
// Inputs: ids (B, N) int32, vals (B, N, C) fp32, out (B * rows, C) fp32
// zeroed, all contiguous on one device. The Python wrappers check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_sum_warp(const int* __restrict__ ids,
                                 const float* __restrict__ vals,
                                 float* __restrict__ out, long long points,
                                 int n, int c, int rows) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= points) return;
  const int id = ids[warp];
  if (static_cast<unsigned int>(id) >= static_cast<unsigned int>(rows)) return;
  const long long b = warp / n;
  const float* src = vals + warp * c;
  float* dst = out + (b * rows + id) * static_cast<long long>(c);
  for (int ch = lane; ch < c; ch += 32) {
    const float v = src[ch];
    if (v != 0.0f) atomicAdd(dst + ch, v);
  }
}

__global__ void scatter_sum_elem(const int* __restrict__ ids,
                                 const float* __restrict__ vals,
                                 float* __restrict__ out, long long count,
                                 int n, int c, int rows) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= count) return;
  const long long p = e / c;
  const int ch = static_cast<int>(e - p * c);
  const int id = ids[p];
  if (static_cast<unsigned int>(id) >= static_cast<unsigned int>(rows)) return;
  const float v = vals[e];
  if (v == 0.0f) return;
  const long long b = p / n;
  atomicAdd(out + (b * rows + id) * static_cast<long long>(c) + ch, v);
}

}  // namespace

extern "C" int himo_scatter_sum_f32(const void* ids, const void* vals,
                                    void* out, int batch, int n, int c,
                                    int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long points = static_cast<long long>(batch) * n;
  if (points == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int* i = static_cast<const int*>(ids);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  if (c >= 32) {
    const long long blocks = (points * 32 + kThreads - 1) / kThreads;
    scatter_sum_warp<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        i, v, o, points, n, c, rows);
  } else {
    const long long count = points * c;
    const long long blocks = (count + kThreads - 1) / kThreads;
    scatter_sum_elem<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        i, v, o, count, n, c, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
