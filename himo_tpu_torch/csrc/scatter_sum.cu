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
// Design on the H100: the entry point zeroes the table (cudaMemsetAsync on
// the caller's stream, so the wrapper makes one Python-to-C crossing and
// no `torch.zeros` dispatch); one launch then adds every point's row with
// fp32 atomics whose result is unused (the compiler emits
// `red.global.add.f32`), at random rows.
// - C >= 32: one warp per point, lanes over channels. A 65-channel row is
//   260 bytes, not 16-byte aligned, so loads are scalar: the warp's reads
//   of one row are still contiguous.
// - C < 32 (the train step's 3- and 5-channel backwards): one thread per
//   (point, channel) element of one frame, the frame from blockIdx.y, so
//   consecutive lanes read consecutive floats and add into consecutive
//   floats of a few rows: one warp's `red` instruction reaches about
//   32 / C rows, so the L2 sees one sector request per row, not per value.
//   The only division is the element's point, e / C in 32 bits. Index
//   arithmetic is 32-bit when the values and the table have fewer than
//   2^31 floats, 64-bit otherwise. Two designs before it, both slower
//   (PERF.md): one thread per element with two 64-bit divisions each
//   (4.8 us per launch at 32,768 x 3 points), and one thread per point
//   adding its C values (7.2 us: each red instruction reached 32 rows).
// - A zero value is not added: the table starts at +0.0 and adding +-0.0
//   to a sum leaves it unchanged, so skipping is exact. Cotangents of the
//   ReLU'd pillar features are zero in about half the channels.
//
// What bounds it: bytes. At the 512x512 shape the table of 8 x 262,144 x
// 65 fp32 (545 MB, zeroed first) dwarfs the 136 MB of point rows; the
// atomics land at random rows, mostly in the 50 MB L2. At the 3-channel
// shapes the work is a few MB: the launch and the caller's host work
// dominate.
//
// The order of the additions is not fixed, so results differ from a
// sequential sum by rounding, from run to run.
//
// Inputs: ids (B, N) int32, vals (B, N, C) fp32, out (B * rows, C) fp32
// (any contents: zeroed here), all contiguous on one device. The Python
// wrappers check them.

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

// One thread per element e = point * c + channel of frame blockIdx.y (and
// every gridDim.y-th frame after it); Index is int or long long.
template <typename Index>
__global__ void scatter_sum_elem(const int* __restrict__ ids,
                                 const float* __restrict__ vals,
                                 float* __restrict__ out, int batch, int n,
                                 int c, int rows) {
  const Index e = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Index per_frame = static_cast<Index>(n) * c;
  if (e >= per_frame) return;
  const Index point = e / c;
  const int ch = static_cast<int>(e - point * c);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const int id = ids[b * static_cast<Index>(n) + point];
    if (static_cast<unsigned int>(id) >= static_cast<unsigned int>(rows)) continue;
    const float v = vals[b * per_frame + e];
    if (v != 0.0f) atomicAdd(out + (b * static_cast<Index>(rows) + id) * c + ch, v);
  }
}

}  // namespace

extern "C" int himo_scatter_sum_f32(const void* ids, const void* vals,
                                    void* out, int batch, int n, int c,
                                    int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long points = static_cast<long long>(batch) * n;
  const long long table = static_cast<long long>(batch) * rows * c;
  if (table > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, table * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (points == 0 || c == 0 || rows == 0) return static_cast<int>(cudaGetLastError());
  const int* i = static_cast<const int*>(ids);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  if (c >= 32) {
    const long long blocks = (points * 32 + kThreads - 1) / kThreads;
    scatter_sum_warp<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        i, v, o, points, n, c, rows);
  } else {
    const long long per_frame = static_cast<long long>(n) * c;
    const dim3 grid(static_cast<unsigned int>((per_frame + kThreads - 1) / kThreads),
                    batch < 65535 ? batch : 65535);
    const long long limit = 1LL << 31;
    if (points * c < limit && table < limit) {
      scatter_sum_elem<int><<<grid, kThreads, 0, s>>>(i, v, o, batch, n, c, rows);
    } else {
      scatter_sum_elem<long long><<<grid, kThreads, 0, s>>>(i, v, o, batch, n, c, rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
