// Row gather at a stream of pillar ids sorted in each frame (fp32).
//
//   out[b, dst(j), :] = image[b * rows + spids[b, j], :]   if spids[b, j] < rows
//                     = 0                                  otherwise,
//   dst(j) = j (K11) or order[b, j] (K5).
//
// Replaces two TPU kernels:
// - himo_tpu/ops/mxu_scatter.py `_gather_band_kernel` (K11, called through
//   `_gather_call` from `gather_rows_sorted`): `pooling='mean_sorted'`'s
//   gather of the UNet's output image (64 channels plus the slot channel) at
//   sweep 0's sorted pillar ids, and the backward of that mode's sorted sum
//   (K10). The TPU kernel takes 128 sorted points at a time as a one-hot
//   matmul over a window of image rows; with `mxu_bf16` it rounds the image
//   to bf16 first, which `himo_sorted_segment_gather_f32` takes as a flag
//   (each value rounded on load, round to nearest even). Ids >= rows read 0,
//   where the reference reads the 8 zero rows appended to its image. The
//   wrapper is `ops.mxu_scatter.sorted_segment_gather`.
// - himo_tpu/ops/voxelize.py `_sorted_gather_band_kernel` (K5, called through
//   `_sorted_gather_call` from `_sorted_gather_forward`): the scatter-max
//   backward's take of the (cotangent, max) image at each point's pillar,
//   read in pillar-sorted order and written back to each point's own
//   position `order[b, j]`. The reference reaches it under
//   HIMO_MAXBWD_PALLAS=1; the port runs it on the table and stream routes
//   always. Ids >= rows read 0 (the reference reads its scatter's trash row;
//   the backward masks those points either way). The wrapper is
//   `ops.voxelize.sorted_gather_rows`.
//
// Design on the H100: what sortedness buys over gather_rows.cu (one warp per
// point, one image row read per point) is that all points of a pillar are
// neighbours in the stream. One warp per 32 sorted positions of a frame,
// one id per lane: the warp takes the chunk's runs of equal ids in turn
// (the run's first id by a shuffle, its end by a ballot), reads each run's
// image row once, 32 channels at a time into registers, and writes them to
// every point of the run: contiguous rows for K11, one row per point at
// `order` for K5. Each point's row is a 32-lane contiguous write. A run that
// crosses chunks is read once per chunk, still far fewer reads than one per
// point. Each warp writes at most 32 rows, so a long run (the ids past the
// grid, 8 % of a padded frame, or a near-sensor pillar) spreads over many
// warps: a first version with one warp per whole run left those to one warp
// and ran 2-4x slower (PERF.md). No scratch, no atomics; every output row is
// written exactly once (ids >= rows form runs too, which write zeros). The
// kernel is right for unsorted ids too, only slower.
//
// What bounds it: bytes (the ids, and `order` for K5, read once; the image
// rows the ids reach read once; the (B, N, C) output written once).
//
// Inputs: spids (B, N) int32 sorted in each frame, order (B, N) int32 (K5: a
// permutation of 0..N-1 in each frame), image (B * rows, C) fp32, out
// (B, N, C) fp32, all contiguous on one device. The Python wrappers check
// them (not the order, nor that `order` is a permutation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kOrder, bool kRound>
__global__ void gather_runs(const int* __restrict__ spids,
                            const int* __restrict__ order,
                            const float* __restrict__ image,
                            float* __restrict__ out, long long chunks, int n,
                            int c, int rows) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= chunks) return;  // the whole warp: blockDim is a multiple of 32
  const int per_frame = (n + 31) / 32;
  const long long b = warp / per_frame;
  const int first = static_cast<int>(warp - b * per_frame) * 32;
  const int count = min(32, n - first);
  const int* ids = spids + b * n + first;
  const int mine = lane < count ? ids[lane] : 0;
  const int* dst = kOrder ? order + b * n + first : nullptr;
  float* frame = out + b * n * static_cast<long long>(c);
  for (int start = 0; start < count;) {
    const int id = __shfl_sync(0xffffffffu, mine, start);
    const unsigned int same = __ballot_sync(0xffffffffu, lane < count && mine == id);
    const unsigned int rest = ~same & (0xffffffffu << start);
    const int end = rest ? min(__ffs(rest) - 1, count) : count;
    const bool live = static_cast<unsigned int>(id) < static_cast<unsigned int>(rows);
    const float* src = image + (b * rows + (live ? id : 0)) * static_cast<long long>(c);
    for (int ch = lane; ch < c; ch += 32) {
      float v = 0.0f;
      if (live) v = kRound ? round_bf16(src[ch]) : src[ch];
      for (int p = start; p < end; ++p) {
        const long long row = kOrder ? dst[p] : first + p;
        frame[row * c + ch] = v;
      }
    }
    start = end;
  }
}

template <bool kOrder, bool kRound>
int launch(const void* spids, const void* order, const void* image, void* out,
           int batch, int n, int c, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = static_cast<long long>(batch) * ((n + 31) / 32);
  if (chunks == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (chunks * 32 + kThreads - 1) / kThreads;
  gather_runs<kOrder, kRound><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(spids), static_cast<const int*>(order),
      static_cast<const float*>(image), static_cast<float*>(out), chunks, n, c, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11: out[b, j] = image[b, spids[b, j]] (0 for ids >= rows), each image value
// rounded to bf16 on load when round_bf16 != 0.
extern "C" int himo_sorted_segment_gather_f32(const void* spids, const void* image,
                                              void* out, int batch, int n, int c,
                                              int rows, int round_bf16,
                                              void* stream) {
  if (round_bf16) {
    return launch<false, true>(spids, nullptr, image, out, batch, n, c, rows, stream);
  }
  return launch<false, false>(spids, nullptr, image, out, batch, n, c, rows, stream);
}

// K5: out[b, order[b, j]] = image[b, spids[b, j]] (0 for ids >= rows).
extern "C" int himo_sorted_gather_rows_f32(const void* spids, const void* order,
                                           const void* image, void* out, int batch,
                                           int n, int c, int rows, void* stream) {
  return launch<true, false>(spids, order, image, out, batch, n, c, rows, stream);
}
