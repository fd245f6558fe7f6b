// Row gathers from a dense pillar image (fp32).
//
//   K4:  out[b, j, :] = image[b * rows + min(max(ids[b, j], 0), rows - 1), :]
//   K11: out[b, j, :] = image[b * rows + spids[b, j], :]   if spids[b, j] < rows
//                     = 0                                  otherwise
//   K5:  out[b, order[b, j], :] = the K11 row of spids[b, j]
//
// Replaces three TPU kernels:
// - himo_tpu/ops/voxelize.py `_gather_kernel` (K4, called through
//   `_gather_rows_fn` from `_diff_gather_resident_fn` in `gather_pillars`):
//   the resident route's gather, the 256x256 grid, where the reference keeps
//   the whole (rows, C) image in VMEM and copies one row per point. Ids come
//   in the points' own order, unsorted. The wrapper is
//   `ops.voxelize.gather_rows`; its backward is the resident sum-scatter
//   (`scatter_sum.cu` through `ops.nn.segment_rows_sum`), as in the
//   reference. The caller zeroes the rows of points outside the grid
//   afterwards.
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
// Design on the H100: every output row is written exactly once; no scratch,
// no atomics. Sorted ids (K11, K5) put all points of a pillar next to each
// other in the stream, so each distinct row is read from device memory
// about once; unsorted ids (K4) read a row where each point falls.
//
// K4 and K11 (`gather_tile`, one template with the id rule as a parameter:
// clamp for K4, read 0 outside [0, rows) for K11): the output rows of
// consecutive positions are one contiguous span, so a block takes a tile of
// 128 consecutive positions of the flattened (B * N) stream (a tile may
// straddle two frames), puts each position's image row offset in shared
// memory (-1 for K11's ids >= rows; one 32-bit division per position finds
// its frame), and walks the tile's span of 128 * C floats as 16-byte words,
// one `st.global.v4.f32` each: consecutive threads write consecutive words.
// Each word's four floats resolve to (position, channel) pairs with one
// division per word, then a step per float. A K11 run's row is read again
// by the next position, and that read hits L1. The few floats before the
// span's first 16-byte boundary and after its last are stored one by one
// (N * C is not a multiple of 4 for odd C). Index arithmetic is 32-bit when
// the output and the image have fewer than 2^31 floats, 64-bit otherwise.
// The earlier design of both gave one warp to a point (K4) or to 32 sorted
// positions (K11) with lanes over channels: at C = 65 each row took passes
// of 32, 32 and 1 live lanes and three scalar store instructions into rows
// that are not 16-byte aligned; it ran at 1.2x (K4) and 1.35x (K11)
// `index_select` (PERF.md).
//
// K5 (`gather_scattered`): its output rows are scattered through `order`,
// so the span trick does not apply, but each row is still one contiguous
// run of C floats in the image and in the output. A block takes a tile of
// kRunTile consecutive positions of the flattened (B * N) stream (a tile may
// straddle two frames), stages each position's image row offset (-1 for ids
// outside [0, rows)) and its output row offset (frame * N + order) in
// shared memory with coalesced loads, then walks the tile's rows as words:
// 16-byte words (`ld.global.nc.v4` / `st.global.v4`) when C % 4 == 0 and
// both the image and the output are 16-byte aligned, else single floats.
// Consecutive threads take consecutive words of one row, so every row read
// and every row write (256 B at C = 64) is a full, coalesced access. Each
// thread loads kRunUnroll independent words before it stores any of them:
// no per-run loop, no ballot, no reload of `order` per channel pass. The
// rows of a run are read again by its next position, and that read hits
// L1/L2, so runs are not deduplicated. With 32 positions and 256 threads a
// block, C = 64 is one pass of 2 loads then 2 stores a thread, and SegNet's
// 1 x 32,768 is 1,024 blocks: one wave that fills the card's thread slots,
// every row in flight at once. Tiles of 64 positions with 4 loads a thread,
// 128 with 8 and 16 with 1 took 0.5 %, 0.5 % and 8 % longer at B8 x 65,536
// x 64, and 10 %, 20 % and 0 % longer at 1 x 32,768 x 64; streaming stores
// (`st.global.cs`) changed nothing beyond the spread (PERF.md). What bounds
// it is bytes: at B8 x 65,536 x 64 it moves them at 0.86 of the card's
// memory rate. Index arithmetic is 64-bit at every size: a 32-bit instance
// below 2^31 floats took the same time at B8 x 65,536 and B8 x 131,072 x
// 64, and 2-7 % less only at 1 x 32,768 x 64 and at C = 1 (PERF.md).
// The earlier design (`gather_runs`) gave one warp to 32 sorted
// positions of a frame and walked their runs of equal ids one after another
// (the run's id by a shuffle, its end by a ballot, 4-byte loads of the row
// 32 channels a pass, a store loop reloading `order` per point and pass):
// about one point per run at these densities, so some 32 dependent trips
// to memory a warp, 1,024 warps at B1 x 32,768, 12 % of the card's warp
// slots. On an H100 80GB HBM3 at 700 W it took 0.1382 ms of device time at
// B8 x 65,536 x 64 (bound 0.0730), against 0.0854 now, and 0.0187 ms at
// 1 x 32,768 x 64 (0.0357 with a cold L2; bound 0.0044), against 0.0041
// (0.0081) now (PERF.md).
//
// What bounds all three: bytes (the ids, and `order` for K5, read once; the
// image rows the ids reach read once; the (B, N, C) output written once).
//
// Inputs: ids (B, N) int32 (sorted in each frame for K11 and K5), order
// (B, N) int32 (K5: a permutation of 0..N-1 in each frame), image
// (B * rows, C) fp32 (K4: rows >= 1), out (B, N, C) fp32, all contiguous on
// one device. The Python wrappers check them (not the order, nor that
// `order` is a permutation).

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int kTile = 128;  // K4, K11: positions per block

// K4, K11: one block per tile of kTile consecutive positions; Index is int
// or long long; kClamp clamps ids to [0, rows - 1] (K4), else ids outside
// [0, rows) read 0 (K11).
template <typename Index, bool kRound, bool kClamp>
__global__ void gather_tile(const int* __restrict__ ids,
                            const float* __restrict__ image,
                            float* __restrict__ out, Index positions, int n,
                            int c, int rows) {
  __shared__ Index src[kTile];  // image offset of each position's row, or -1
  const Index p0 = static_cast<Index>(blockIdx.x) * kTile;
  const int count = static_cast<int>(min(static_cast<Index>(kTile), positions - p0));
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const Index p = p0 + k;
    const int id = ids[p];
    if (kClamp) {
      src[k] = (p / n * rows + min(max(id, 0), rows - 1)) * c;
    } else {
      const bool live = static_cast<unsigned int>(id) < static_cast<unsigned int>(rows);
      src[k] = live ? (p / n * rows + id) * c : Index(-1);
    }
  }
  __syncthreads();
  auto value = [&](int k, int ch) {
    const Index at = src[k];
    if (!kClamp && at < 0) return 0.0f;
    return kRound ? round_bf16(image[at + ch]) : image[at + ch];
  };
  // The tile's output is floats [lo, hi) of out; [head, tail) is its
  // 16-byte-aligned part (out itself is aligned: PyTorch's allocator).
  const Index lo = p0 * c;
  const Index hi = lo + static_cast<Index>(count) * c;
  const Index head = min(hi, (lo + 3) / 4 * 4);
  const Index tail = max(head, hi / 4 * 4);
  for (Index f = lo + threadIdx.x; f < head; f += blockDim.x) {
    const int off = static_cast<int>(f - lo);
    out[f] = value(off / c, off % c);
  }
  for (Index f = tail + threadIdx.x; f < hi; f += blockDim.x) {
    const int off = static_cast<int>(f - lo);
    out[f] = value(off / c, off % c);
  }
  for (Index w = head + 4 * static_cast<Index>(threadIdx.x); w < tail;
       w += 4 * static_cast<Index>(blockDim.x)) {
    const int off = static_cast<int>(w - lo);
    int k = off / c;
    int ch = off - k * c;
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = value(k, ch);
      if (++ch == c) {
        ch = 0;
        ++k;
      }
    }
    *reinterpret_cast<float4*>(out + w) = make_float4(e[0], e[1], e[2], e[3]);
  }
}

constexpr int kRunTile = 32;    // K5: positions per block
constexpr int kRunUnroll = 2;   // K5: words each thread loads before it stores

// K5: one block per tile of kRunTile consecutive sorted positions; each
// position's row (`words` Words) read from its pillar's image row and
// written to its point's output row, `order`. Word is float4 (C % 4 == 0,
// aligned) or float.
template <typename Word>
__global__ void gather_scattered(const int* __restrict__ spids,
                                 const int* __restrict__ order,
                                 const Word* __restrict__ image,
                                 Word* __restrict__ out, long long positions, int n,
                                 int words, int rows) {
  __shared__ long long src[kRunTile];  // image word offset of each row, or -1
  __shared__ long long dst[kRunTile];  // output word offset of each row
  const long long p0 = static_cast<long long>(blockIdx.x) * kRunTile;
  const int count = static_cast<int>(min(static_cast<long long>(kRunTile), positions - p0));
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const long long p = p0 + k;
    const int id = spids[p];
    const long long frame = p / n;
    const bool live = static_cast<unsigned int>(id) < static_cast<unsigned int>(rows);
    src[k] = live ? (frame * rows + id) * words : -1;
    dst[k] = (frame * n + order[p]) * words;
  }
  __syncthreads();
  const int total = count * words;
  for (int base = threadIdx.x; base < total; base += kRunUnroll * blockDim.x) {
    Word v[kRunUnroll];
    long long at[kRunUnroll];
#pragma unroll
    for (int u = 0; u < kRunUnroll; ++u) {
      const int i = base + u * static_cast<int>(blockDim.x);
      at[u] = -1;
      v[u] = Word{};  // +0.0 in every float: the row of an id outside [0, rows)
      if (i < total) {
        const int k = i / words;
        const int w = i - k * words;
        const long long s = src[k];
        if (s >= 0) v[u] = image[s + w];
        at[u] = dst[k] + w;
      }
    }
#pragma unroll
    for (int u = 0; u < kRunUnroll; ++u) {
      if (at[u] >= 0) out[at[u]] = v[u];
    }
  }
}

// Launches gather_tile on the (B * N) positions of `ids`, with 32-bit index
// arithmetic when the output and the image have fewer than 2^31 floats.
template <bool kRound, bool kClamp>
int launch_tiles(const void* ids, const void* image, void* out, int batch, int n, int c,
                 int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long positions = static_cast<long long>(batch) * n;
  if (positions == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks = static_cast<unsigned int>((positions + kTile - 1) / kTile);
  const int* i = static_cast<const int*>(ids);
  const float* im = static_cast<const float*>(image);
  float* o = static_cast<float*>(out);
  const long long limit = 1LL << 31;
  if (positions * c < limit && static_cast<long long>(batch) * rows * c < limit) {
    gather_tile<int, kRound, kClamp><<<blocks, kThreads, 0, s>>>(
        i, im, o, static_cast<int>(positions), n, c, rows);
  } else {
    gather_tile<long long, kRound, kClamp><<<blocks, kThreads, 0, s>>>(
        i, im, o, positions, n, c, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: out[b, j] = image[b, clamp(ids[b, j], 0, rows - 1)]; rows >= 1.
extern "C" int himo_gather_rows_f32(const void* ids, const void* image, void* out,
                                    int batch, int n, int c, int rows, void* stream) {
  return launch_tiles<false, true>(ids, image, out, batch, n, c, rows, stream);
}

// K11: out[b, j] = image[b, spids[b, j]] (0 for ids >= rows), each image value
// rounded to bf16 on load when round_bf16 != 0.
extern "C" int himo_sorted_segment_gather_f32(const void* spids, const void* image,
                                              void* out, int batch, int n, int c,
                                              int rows, int round_bf16,
                                              void* stream) {
  return round_bf16
             ? launch_tiles<true, false>(spids, image, out, batch, n, c, rows, stream)
             : launch_tiles<false, false>(spids, image, out, batch, n, c, rows, stream);
}

// K5: out[b, order[b, j]] = image[b, spids[b, j]] (0 for ids >= rows).
extern "C" int himo_sorted_gather_rows_f32(const void* spids, const void* order,
                                           const void* image, void* out, int batch,
                                           int n, int c, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long positions = static_cast<long long>(batch) * n;
  if (positions == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks = static_cast<unsigned int>((positions + kRunTile - 1) / kRunTile);
  const int* i = static_cast<const int*>(spids);
  const int* o = static_cast<const int*>(order);
  // 16-byte words when C % 4 == 0 and both pointers are 16-byte aligned.
  if (c % 4 == 0 && reinterpret_cast<uintptr_t>(image) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    gather_scattered<float4><<<blocks, kThreads, 0, s>>>(
        i, o, static_cast<const float4*>(image), static_cast<float4*>(out), positions, n,
        c / 4, rows);
  } else {
    gather_scattered<float><<<blocks, kThreads, 0, s>>>(
        i, o, static_cast<const float*>(image), static_cast<float*>(out), positions, n, c,
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}
