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
//   rows that no point reaches read +0.0, and so does a max of -inf (the
//   reference maps both to 0); ids outside [0, rows) are skipped; -0.0 comes
//   out as +0.0.
//
// Design on the H100: every cell of the image is written once, and after the
// scatter only the rows that points reached are touched again.
// - An order-preserving unsigned key whose zero means "empty": a float with
//   bits u maps to u ^ 0x80000000 when its sign is clear, ~u when it is set.
//   Every non-NaN float, -inf included, gets a key above 0, and the unsigned
//   order of the keys is the float order. All-zero bits are both the empty
//   key and the +0.0 an unreached row must read, so one cudaMemsetAsync of
//   the image on the caller's stream makes every unreached row final.
// - The scatter: one warp per point, lanes over channels (at C = 32 a point's
//   feature row is one coalesced 128-byte read, and its atomics hit one
//   128-byte image row), one unsigned atomicMax of the key per value, with
//   no sign branch. A plain load first skips the atomic when the stored key
//   is already at least as large: the key only grows, so a stale load can
//   only cause a redundant atomic, never a lost update. Lane 0 marks the
//   point's row in a byte table of B * rows flags (zeroed by a second
//   memset; 2 MB at 8 x 512x512), a plain store.
// - The decode: one warp per 32 consecutive rows of the flattened (B * rows)
//   image reads their 32 flags (one 32-byte load), compacts the flagged rows
//   by a ballot, and rewrites only those rows in place: key -> float, -inf
//   -> 0, then `__fadd_rn(v, 0.0f)` so that -0.0 comes out as +0.0. Lanes
//   walk the flagged rows' words, 16 bytes at a time when C is a multiple of
//   4 (each row is then 16-byte aligned), else 4.
// - Without a flag table (`reached` null) the decode reads every word of the
//   image and writes back those that hold a key: no flags, but the whole
//   image read once more. That wins below 8 channels, where a 32-byte
//   sector holds two rows or more and the flagged decode reaches most
//   sectors anyway (the dynamic-image loss's max, C = 1): the wrappers pass
//   no table there (PERF.md has both decodes' times).
// The earlier design filled the image with -inf and rewrote all of it after
// the scatter (-inf -> 0, -0.0 -> +0.0): two of its three passes covered the
// whole image, where the points reach 19.8 % of the 512x512 rows and 52.8 %
// of the 256x256 ones (PERF.md).
//
// What bounds it: the image written once (8 x 512x512 x 32 fp32 is 268 MB)
// and the random-address atomics on the 50 MB L2 (one frame's 512x512 image
// is 32 MiB, so rows spill to HBM; at 256x256 the 8 frames' images are
// 64 MiB). Max does not depend on order, so the result is bitwise the same
// as any other order of the same maxima. NaN inputs are outside the
// contract.
//
// Inputs: pids (B, N) int32, feats (B, N, C) fp32, out (B * rows, C) fp32
// and reached (B * rows) bytes or null, any contents (both zeroed here), all
// contiguous on one device. The Python wrapper checks them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// -inf's key. Only the empty key 0 and the keys of negative NaNs lie below.
constexpr unsigned int kNegInfKey = 0x007FFFFFu;

__device__ __forceinline__ unsigned int to_key(float v) {
  const unsigned int u = __float_as_uint(v);
  return u ^ (static_cast<unsigned int>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// A key back to the float it came from, as bits: empty and -inf read +0.0,
// -0.0 reads +0.0.
__device__ __forceinline__ unsigned int from_key(unsigned int key) {
  if (key <= kNegInfKey) return 0u;
  const unsigned int u =
      key ^ (static_cast<unsigned int>(static_cast<int>(~key) >> 31) | 0x80000000u);
  return __float_as_uint(__fadd_rn(__uint_as_float(u), 0.0f));
}

__device__ __forceinline__ bool decode(unsigned int& w) {
  const bool live = w != 0u;
  w = from_key(w);
  return live;
}

__device__ __forceinline__ bool decode(uint4& w) {
  const bool x = decode(w.x), y = decode(w.y), z = decode(w.z), v = decode(w.w);
  return x | y | z | v;
}

__global__ void scatter_max_rows(const int* __restrict__ pids,
                                 const float* __restrict__ feats,
                                 unsigned int* __restrict__ keys,
                                 unsigned char* __restrict__ reached,
                                 long long points, int n, int c, int rows) {
  const long long warp =
      (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= points) return;
  const int pid = pids[warp];
  if (static_cast<unsigned int>(pid) >= static_cast<unsigned int>(rows)) return;
  const long long row = warp / n * rows + pid;
  if (reached != nullptr && lane == 0) reached[row] = 1;
  const float* src = feats + warp * c;
  unsigned int* dst = keys + row * c;
  for (int ch = lane; ch < c; ch += 32) {
    const unsigned int key = to_key(src[ch]);
    if (__ldcg(dst + ch) < key) atomicMax(dst + ch, key);
  }
}

// One warp per 32 rows; Word is uint4 (C a multiple of 4, `words` = C / 4)
// or unsigned int (`words` = C).
template <typename Word>
__global__ void decode_reached(const unsigned char* __restrict__ reached,
                               Word* __restrict__ image, long long total_rows,
                               int words) {
  __shared__ int slot[kThreads];  // each warp's flagged rows, compacted
  const long long first =
      ((blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5) * 32;
  const int lane = threadIdx.x & 31;
  if (first >= total_rows) return;  // the whole warp
  const bool hit = first + lane < total_rows && reached[first + lane];
  const unsigned int mask = __ballot_sync(0xffffffffu, hit);
  int* flagged = slot + (threadIdx.x & ~31);
  if (hit) flagged[__popc(mask & ((1u << lane) - 1))] = lane;
  __syncwarp();
  const int count = __popc(mask) * words;
  for (int i = lane; i < count; i += 32) {
    const int k = i / words;
    Word* w = image + (first + flagged[k]) * words + (i - k * words);
    Word v = *w;
    decode(v);
    *w = v;
  }
}

// The flag-free decode: every word read, those holding a key written back.
template <typename Word>
__global__ void decode_all(Word* __restrict__ image, long long words) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (; i < words; i += stride) {
    Word v = image[i];
    if (decode(v)) image[i] = v;
  }
}

unsigned int grid_for(long long count) {
  const long long blocks = (count + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // a few waves over 132 SMs; loops stride
  return static_cast<unsigned int>(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" int himo_scatter_max_f32(const void* pids, const void* feats, void* out,
                                    void* reached, int batch, int n, int c, int rows,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total_rows = static_cast<long long>(batch) * rows;
  const long long cells = total_rows * c;
  const long long points = static_cast<long long>(batch) * n;
  if (cells == 0) return static_cast<int>(cudaGetLastError());
  unsigned char* flags = static_cast<unsigned char*>(reached);
  cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(float), s);
  if (err == cudaSuccess && flags != nullptr) err = cudaMemsetAsync(flags, 0, total_rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (points == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (points * 32 + kThreads - 1) / kThreads;
  scatter_max_rows<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(pids), static_cast<const float*>(feats),
      static_cast<unsigned int*>(out), flags, points, n, c, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (flags == nullptr) {
    if (cells % 4 == 0) {
      decode_all<uint4><<<grid_for(cells / 4), kThreads, 0, s>>>(static_cast<uint4*>(out),
                                                                 cells / 4);
    } else {
      decode_all<unsigned int><<<grid_for(cells), kThreads, 0, s>>>(
          static_cast<unsigned int*>(out), cells);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned int decode_blocks =
      static_cast<unsigned int>((total_rows + kThreads - 1) / kThreads);
  if (c % 4 == 0) {
    decode_reached<uint4><<<decode_blocks, kThreads, 0, s>>>(
        flags, static_cast<uint4*>(out), total_rows, c / 4);
  } else {
    decode_reached<unsigned int><<<decode_blocks, kThreads, 0, s>>>(
        flags, static_cast<unsigned int*>(out), total_rows, c);
  }
  return static_cast<int>(cudaGetLastError());
}
