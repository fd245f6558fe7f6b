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
// What bounds it: fp32 instruction throughput on the CUDA cores. A pair
// costs at least the distance (3 subtracts, 1 multiply, 2 FMAs) and a
// compare with the query's running k-th value; what it costs beyond that is
// the inserts, which a warp runs whenever one of its lanes has one. The
// design is nn.cu's K7 layout, with a k-slot list in place of K7's min:
// - each thread keeps kQueries<K> queries in registers, so one 16-byte
//   broadcast load of a reference from shared memory feeds that many
//   distances, and a block holds 32 x kQueries queries;
// - the block's kWarps warps split the reference walk into contiguous
//   segments, one per warp, each staged through the warp's own tile of
//   kTile references (tails padded with +inf points: their distance is +inf,
//   never below a limit, which is at most the empty value 3.0e38);
// - the hot loop is the distance and one `fminf` per pair, and once per
//   kStep<K> references one compare of their min with the query's insert
//   limit; only a step that holds a distance below it goes on, and then
//   inserts just those distances (a loop over the set bits of a mask, so
//   no insert runs predicated off). An insert is two `fminf`/`fmaxf` and
//   one compare per slot of the sorted list; a value already held is not
//   inserted (the collapse rule);
// - every warp starts its segment with an empty list, and the inserts a
//   list takes fall off as it fills, so a segment costs about k ln(n / k)
//   of them: split eight ways, the warps would insert several times what
//   one walk does. So every kExchange references each warp offers its
//   queries' k-th values to the block (shared memory, no barrier) and
//   takes the lowest one there as its limit. That is exact: a warp that
//   holds k distinct values at or below the limit shows that no larger
//   distance is among the k smallest distinct ones, and a distance equal to
//   it is held there already (a stale read only gives a higher limit);
// - distances equal to a list's first value are not inserted either (held
//   already): a masked query at SENTINEL sits on every masked reference;
// - after the walk each warp's per-query lists meet in shared memory
//   (reusing the tiles' space) and one thread per query merges them into
//   the k smallest distinct values, in ascending order of each list with
//   the same insert.
// The k smallest distinct values of a set of floats do not depend on the
// order of the walk, on how it is split or on which values a limit kept
// out, and each distance keeps the expression `fmaf(dz, dz, fmaf(dy, dy,
// dx * dx))`, so the output is bitwise that of the one-thread-per-query
// kernel this replaced, on every input.
//
// `nvcc -Xptxas -v` for sm_90a, registers per thread (no spills), k = 1..16:
// see PERF.md, from chip_smoke.py's build phase.
//
// Inputs: q (B, N, 3) fp32, r (B, M, 3) fp32, contiguous; output (B, N, k)
// fp32. The Python wrapper checks them and k.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;       // reference segments per block, one per warp
constexpr int kTile = 128;      // references per warp's shared tile (2 KiB)
constexpr int kExchange = 32;   // references between insert-limit exchanges
constexpr float kEmpty = 3.0e38f;  // the reference's _INF

// Per list length, tuned on the H100 (PERF.md): queries per thread, in
// registers, and references per compare with the insert limit. Short lists
// insert cheaply, so a long step wins; at k = 3..4 a short one keeps a cloud
// whose every reference enters the lists (a long insert chain per step)
// within 64 registers; long lists take one query per thread and long steps.
template <int K>
constexpr int kQueries = K <= 8 ? 4 : 1;
template <int K>
constexpr int kStep = K <= 2 ? 16 : (K <= 4 ? 4 : (K <= 8 ? 8 : 32));

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 p) {
  const float dx = qx - p.x;
  const float dy = qy - p.y;
  const float dz = qz - p.z;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

// Insert d into the ascending list best[0..K) of distinct values (its tail
// may repeat the empty value) unless it equals a held value. A held value
// turns d into +inf, and that, like any d at or above best[K - 1], leaves
// the list as it is. Every index is a compile-time constant after
// unrolling.
template <int K>
__device__ __forceinline__ void insert_distinct(float (&best)[K], float d) {
  bool held = false;
#pragma unroll
  for (int j = 0; j < K; ++j) held |= (best[j] == d);
  const float v = held ? INFINITY : d;
#pragma unroll
  for (int j = K - 1; j > 0; --j) best[j] = fminf(best[j], fmaxf(best[j - 1], v));
  best[0] = fminf(best[0], v);
}

// Fold the references [from, to) into the lists best[k] of the thread's
// kQ queries, staged kTile at a time through the warp's shared tile (the
// tail padded with +inf points). lim[k] is the query's insert limit: its
// own k-th value or a lower one that another warp's list holds, read from
// and offered to `limits` every kExchange references.
template <int K, int kQ>
__device__ __forceinline__ void walk(float4* tile, volatile float* limits,
                                     const float* __restrict__ rb, int from, int to,
                                     int lane, const float (&qx)[kQ],
                                     const float (&qy)[kQ], const float (&qz)[kQ],
                                     float (&best)[kQ][K], float (&lim)[kQ]) {
  constexpr int kS = kStep<K>;
  static_assert(kTile % kExchange == 0 && kExchange % kS == 0, "steps fill tiles");
  for (int base = from; base < to; base += kTile) {
    const int count = min(kTile, to - base);
    __syncwarp();
    for (int t = lane; t < kTile; t += 32) {
      float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
      if (t < count) {
        const float* s = rb + 3LL * (base + t);
        p = make_float4(s[0], s[1], s[2], 0.0f);
      }
      tile[t] = p;
    }
    __syncwarp();
    for (int t0 = 0; t0 < count; t0 += kExchange) {
      const int stop = min(count, t0 + kExchange);
      for (int t = t0; t < stop; t += kS) {
        float4 p[kS];
#pragma unroll
        for (int u = 0; u < kS; ++u) p[u] = tile[t + u];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          float d[kS];
#pragma unroll
          for (int u = 0; u < kS; ++u) d[u] = sq_dist(qx[k], qy[k], qz[k], p[u]);
          float low = d[0];
#pragma unroll
          for (int u = 1; u < kS; ++u) low = fminf(low, d[u]);
          if (low < lim[k]) {
            // The step's distances below the limit, one insert each (a loop
            // over set bits, so no insert runs predicated off), but not
            // those equal to the list's first value: a query sitting on
            // many copies of one point (the masked points of a cloud at
            // SENTINEL) meets that value again and again.
            unsigned int hits = 0;
#pragma unroll
            for (int u = 0; u < kS; ++u)
              hits |= d[u] < lim[k] && d[u] != best[k][0] ? 1u << u : 0u;
            while (hits) {
              const int u = __ffs(hits) - 1;
              hits &= hits - 1;
              insert_distinct<K>(best[k], sq_dist(qx[k], qy[k], qz[k], tile[t + u]));
              lim[k] = fminf(lim[k], best[k][K - 1]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float mine = best[k][K - 1];
        const float other = limits[32 * k + lane];
        if (mine < other) limits[32 * k + lane] = mine;
        lim[k] = fminf(lim[k], other);
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
knn_kernel(const float* __restrict__ q, const float* __restrict__ r,
           float* __restrict__ out, int n, int m, int seg) {
  constexpr int kQ = kQueries<K>;
  constexpr int kBlockQueries = 32 * kQ;
  extern __shared__ float4 smem[];
  __shared__ float limits[kBlockQueries];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBlockQueries;
  const float* qb = q + static_cast<long long>(b) * n * 3;
  const float* rb = r + static_cast<long long>(b) * m * 3;
  float4* tile = smem + warp * kTile;
  float qx[kQ], qy[kQ], qz[kQ];
  float best[kQ][K], lim[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + 32 * k + lane;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (i < n) {
      qx[k] = qb[3 * i];
      qy[k] = qb[3 * i + 1];
      qz[k] = qb[3 * i + 2];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) best[k][j] = kEmpty;
    lim[k] = kEmpty;
  }
  for (int t = threadIdx.x; t < kBlockQueries; t += kWarps * 32) limits[t] = kEmpty;
  __syncthreads();
  const int begin = min(m, warp * seg);
  walk<K, kQ>(tile, limits, rb, begin, min(m, begin + seg), lane, qx, qy, qz, best, lim);
  __syncthreads();  // every tile is walked: the lists take their space
  float* part = reinterpret_cast<float*>(smem);  // [K][kWarps][kBlockQueries]
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      part[(j * kWarps + warp) * kBlockQueries + 32 * k + lane] = best[k][j];
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int i = q0 + t;
  if (t >= kBlockQueries || i >= n) return;
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = part[j * kWarps * kBlockQueries + t];
  for (int w = 1; w < kWarps; ++w) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = part[(j * kWarps + w) * kBlockQueries + t];
      if (d < acc[K - 1]) insert_distinct<K>(acc, d);
    }
  }
  float* o = out + (static_cast<long long>(b) * n + i) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = acc[j];
}

template <int K>
int launch(const void* q, const void* r, void* out, int batch, int n, int m,
           cudaStream_t stream) {
  constexpr int kBlockQueries = 32 * kQueries<K>;
  constexpr size_t tiles = sizeof(float4) * kWarps * kTile;
  constexpr size_t lists = sizeof(float) * K * kWarps * kBlockQueries;
  constexpr size_t bytes = tiles > lists ? tiles : lists;
  static_assert(bytes <= 48 * 1024, "tiles and lists fit without a shared-memory opt-in");
  const int seg = (m + kWarps - 1) / kWarps;
  const dim3 grid((n + kBlockQueries - 1) / kBlockQueries, batch);
  knn_kernel<K><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<float*>(out), n, m, seg);
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
