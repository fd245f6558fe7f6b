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
// Hopper's blocks run in no order, so here the column mins meet in device
// memory through atomics.
//
// The distance is sum((q - r)^2) computed directly in IEEE fp32 on the CUDA
// cores (3 subtracts, 1 multiply, 2 FMAs; no tensor cores, no TF32), as in
// csrc/nn.cu, so it is not the reference's rounding: the two agree within a
// few ulps of |q|^2 + |r|^2, and a near-tie may resolve to another index.
//
// What bounds it: the fp32 instruction rate of the CUDA cores. Every pair needs
// the distance (6 instructions), four penalty adds and four mins.
//
// Design on the H100: one pass, each distance computed once.
// - A block holds kBlockQueries queries in registers, kQueries consecutive
//   ones per thread, and streams one segment of the references through
//   shared memory (x, y, z, ra as a float4, rd beside it); grid.y splits
//   the references into segments so that a train step's 8 x 16,384 x
//   16,384 call runs 512 blocks; frames on grid.z.
// - Row mins: each thread folds `d + ra`, `d + rd` with `fminf` (min-only);
//   every kRowChunk references it records the chunk in which its running
//   min last fell (strictly).
// - Column mins: per chunk of 8 references, each thread folds its own
//   queries' `d + qa`, `d + qd`, then the warp reduces and scatters them
//   with shuffles (the 8 references end in 8 lane groups), and after each
//   tile one thread per reference merges the warps' mins in shared memory,
//   the lowest warp winning ties.
// - Across blocks every min meets in a 64-bit key, the value's bits in an
//   order-preserving form above a group number, merged with `atomicMin`
//   into scratch that the launch fills with 0xFF: the lowest value wins,
//   and among equal values the lowest group, whatever order the blocks run
//   in. A row's group is its chunk of kRowChunk references, a column's the
//   warp's range of 32 x kQueries queries, both in index order.
// - A second kernel decodes each key and, in the tracking variant, walks
//   the winning group again for the first index at that value, one warp
//   per output and one index per lane: the same arithmetic, so the test is
//   exact, at most kRowChunk or 32 x kQueries pairs per output. Outputs
//   therefore equal a first-min walk over every index.
// At the train step's shape that is 2.1 M 64-bit atomics on each side and
// about 16 instructions per pair. `nvcc -Xptxas -v` for sm_90a: the
// main kernel 127 registers with indices, 99 without, 21,504 bytes of
// shared memory; the second kernel 32; no spills. Tuned on the H100 among
// 4 or 8 queries per thread, 4 or 8 warps per block and 256 to 1,024
// blocks (scripts/torch_nn_ab.py).
//
// Inputs: q (B, N, 3), r (B, M, 3), qa, qd (B, N), ra, rd (B, M) fp32,
// contiguous; outputs dq_a, dq_d (B, N), dr_a, dr_d (B, M) fp32 and, with
// indices, iq_a, iq_d (B, N), ir_a, ir_d (B, M) int32; scratch
// B * (2N + 2M) uint64. The Python wrapper checks and allocates them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = 8;    // consecutive queries per thread, in registers
constexpr int kGroup = 32 * kQueries;  // a warp's queries: a column's group
constexpr int kBlockQueries = kWarps * kGroup;
constexpr int kTile = kThreads;  // references per shared tile, one per thread
constexpr int kColChunk = 8;     // references per column shuffle reduction
constexpr int kRowChunk = 32;    // references per recorded row chunk
constexpr int kTargetBlocks = 512;  // blocks the segment split aims at
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float rx,
                                         float ry, float rz) {
  const float dx = qx - rx;
  const float dy = qy - ry;
  const float dz = qz - rz;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

// Float bits as an unsigned key in value order (negatives included).
__device__ __forceinline__ unsigned order_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void merge_key(unsigned long long* at, float v,
                                          unsigned group) {
  atomicMin(at, (static_cast<unsigned long long>(order_bits(v)) << 32) | group);
}

// The warp's min of v[j] for each of 8 references: reference (lane >> 2)'s
// ends in every lane of that group of 4. Halving stages swap the half a
// lane gives away, then two stages finish within the group.
__device__ __forceinline__ float scatter_min8(const float (&v)[kColChunk],
                                              int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float w[4], u[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = fminf(h4 ? v[i + 4] : v[i],
                 __shfl_xor_sync(kFull, h4 ? v[i] : v[i + 4], 16));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    u[i] = fminf(h3 ? w[i + 2] : w[i],
                 __shfl_xor_sync(kFull, h3 ? w[i] : w[i + 2], 8));
  float s = fminf(h2 ? u[1] : u[0], __shfl_xor_sync(kFull, h2 ? u[0] : u[1], 4));
  s = fminf(s, __shfl_xor_sync(kFull, s, 2));
  return fminf(s, __shfl_xor_sync(kFull, s, 1));
}

template <bool kWithIndex>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ q, const float* __restrict__ r,
             const float* __restrict__ qa, const float* __restrict__ qd,
             const float* __restrict__ ra, const float* __restrict__ rd,
             unsigned long long* __restrict__ keys, int n, int m, int seg) {
  __shared__ float4 tile[kTile];
  __shared__ float tile_rd[kTile];
  __shared__ float col[2][kWarps][kTile];
  const int b = blockIdx.z, batch = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int begin = blockIdx.y * seg;
  const int end = min(m, begin + seg);
  const long long bn = static_cast<long long>(b) * n, bm = static_cast<long long>(b) * m;
  const float* rb = r + 3 * bm;
  unsigned long long* row_keys = keys + bn;
  unsigned long long* col_keys = keys + 2LL * batch * n + bm;
  const long long side_n = static_cast<long long>(batch) * n;
  const long long side_m = static_cast<long long>(batch) * m;

  const int i0 = blockIdx.x * kBlockQueries + threadIdx.x * kQueries;
  float qx[kQueries], qy[kQueries], qz[kQueries], pa[kQueries], pd[kQueries];
  float ba[kQueries], bd[kQueries], rec_a[kQueries], rec_d[kQueries];
  int ch_a[kQueries], ch_d[kQueries];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = i0 + k;
    qx[k] = qy[k] = qz[k] = 0.0f;
    pa[k] = pd[k] = INFINITY;  // a query past the end never wins a column
    if (i < n) {
      qx[k] = q[3 * (bn + i)];
      qy[k] = q[3 * (bn + i) + 1];
      qz[k] = q[3 * (bn + i) + 2];
      pa[k] = qa[bn + i];
      pd[k] = qd[bn + i];
    }
    ba[k] = bd[k] = rec_a[k] = rec_d[k] = INFINITY;
    ch_a[k] = ch_d[k] = begin / kRowChunk;
  }

  for (int base = begin; base < end; base += kTile) {
    const int count = min(kTile, end - base);
    __syncthreads();
    {
      // Past the segment's end the tile holds +inf points, whose values
      // never lower a min; chunks are then folded whole.
      const int t = threadIdx.x;
      float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
      float prd = 0.0f;
      if (t < count) {
        const float* s = rb + 3LL * (base + t);
        p = make_float4(s[0], s[1], s[2], ra[bm + base + t]);
        prd = rd[bm + base + t];
      }
      tile[t] = p;
      tile_rd[t] = prd;
    }
    __syncthreads();
    const int chunks = (count + kRowChunk - 1) / kRowChunk * (kRowChunk / kColChunk);
    for (int cc = 0; cc < chunks; ++cc) {
      float ca[kColChunk], cd[kColChunk];
#pragma unroll
      for (int j = 0; j < kColChunk; ++j) {
        const float4 p = tile[cc * kColChunk + j];
        const float prd = tile_rd[cc * kColChunk + j];
#pragma unroll
        for (int k = 0; k < kQueries; ++k) {
          const float d = sq_dist(qx[k], qy[k], qz[k], p.x, p.y, p.z);
          ba[k] = fminf(ba[k], d + p.w);
          bd[k] = fminf(bd[k], d + prd);
          const float va = d + pa[k], vd = d + pd[k];
          ca[j] = k == 0 ? va : fminf(ca[j], va);
          cd[j] = k == 0 ? vd : fminf(cd[j], vd);
        }
      }
      const float sa = scatter_min8(ca, lane);
      const float sd = scatter_min8(cd, lane);
      if ((lane & 3) == 0) {
        col[0][warp][cc * kColChunk + (lane >> 2)] = sa;
        col[1][warp][cc * kColChunk + (lane >> 2)] = sd;
      }
      if (kWithIndex && cc % (kRowChunk / kColChunk) == kRowChunk / kColChunk - 1) {
        const int chunk = (base + (cc + 1) * kColChunk - kRowChunk) / kRowChunk;
#pragma unroll
        for (int k = 0; k < kQueries; ++k) {
          if (ba[k] < rec_a[k]) {
            rec_a[k] = ba[k];
            ch_a[k] = chunk;
          }
          if (bd[k] < rec_d[k]) {
            rec_d[k] = bd[k];
            ch_d[k] = chunk;
          }
        }
      }
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < count) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float v = col[s][0][t];
        int w = 0;
        for (int x = 1; x < kWarps; ++x) {
          if (col[s][x][t] < v) {
            v = col[s][x][t];
            w = x;
          }
        }
        merge_key(col_keys + s * side_m + base + t, v,
                  kWithIndex ? blockIdx.x * kWarps + w : 0u);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = i0 + k;
    if (i >= n || begin >= end) continue;
    merge_key(row_keys + i, kWithIndex ? rec_a[k] : ba[k], kWithIndex ? ch_a[k] : 0u);
    merge_key(row_keys + side_n + i, kWithIndex ? rec_d[k] : bd[k],
              kWithIndex ? ch_d[k] : 0u);
  }
}

struct Outs {
  float* v[4];  // dq_a, dq_d, dr_a, dr_d
  int* i[4];    // their indices (tracking variant)
};

// Decode each output's key. Without indices one thread per output; with
// them one warp, which walks the winning group again, one index per lane
// in order, and takes the first index at the key's value from a ballot.
template <bool kWithIndex>
__global__ void __launch_bounds__(256)
finalize_kernel(const float* __restrict__ q, const float* __restrict__ r,
                const float* __restrict__ qa, const float* __restrict__ qd,
                const float* __restrict__ ra, const float* __restrict__ rd,
                const unsigned long long* __restrict__ keys, Outs outs,
                int batch, int n, int m) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long g = kWithIndex ? tid >> 5 : tid;
  const int lane = threadIdx.x & 31;
  const long long side_n = static_cast<long long>(batch) * n;
  const long long side_m = static_cast<long long>(batch) * m;
  if (g >= 2 * (side_n + side_m)) return;
  const unsigned long long key = keys[g];
  const float v = from_order_bits(static_cast<unsigned>(key >> 32));
  const int group = static_cast<int>(key & 0xffffffffu);
  const bool row = g < 2 * side_n;
  const int s = row ? static_cast<int>(g / side_n) : static_cast<int>((g - 2 * side_n) / side_m);
  const long long e = row ? g - s * side_n : g - 2 * side_n - s * side_m;  // b * len + i
  // Selects, not a computed index into `outs`, which would put it on the stack.
  const int o = row ? s : 2 + s;
  if (!kWithIndex) {
    (o == 0 ? outs.v[0] : o == 1 ? outs.v[1] : o == 2 ? outs.v[2] : outs.v[3])[e] = v;
    return;
  }
  // The point whose min this is, the other cloud, and that cloud's penalties.
  const long long b = row ? e / n : e / m;
  const float* self = (row ? q : r) + 3 * e;
  const float* other = row ? r + 3 * b * m : q + 3 * b * n;
  const float* pen = row ? (s == 0 ? ra : rd) + b * m : (s == 0 ? qa : qd) + b * n;
  const int size = row ? kRowChunk : kGroup;
  const int lo = group * size, hi = min(lo + size, row ? m : n);
  int found = lo;
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < hi) {
      const float* p = other + 3LL * j;
      // The main kernel's operand order: query minus reference.
      const float d = row ? sq_dist(self[0], self[1], self[2], p[0], p[1], p[2])
                          : sq_dist(p[0], p[1], p[2], self[0], self[1], self[2]);
      hit = d + pen[j] == v;
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (ballot) {
      found = base + __ffs(ballot) - 1;
      break;
    }
  }
  if (lane == 0) {
    (o == 0 ? outs.v[0] : o == 1 ? outs.v[1] : o == 2 ? outs.v[2] : outs.v[3])[e] = v;
    (o == 0 ? outs.i[0] : o == 1 ? outs.i[1] : o == 2 ? outs.i[2] : outs.i[3])[e] = found;
  }
}

template <bool kWithIndex>
int launch(const void* q, const void* r, const void* qa, const void* qd,
           const void* ra, const void* rd, Outs outs, void* scratch, int batch,
           int n, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = 2LL * batch * (static_cast<long long>(n) + m);
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, total * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Segments of the references: the most, in powers of two, that keep the
  // grid within kTargetBlocks and each segment at least one tile.
  const int qblocks = (n + kBlockQueries - 1) / kBlockQueries;
  int split = 1;
  while (2LL * split * qblocks * batch <= kTargetBlocks && 2LL * split * kTile <= m) split *= 2;
  const int per = (m + split - 1) / split;
  const int seg = (per + kRowChunk - 1) / kRowChunk * kRowChunk;
  const float* fq = static_cast<const float*>(q);
  const float* fr = static_cast<const float*>(r);
  const float* fqa = static_cast<const float*>(qa);
  const float* fqd = static_cast<const float*>(qd);
  const float* fra = static_cast<const float*>(ra);
  const float* frd = static_cast<const float*>(rd);
  auto* keys = static_cast<unsigned long long*>(scratch);
  fused_kernel<kWithIndex><<<dim3(qblocks, split, batch), kThreads, 0, st>>>(
      fq, fr, fqa, fqd, fra, frd, keys, n, m, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = kWithIndex ? 32 * total : total;
  finalize_kernel<kWithIndex><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      fq, fr, fqa, fqd, fra, frd, keys, outs, batch, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int himo_fused_nn_f32(const void* q, const void* r, const void* qa,
                                 const void* qd, const void* ra,
                                 const void* rd, void* dq_a, void* dq_d,
                                 void* dr_a, void* dr_d, void* scratch,
                                 int batch, int n, int m, void* stream) {
  Outs outs = {{static_cast<float*>(dq_a), static_cast<float*>(dq_d),
                static_cast<float*>(dr_a), static_cast<float*>(dr_d)},
               {nullptr, nullptr, nullptr, nullptr}};
  return launch<false>(q, r, qa, qd, ra, rd, outs, scratch, batch, n, m, stream);
}

extern "C" int himo_fused_nn_idx_f32(const void* q, const void* r,
                                     const void* qa, const void* qd,
                                     const void* ra, const void* rd,
                                     void* dq_a, void* dq_d, void* dr_a,
                                     void* dr_d, void* iq_a, void* iq_d,
                                     void* ir_a, void* ir_d, void* scratch,
                                     int batch, int n, int m, void* stream) {
  Outs outs = {{static_cast<float*>(dq_a), static_cast<float*>(dq_d),
                static_cast<float*>(dr_a), static_cast<float*>(dr_d)},
               {static_cast<int*>(iq_a), static_cast<int*>(iq_d),
                static_cast<int*>(ir_a), static_cast<int*>(ir_d)}};
  return launch<true>(q, r, qa, qd, ra, rd, outs, scratch, batch, n, m, stream);
}
