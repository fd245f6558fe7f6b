// The BEV correlation of SeFlow++'s correlation stage: average pooling of two
// channels-last (B, H, W, C) feature images and the local cost volume
//
//   corr[b, k, y, x] = <P0(y, x), P1(y + dy - r, x + dx - r)> / C,
//   k = dy * (2r + 1) + dx,  P = the image mean-pooled over s x s cells,
//
// with P1 read as 0 past the border, and its backward.
//
// Source note: this replaces no TPU kernel. The JAX package computes the
// volume as a `lax.map` over the window's offsets
// (himo_tpu/models/feedforward.py `_bev_correlation`, after `_avg_pool`), and
// the port's plain form (`ops.correlation._bev_correlation`) as a loop of a
// `mul`, a channel `sum` and a `div` per offset: 130 offsets, ~400 launches,
// each writing and re-reading a full (B, C, h, w) product. Here:
//
// - `pool_images`: one pass over both images pools them at every level's
//   stride (a block takes an smax-row band of 64 columns and pools each level
//   inside it, the coarser level's reads hitting cache), so each input byte
//   is read from device memory once;
// - `corr_forward`: per level, one pass over the pooled images writes every
//   offset's channel;
// - `corr_backward`: per level, one gather over the window gives both pooled
//   images' gradients; the finest level spreads them, with the other
//   level's, over the s x s cells of the image gradients.
//
// Bound (B8, C32, 512^2 bf16 pooled to 256^2 r = 4 and to 64^2 r = 3): read
// the two images once (2 x 134.2 MB) and write the two volumes once
// ((8, 81, 256, 256) and (8, 49, 64, 64), 88.1 MB): ~356 MB, ~0.11 ms at
// 3.35 TB/s; 2.7 GFLOP of products at the fine level. The pooled images
// (2 x 33.5 MB at the fine level) are written once and read back by the
// volume's tiles with their halo, which hits L2. The backward's bound is
// similar: the volumes' gradients and the pooled images read once, two image
// gradients written once.
//
// Tiling: `corr_forward` gives a block a tile of 32 x TH output pixels of one
// frame (a warp is one row, so each offset's store is 64 contiguous bytes),
// stages P1's tile plus an r-pixel halo (zeros past the border) in shared
// memory as planes of 16-byte chunks (a pixel's channels 8j..8j+7 in bf16),
// so that a warp's reads of one offset are 32 consecutive chunks, and keeps
// the thread's own P0 pixel in registers. Each thread then walks the
// window's offsets, each a C-term dot product against shared memory.
// `corr_backward` takes the same tiles in two passes: P1's tile with its halo
// staged the same way for dP0, then P0's in the same shared memory for dP1,
// so that each pass holds C fp32 accumulators a thread; the volume's
// gradient is read straight from device memory, g_k(p) in the first pass and
// g_k(p - d_k) in the second, both coalesced along a warp's row.
//
// Arithmetic of the forward, so that the bf16 volume equals the plain form
// on the card bit for bit (the plain form's kernels are PyTorch's; the
// orders below are those of torch 2.11's ATen/native/cuda/Reduce.cuh at the
// shapes where `ops.correlation.torch_order` finds them; at other shapes the
// same kernels add in this order, within a few ulps of the plain form):
// - pool: PyTorch's `mean` over the (s, s) cell of a channels-last image is
//   a reduction along the image's fastest reduced stride: `lanes` threads
//   share an output (lane l sums cell elements l, l + lanes, ... into four
//   accumulators by element count mod 4, added in order), then a warp
//   shuffle tree with decreasing offsets; fp32 throughout, times the fp32
//   factor outputs / inputs, rounded once to the image's type. Here a thread
//   holds up to 4 of those lanes and takes the tree's first steps in
//   registers, the rest by shuffles among lanes / 4 threads (pool 2: one
//   thread a pooled chunk; pool 8: eight). Measured on the card (torch
//   2.11): this order matches its `mean` bit for bit where an increasing
//   shuffle tree or a sequential sum does not. Where torch's order is not
//   copied, the wrapper gives a lane each cell element up to 32 lanes, and
//   a lane sums its elements in turn;
// - each product rounded to the image's type (bf16: a bf16 x bf16 product
//   is exact in fp32, so one rounding, as `__hmul2` gives);
// - the channel sum: one thread a pixel, four fp32 accumulators by channel
//   mod 4 from +0, added in order ((a0 + a1) + a2) + a3, rounded to the
//   type, times 1 / C in fp32 (PyTorch divides by a CPU scalar as a multiply
//   by its reciprocal), rounded again.
// fp32 images take the same kernels with fp32 products (no fused
// multiply-add anywhere in the forward). A row holds C = 8..64 channels in
// steps of 8: the wrapper pads other counts with zero channels, and passes
// the C that divides apart from the row's.
//
// The backward accumulates in fp32 and rounds once to the image's type: the
// plain form's autograd rounds after each of its ~130 partial additions, so
// this is the same mathematics at higher precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;        // output pixels a block row; one warp
constexpr int kPoolThreads = 256;
constexpr int kPoolRegion = 64;   // image columns a pooling block takes, at least
constexpr int kPoolLeaves = 4;    // reduction lanes a pooling thread holds, at most
constexpr int kForwardRows = 16;  // tile rows of `corr_forward` (bf16; fp32 takes 8)
constexpr int kBackwardRows = 8;  // tile rows of `corr_backward`

// Values in one 16-byte chunk of a pixel's channels.
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { static constexpr int n = 8; };
template <> struct Chunk<float> { static constexpr int n = 4; };

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

template <typename T> __device__ __forceinline__ void to_floats(const uint4& q, float* v);
template <> __device__ __forceinline__ void to_floats<__nv_bfloat16>(const uint4& q, float* v) {
  v[0] = bf_lo(q.x); v[1] = bf_hi(q.x); v[2] = bf_lo(q.y); v[3] = bf_hi(q.y);
  v[4] = bf_lo(q.z); v[5] = bf_hi(q.z); v[6] = bf_lo(q.w); v[7] = bf_hi(q.w);
}
template <> __device__ __forceinline__ void to_floats<float>(const uint4& q, float* v) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Round to the type, round to nearest even.
template <typename T> __device__ __forceinline__ uint4 from_floats(const float* v);
template <> __device__ __forceinline__ uint4 from_floats<__nv_bfloat16>(const float* v) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}
template <> __device__ __forceinline__ uint4 from_floats<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

// One chunk's products added to the four channel-mod-4 accumulators, in
// channel order. A chunk starts at a channel that is a multiple of 4.
template <typename T> __device__ __forceinline__ void dot_chunk(const uint4& a, const uint4& b,
                                                                float* acc);
template <> __device__ __forceinline__ void dot_chunk<__nv_bfloat16>(const uint4& a,
                                                                     const uint4& b, float* acc) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]),
                                     *reinterpret_cast<const __nv_bfloat162*>(&bw[i]));
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);
    const int q = (i & 1) * 2;  // channels 8j + 2i, 8j + 2i + 1 -> accumulators q, q + 1
    acc[q] = __fadd_rn(acc[q], bf_lo(u));
    acc[q + 1] = __fadd_rn(acc[q + 1], bf_hi(u));
  }
}
template <> __device__ __forceinline__ void dot_chunk<float>(const uint4& a, const uint4& b,
                                                             float* acc) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(__uint_as_float(a.x), __uint_as_float(b.x)));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(__uint_as_float(a.y), __uint_as_float(b.y)));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(__uint_as_float(a.z), __uint_as_float(b.z)));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(__uint_as_float(a.w), __uint_as_float(b.w)));
}

// The channel sum (rounded to the type) times 1 / C, rounded to the type.
template <typename T> __device__ __forceinline__ T finish(float sum, float inv_c);
template <> __device__ __forceinline__ __nv_bfloat16 finish<__nv_bfloat16>(float sum,
                                                                           float inv_c) {
  const float s = __bfloat162float(__float2bfloat16_rn(sum));
  return __float2bfloat16_rn(__fmul_rn(s, inv_c));
}
template <> __device__ __forceinline__ float finish<float>(float sum, float inv_c) {
  return __fmul_rn(sum, inv_c);
}

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }

struct PoolLevel {
  void* p0;       // (B, H / s, W / s, C) pooled images
  void* p1;
  int s;          // stride
  int lanes;      // PyTorch's lanes for one output (a power of two, <= 32)
  float factor;   // outputs / inputs, as PyTorch's mean computes it
};

// PyTorch's partial sum of reduction lanes q, q + group, ..., q + group *
// (LEAVES - 1) of one pooled chunk, as its shuffle tree (decreasing offsets)
// leaves it in lane q once the offsets down to `group` are done: each lane's
// cell elements l, l + lanes, ... (at most 4, so its four accumulators hold
// one each) folded from +0, then the tree's halving steps in registers. The
// LEAVES loads of one step are independent, so they are in flight together.
template <typename T, int LEAVES>
__device__ __forceinline__ void pool_leaves(const T* src, int width, int c, int s, int group,
                                            int q, int py, int px, int j, bool live,
                                            float* out) {
  constexpr int V = Chunk<T>::n;
  const int lanes = group * LEAVES, ss = s * s;
  float a[LEAVES][V];
#pragma unroll
  for (int m = 0; m < LEAVES; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) a[m][e] = 0.0f;
  if (live) {
    for (int k = 0; q + k * lanes < ss; ++k) {
#pragma unroll
      for (int m = 0; m < LEAVES; ++m) {
        const int idx = q + group * m + k * lanes;
        if (idx < ss) {
          const int dy = idx / s, dx = idx - dy * s;
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              src + (static_cast<long long>(py * s + dy) * width + px * s + dx) * c) + j);
          float v[V];
          to_floats<T>(raw, v);
#pragma unroll
          for (int e = 0; e < V; ++e) a[m][e] = __fadd_rn(a[m][e], v[e]);
        }
      }
    }
  }
#pragma unroll
  for (int half = LEAVES / 2; half >= 1; half >>= 1)
#pragma unroll
    for (int m = 0; m < half; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e) a[m][e] = __fadd_rn(a[m][e], a[m + half][e]);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = a[0][e];
}

// Both images pooled at each level's stride. A block takes rows [y0, y0 +
// smax) and columns [x0, x0 + region) of one frame; for each level, a group
// of `lanes / leaves` threads (leaves = min(lanes, kPoolLeaves)) pools one 16-byte
// chunk of one pooled pixel in the order of PyTorch's reduction (see the top
// of the file): each thread its leaves in registers, then the last steps of
// the tree by warp shuffles.
template <typename T>
__global__ void __launch_bounds__(kPoolThreads, 4)
pool_images(const T* __restrict__ img0, const T* __restrict__ img1, long long img_bstride,
            int height, int width, int chunks, int smax, int region, PoolLevel la,
            PoolLevel lb, int nlevels) {
  constexpr int V = Chunk<T>::n;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * smax, x0 = blockIdx.x * region;
  const int tid = threadIdx.x;
  const int c = chunks * V;
  for (int li = 0; li < nlevels; ++li) {
    const PoolLevel L = li == 0 ? la : lb;
    const int s = L.s;
    const int leaves = L.lanes < kPoolLeaves ? L.lanes : kPoolLeaves, group = L.lanes / leaves;
    const int rows = smax / s, cols = region / s;
    const int h = height / s, w = width / s;
    const int units = 2 * rows * cols * chunks;
    const int q = tid % group;
    for (int ub = 0; ub < units; ub += kPoolThreads / group) {
      const int u = ub + tid / group;
      const int j = u % chunks;
      int rest = u / chunks;
      const int pc = rest % cols;
      rest /= cols;
      const int pr = rest % rows, im = rest / rows;
      const int px = x0 / s + pc, py = y0 / s + pr;
      const bool live = u < units && px < w;
      const T* src = (im ? img1 : img0) + b * img_bstride;
      float t[V];
      switch (leaves) {
        case 1: pool_leaves<T, 1>(src, width, c, s, group, q, py, px, j, live, t); break;
        case 2: pool_leaves<T, 2>(src, width, c, s, group, q, py, px, j, live, t); break;
        default: pool_leaves<T, kPoolLeaves>(src, width, c, s, group, q, py, px, j, live, t);
      }
      for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) t[e] = __fadd_rn(t[e], __shfl_down_sync(0xffffffffu, t[e], off));
      }
      if (live && q == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) t[e] = __fmul_rn(t[e], L.factor);
        T* dst = static_cast<T*>(im ? L.p1 : L.p0);
        reinterpret_cast<uint4*>(dst + ((static_cast<long long>(b) * h + py) * w + px) * c)[j] =
            from_floats<T>(t);
      }
    }
  }
}

// Shared-memory planes of a (rh, rw) region of 16-byte chunks: plane j holds
// chunk j of every pixel, so a warp's reads of one offset are 32 consecutive
// chunks. The pitch (in chunks) keeps the staging stores, a pixel's chunks
// by consecutive threads, on distinct banks.
__host__ __device__ __forceinline__ int plane_pitch(int npix, int chunks) {
  const int base = (npix + 7) & ~7;
  return base + ((chunks & (chunks - 1)) == 0 ? (8 / chunks) % 8 : 1);
}

// Stage a pooled (h, w) image's region rows [ry0, ry0 + rh) x cols
// [rx0, rx0 + rw) into `planes` (zeros past the border).
__device__ __forceinline__ void stage_region(const uint4* __restrict__ src, int h, int w,
                                             int chunks, int ry0, int rx0, int rh, int rw,
                                             uint4* planes, int pitch, int tid, int nthreads) {
  const int npix = rh * rw;
  for (int i = tid; i < npix * chunks; i += nthreads) {
    const int pix = i / chunks, j = i - pix * chunks;
    const int ry = pix / rw, rx = pix - ry * rw;
    const int gy = ry0 + ry, gx = rx0 + rx;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = __ldg(src + (static_cast<long long>(gy) * w + gx) * chunks + j);
    planes[j * pitch + pix] = v;
  }
}

// The volume of one level from its pooled images (B, h, w, C).
template <typename T, int NC8>
__global__ void __launch_bounds__(32 * kForwardRows)
corr_forward(const T* __restrict__ p0, const T* __restrict__ p1, T* __restrict__ out,
             int h, int w, int radius, float inv_c) {
  constexpr int V = Chunk<T>::n;
  constexpr int CH = NC8 * 8 / V;
  extern __shared__ uint4 smem[];
  const int win = 2 * radius + 1;
  const int tx = threadIdx.x, ty = threadIdx.y, th = blockDim.y;
  const int b = blockIdx.z, x0 = blockIdx.x * kTileW, y0 = blockIdx.y * th;
  const int rw = kTileW + 2 * radius, rh = th + 2 * radius;
  const int pitch = plane_pitch(rw * rh, CH);
  const long long frame = static_cast<long long>(b) * h * w;
  stage_region(reinterpret_cast<const uint4*>(p1) + frame * CH, h, w, CH, y0 - radius,
               x0 - radius, rh, rw, smem, pitch, ty * kTileW + tx, th * kTileW);
  const int y = y0 + ty, x = x0 + tx;
  const bool live = y < h && x < w;
  uint4 a[CH];
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(p0) + (frame + static_cast<long long>(y) * w + x) * CH;
#pragma unroll
    for (int j = 0; j < CH; ++j) a[j] = __ldg(src + j);
  }
  __syncthreads();
  if (!live) return;
  const long long plane = static_cast<long long>(h) * w;
  T* dst = out + static_cast<long long>(b) * win * win * plane + static_cast<long long>(y) * w + x;
  for (int dy = 0; dy < win; ++dy) {
    const uint4* row = smem + (ty + dy) * rw + tx;
#pragma unroll 3
    for (int dx = 0; dx < win; ++dx) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < CH; ++j) dot_chunk<T>(a[j], row[j * pitch + dx], acc);
      const float sum = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
      dst[(dy * win + dx) * plane] = finish<T>(sum, inv_c);
    }
  }
}

// One pooled image's gradient for this thread's pixel, times `scale`, written
// out: over the pixel's s x s cell of the (B, H, W, C) image gradient `d` (the
// type) plus the other level's fp32 (B, H / es, W / es, C) contribution `e`
// when given (spread), or as this level's fp32 (B, h, w, C) contribution.
template <typename T, int C>
__device__ __forceinline__ void write_grad(float (&acc)[C], float scale, int spread, void* d,
                                           const float* __restrict__ e, int es, int b, int y,
                                           int x, int h, int w, int s) {
  constexpr int V = Chunk<T>::n;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] *= scale;
  if (!spread) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(d) +
                                          ((static_cast<long long>(b) * h + y) * w + x) * C);
#pragma unroll
    for (int i = 0; i < C / 4; ++i)
      o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    return;
  }
  const int width = w * s, height = h * s;
  for (int iy = 0; iy < s; ++iy) {
    for (int ix = 0; ix < s; ++ix) {
      const int Y = y * s + iy, X = x * s + ix;
      uint4* o = reinterpret_cast<uint4*>(static_cast<T*>(d) +
                                          ((static_cast<long long>(b) * height + Y) * width + X) * C);
      const float4* ep = nullptr;
      if (e != nullptr) {
        const int ew = width / es, eh = height / es;
        ep = reinterpret_cast<const float4*>(
            e + ((static_cast<long long>(b) * eh + Y / es) * ew + X / es) * C);
      }
#pragma unroll
      for (int j = 0; j < C / V; ++j) {
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = acc[j * V + i];
        if (ep != nullptr) {
#pragma unroll
          for (int i = 0; i < V / 4; ++i) {
            const float4 f = __ldg(ep + j * (V / 4) + i);
            v[4 * i] += f.x; v[4 * i + 1] += f.y; v[4 * i + 2] += f.z; v[4 * i + 3] += f.w;
          }
        }
        o[j] = from_floats<T>(v);
      }
    }
  }
}

// One pass of the gather for this thread's pixel p over the staged region
// `row0` (the tile's origin at halo offset 0): without SHIFTED,
// sum_k g_k(p) R(p + d_k); with SHIFTED, sum_k g_k(p - d_k) R(p - d_k).
template <typename T, int C, bool SHIFTED>
__device__ __forceinline__ void gather(float (&acc)[C], const T* __restrict__ gb,
                                       const uint4* smem, int pitch, int rw, int tx, int ty,
                                       int y, int x, int h, int w, int radius) {
  constexpr int V = Chunk<T>::n;
  const int win = 2 * radius + 1;
  const long long plane = static_cast<long long>(h) * w;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int dy = 0; dy < win; ++dy) {
    const int gy = SHIFTED ? y + radius - dy : y;
    const bool row_in = gy >= 0 && gy < h;
    const uint4* row = SHIFTED ? smem + (ty + 2 * radius - dy) * rw + tx + 2 * radius
                               : smem + (ty + dy) * rw + tx;
    const T* grow = gb + dy * win * plane + static_cast<long long>(gy) * w;
#pragma unroll 3
    for (int dx = 0; dx < win; ++dx) {
      const int gx = SHIFTED ? x + radius - dx : x;
      const float gk = (!SHIFTED || (row_in && gx >= 0 && gx < w))
                           ? to_float<T>(grow[dx * plane + gx]) : 0.0f;
#pragma unroll
      for (int j = 0; j < C / V; ++j) {
        float v[V];
        to_floats<T>(row[j * pitch + (SHIFTED ? -dx : dx)], v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j * V + e] = fmaf(gk, v[e], acc[j * V + e]);
      }
    }
  }
}

// Gradients of one level's pooled images, times `scale` (1 / (C s^2)):
//   dP0(p) = sum_k g_k(p) P1(p + d_k),  dP1(p) = sum_k g_k(p - d_k) P0(p - d_k),
// in two passes over one shared-memory region: P1's tile with its halo for
// dP0, then P0's for dP1 (`write_grad` writes each).
template <typename T, int NC8>
__global__ void __launch_bounds__(32 * kBackwardRows, 3)
corr_backward(const T* __restrict__ g, long long g_bstride, const T* __restrict__ p0,
              const T* __restrict__ p1, const float* __restrict__ e0,
              const float* __restrict__ e1, int es, void* d0, void* d1, int h, int w,
              int radius, int s, float scale, int spread) {
  constexpr int V = Chunk<T>::n;
  constexpr int C = NC8 * 8;
  constexpr int CH = C / V;
  extern __shared__ uint4 smem[];
  const int tx = threadIdx.x, ty = threadIdx.y, th = blockDim.y;
  const int b = blockIdx.z, x0 = blockIdx.x * kTileW, y0 = blockIdx.y * th;
  const int rw = kTileW + 2 * radius, rh = th + 2 * radius;
  const int pitch = plane_pitch(rw * rh, CH);
  const long long frame = static_cast<long long>(b) * h * w;
  const T* gb = g + b * g_bstride;
  const int y = y0 + ty, x = x0 + tx;
  const bool live = y < h && x < w;
  float acc[C];
  stage_region(reinterpret_cast<const uint4*>(p1) + frame * CH, h, w, CH, y0 - radius,
               x0 - radius, rh, rw, smem, pitch, ty * kTileW + tx, th * kTileW);
  __syncthreads();
  if (live) {
    gather<T, C, false>(acc, gb, smem, pitch, rw, tx, ty, y, x, h, w, radius);
    write_grad<T, C>(acc, scale, spread, d0, e0, es, b, y, x, h, w, s);
  }
  __syncthreads();  // every read of P1's region done
  stage_region(reinterpret_cast<const uint4*>(p0) + frame * CH, h, w, CH, y0 - radius,
               x0 - radius, rh, rw, smem, pitch, ty * kTileW + tx, th * kTileW);
  __syncthreads();
  if (live) {
    gather<T, C, true>(acc, gb, smem, pitch, rw, tx, ty, y, x, h, w, radius);
    write_grad<T, C>(acc, scale, spread, d1, e1, es, b, y, x, h, w, s);
  }
}

int optin_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Tile rows: the largest of `first`, first / 2, ... whose staged region of
// `chunks` planes fits in shared memory; 0 when none does.
int tile_rows(int first, int radius, int chunks, int* smem_bytes) {
  const int limit = optin_smem();
  for (int th = first; th >= 1; th >>= 1) {
    const int npix = (th + 2 * radius) * (kTileW + 2 * radius);
    const int bytes = chunks * plane_pitch(npix, chunks) * 16;
    if (bytes <= limit) {
      *smem_bytes = bytes;
      return th;
    }
  }
  return 0;
}

template <typename T, int NC8>
int launch_forward(const void* p0, const void* p1, void* out, int batch, int h, int w,
                   int radius, float inv_c, cudaStream_t stream) {
  constexpr int CH = NC8 * 8 / Chunk<T>::n;
  int smem = 0;
  const int th = tile_rows(sizeof(T) == 2 ? kForwardRows : kForwardRows / 2, radius, CH, &smem);
  if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = corr_forward<T, NC8>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + th - 1) / th, batch);
  kernel<<<grid, dim3(kTileW, th), smem, stream>>>(
      static_cast<const T*>(p0), static_cast<const T*>(p1), static_cast<T*>(out), h, w, radius,
      inv_c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC8>
int launch_backward(const void* g, long long g_bstride, const void* p0, const void* p1,
                    const void* e0, const void* e1, int es, void* d0, void* d1, int batch,
                    int h, int w, int radius, int s, float scale, int spread,
                    cudaStream_t stream) {
  constexpr int CH = NC8 * 8 / Chunk<T>::n;
  int smem = 0;
  const int th = tile_rows(kBackwardRows, radius, CH, &smem);
  if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = corr_backward<T, NC8>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + th - 1) / th, batch);
  kernel<<<grid, dim3(kTileW, th), smem, stream>>>(
      static_cast<const T*>(g), g_bstride, static_cast<const T*>(p0), static_cast<const T*>(p1),
      static_cast<const float*>(e0), static_cast<const float*>(e1), es, d0, d1, h, w, radius, s,
      scale, spread);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the channel count C = 8 * NC8 (8 to 64) and the type.
#define HIMO_CORR_DISPATCH(C_, BF16_, CALL_)           \
  switch ((C_) / 8) {                                  \
    case 1: return (BF16_) ? CALL_(__nv_bfloat16, 1) : CALL_(float, 1); \
    case 2: return (BF16_) ? CALL_(__nv_bfloat16, 2) : CALL_(float, 2); \
    case 3: return (BF16_) ? CALL_(__nv_bfloat16, 3) : CALL_(float, 3); \
    case 4: return (BF16_) ? CALL_(__nv_bfloat16, 4) : CALL_(float, 4); \
    case 5: return (BF16_) ? CALL_(__nv_bfloat16, 5) : CALL_(float, 5); \
    case 6: return (BF16_) ? CALL_(__nv_bfloat16, 6) : CALL_(float, 6); \
    case 7: return (BF16_) ? CALL_(__nv_bfloat16, 7) : CALL_(float, 7); \
    case 8: return (BF16_) ? CALL_(__nv_bfloat16, 8) : CALL_(float, 8); \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

}  // namespace

// Pool both (B, H, W, C) images (frame stride `img_bstride` elements) at
// stride pool_a into p0a, p1a and, when pool_b > 0, at pool_b into p0b, p1b
// ((B, H / s, W / s, C) each). lanes_*: the lanes PyTorch's mean gives one
// output at these shapes. bf16 != 0: bf16 images, else fp32.
extern "C" int himo_corr_pool(const void* img0, const void* img1, void* p0a, void* p1a,
                              void* p0b, void* p1b, int batch, int height, int width, int c,
                              int img_bstride, int pool_a, int lanes_a, int pool_b, int lanes_b,
                              int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || height == 0 || width == 0) return static_cast<int>(cudaGetLastError());
  const long long n_in = static_cast<long long>(batch) * c * height * width;
  auto level = [&](void* p0, void* p1, int s, int lanes) {
    const long long n_out = static_cast<long long>(batch) * c * (height / s) * (width / s);
    // PyTorch's mean: static_cast<float>(outputs) / inputs.
    return PoolLevel{p0, p1, s, lanes, static_cast<float>(n_out) / static_cast<float>(n_in)};
  };
  const PoolLevel la = level(p0a, p1a, pool_a, lanes_a);
  const PoolLevel lb = pool_b > 0 ? level(p0b, p1b, pool_b, lanes_b) : la;
  const int nlevels = pool_b > 0 ? 2 : 1;
  const int smax = pool_b > pool_a ? pool_b : pool_a;
  const int region = smax * ((kPoolRegion + smax - 1) / smax);
  const dim3 grid((width + region - 1) / region, height / smax, batch);
  const int vals = bf16 ? 8 : 4;
  if (bf16) {
    pool_images<__nv_bfloat16><<<grid, kPoolThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(img0), static_cast<const __nv_bfloat16*>(img1),
        img_bstride, height, width, c / vals, smax, region, la, lb, nlevels);
  } else {
    pool_images<float><<<grid, kPoolThreads, 0, st>>>(
        static_cast<const float*>(img0), static_cast<const float*>(img1), img_bstride, height,
        width, c / vals, smax, region, la, lb, nlevels);
  }
  return static_cast<int>(cudaGetLastError());
}

// The (B, (2r + 1)^2, h, w) volume of pooled (B, h, w, c) images, rows of
// c channels of which the first c_div are the image's (the rest zeros).
extern "C" int himo_corr_forward(const void* p0, const void* p1, void* out, int batch, int h,
                                 int w, int c, int c_div, int radius, int bf16, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const float inv_c = 1.0f / static_cast<float>(c_div);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HIMO_CALL(T_, N_) launch_forward<T_, N_>(p0, p1, out, batch, h, w, radius, inv_c, st)
  HIMO_CORR_DISPATCH(c, bf16, HIMO_CALL)
#undef HIMO_CALL
}

// The pooled images' gradients of one level (see `corr_backward`), rows of c
// channels of which the first c_div are the image's: g is the
// (B, (2r + 1)^2, h, w) gradient of its volume (frame stride `g_bstride`
// elements); with spread != 0, d0 and d1 are the (B, h * pool, w * pool, C)
// image gradients and extra0, extra1 (may be null) the other level's fp32
// (B, h * pool / extra_pool, w * pool / extra_pool, C) contributions; with
// spread == 0, d0 and d1 are this level's fp32 (B, h, w, C) contributions.
extern "C" int himo_corr_backward(const void* g, const void* p0, const void* p1,
                                  const void* extra0, const void* extra1, void* d0, void* d1,
                                  int batch, int h, int w, int c, int c_div, int radius,
                                  int g_bstride, int pool, int extra_pool, int spread, int bf16,
                                  void* stream) {
  if (batch == 0 || h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const float scale = 1.0f / static_cast<float>(c_div) / static_cast<float>(pool * pool);
  const int es = extra0 != nullptr ? extra_pool : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HIMO_CALL(T_, N_)                                                                  \
  launch_backward<T_, N_>(g, g_bstride, p0, p1, extra0, extra1, es, d0, d1, batch, h, w,  \
                          radius, pool, scale, spread, st)
  HIMO_CORR_DISPATCH(c, bf16, HIMO_CALL)
#undef HIMO_CALL
}
