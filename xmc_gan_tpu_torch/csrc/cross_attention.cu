// Masked cross-attention (queries over word keys) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of xmc_gan_tpu/ops/pallas/cross_attention.py
// (masked_cross_attention, kernel _attn_kernel):
//
//   ctx[b, g, n] = sum_t softmax_t(scale * q[b,g,n] . k[b,g,t], padded t -> -inf) v[b,g,t]
//
// for q [B, G, N, D], k and v [B, G, T, D] and a padding mask [B, T] (1 =
// padded word) shared by the G groups of a row b.  Math is fp32 whatever the
// operand type (fp32 or bf16); the result is rounded once, on store, to that
// type.  A row whose words are all padded gets 0, as the Pallas kernel gives
// it (acc / max(l, 1e-30)); the dense softmax would give NaN there.  Scores
// are kept in log2 units (scale * log2(e) folded into q or k) and padded
// words are skipped, so their values never enter.
//
// Three kernels; the wrapper's plan (ops/cuda/cross_attention.py, plan())
// names one and its launch geometry before any launch, and the C entry
// refuses a launch whose kernel or geometry is not one it takes.
//
// attn_grouped: the In sampler's shapes.  The concept generators' In
// sampler attends HW queries of each of G = 16 concept groups, D = 4, over
// T = 15 words.  Ten launches a 256^2 request at batch 128 move 491 M query
// rows in and out: 2.35 ms of bytes in bf16 and 4.69 ms in fp32 at 3.35
// TB/s (a copy of them takes 2.6 / 5.2 ms on an H100), against ~4e9
// (query, real word) pairs of ~11 issued instructions and one exp2 each.
// What bounded attn_small there was neither: with no word to attend it
// still took 2.9x the copy of its bytes in bf16 (one block of 128 threads
// per (b, g) and 512 queries, ~260k short blocks a launch).  Measured on an
// H100 (PERF.md): fp32 is bound by its bytes (its arithmetic hides under
// them); bf16 by the fp32 instruction issue of its (row, word) pairs, which
// adds to the time of its bytes rather than hiding under it (an exp2 less
// saves 4%, four FMAs less 17%).  The design:
//   * A block owns one row b and walks up to 16 tiles of its queries, three
//     16 KB slabs of q deep (64 queries of all G groups in fp32, 128 in
//     bf16): two tiles are in flight (16-byte cp.async, every sector used)
//     while one computes.  q lies in one of two layouts: rows (each query's
//     G rows contiguous, [B, N, G, D]: the channels_last query map; the
//     slab's chunks XOR-swizzled by query so that reading a column at a
//     G*D stride is conflict-free) or planes (n contiguous for each (g, d),
//     [B, G, D, N]: the map after a CUDA GroupNorm, which returns NCHW).
//   * The row's real words (the mask read once, compacted with a ballot)
//     and their keys and values for all G groups are staged once per block
//     as fp32 in shared memory, the keys pre-scaled, with each group's
//     largest key norm; any k and v strides are read, so the sampler's keys
//     (a d-stride of T) need no copy.
//   * A thread takes two (fp32) or four (bf16) queries of one 16-byte
//     column of a query's row (one group in fp32, two in bf16), so each
//     word's key and value loads are warp broadcasts that serve two or
//     eight rows.
//   * One pass over the real words: each score once, one exp2 each, padded
//     words not visited.  The softmax's shift is |q| max|k|, an upper
//     bound of the row's scores (Cauchy-Schwarz), so no max pass is needed;
//     where a row's bound exceeds 32 (log2 units) the warp first takes the
//     exact maximum, so no weight that matters can underflow.
//   * ctx is stored from registers as [B, G, N, D]: a warp writes 32
//     consecutive queries of one group, 512 (fp32) or 256 (bf16) contiguous
//     bytes, whole sectors.
// Precondition (the plan's rule): D = 4, 1 <= T <= 32, G a power of two in
// 2..32, q's strides (., D, G*D, 1) (rows) or (., qsg, 1, qsd) (planes),
// q's address and its b, g and d strides multiples of 16 bytes.

// attn_small (D <= 32) and attn_wide (32 < D <= 256) take every other
// shape, any grouping (the Out sampler's [B, 16, D] rows, the JAX package's
// kernel shapes); q, k, v are strided views with a dense last dimension:
//   * D <= 32: one thread per query, its q and its D accumulators in
//     registers (templated on DMAX in {4, 8, 16, 32}), R = 4 queries per
//     thread for D <= 4 (2 for D <= 8); a block of 128 threads of one
//     (b, g) stages 128-word tiles of k and v as fp32 in shared memory, and
//     every thread of a warp reads the same word at once (a broadcast); an
//     online softmax per tile (its max first, then one rescale and one
//     exp2 per word).
//   * 32 < D <= 256: one warp per query, each lane owning the dimensions
//     lane + 32 j; the score is a butterfly sum over the warp (every lane
//     ends with the same value: fp32 addition commutes).  16-word tiles.
// Blocks are numbered with g fastest; out is written dense, [B, G, N, D].
//
// C interface (bound with ctypes, pointers and stream as void*):
//   int xmc_cross_attention(q, k, v, mask, out, B, G, N, T, D,
//                           qsb, qsg, qsn, qsd, ksb, ksg, kst, ksd,
//                           vsb, vsg, vst, vsd, osb, osg, osn, scale, dtype,
//                           kernel, layout, threads, blocks, tile,
//                           tiles_per_block, stream)
//   Element (b, g, l, d) of an operand lies at p + b*sb + g*sg + l*sl + d*sd.
//   dtype 0 = fp32, 1 = bf16 (q, k, v and out alike); mask is uint8 [B, T].
//   kernel 0 = attn_small, 1 = attn_wide, 2 = attn_grouped (layout 0 =
//   rows, 1 = planes; 0 for the others); threads, blocks, tile (queries a
//   block, or a tile) and tiles_per_block are the plan's geometry.  Returns
//   cudaGetLastError() after the launch (0 = success), or
//   cudaErrorInvalidValue for a launch the named kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kSmallThreads = 128;  // queries per block, D <= 32
constexpr int kSmallTileT = 128;    // words per staged tile, D <= 32
constexpr int kWideWarps = 8;       // queries (one per warp) per block, D > 32
constexpr int kWideTileT = 16;      // words per staged tile, D > 32
constexpr int kMaxD = 256;
constexpr int kPerLane = kMaxD / 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The first D values of a row into r[0..DMAX) (zeros past D); one vector load
// when the row is exactly 4 values at an aligned address.
template <typename T, int DMAX>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int D, float (&r)[DMAX]) {
  if constexpr (DMAX == 4) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (D == 4 && (a % (4 * sizeof(T))) == 0) {
      if constexpr (sizeof(T) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int d = 0; d < 4; ++d) r[d] = to_f(h[d]);
      }
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < DMAX; ++d) r[d] = d < D ? to_f(p[d]) : 0.f;
}

template <typename T, int DMAX>
__device__ __forceinline__ void store_row(T* __restrict__ p, int D, const float (&r)[DMAX]) {
  if constexpr (DMAX == 4) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (D == 4 && (a % (4 * sizeof(T))) == 0) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
        uint2 raw;
        T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int d = 0; d < 4; ++d) h[d] = from_f<T>(r[d]);
        *reinterpret_cast<uint2*>(p) = raw;
      }
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < DMAX; ++d)
    if (d < D) p[d] = from_f<T>(r[d]);
}

template <int DMAX>
__device__ __forceinline__ float dot(const float (&q)[DMAX], const float* __restrict__ k) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) s = fmaf(q[d], k[d], s);
  return s;
}

struct Args {
  int G, N, T, D, ntiles;
  int64_t qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn;
  float scale;
};

// Block index -> (b, g, query tile), g fastest.
__device__ __forceinline__ void block_coords(const Args& a, int& b, int& g, int& tile) {
  const int64_t bid = blockIdx.x;
  g = static_cast<int>(bid % a.G);
  const int64_t rest = bid / a.G;
  tile = static_cast<int>(rest % a.ntiles);
  b = static_cast<int>(rest / a.ntiles);
}

// Words [t0, t0 + tt) of row (b, g): k and v as fp32 into ks/vs (row stride
// ld, zero past D, so that a dot product over a padded row width adds only
// zeros), the mask into pad.  All threads of the block take part.
template <typename T>
__device__ __forceinline__ void stage_words(const Args& a, const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const uint8_t* __restrict__ mask, int b, int g,
                                            int t0, int tt, int ld, float* ks, float* vs,
                                            uint8_t* pad) {
  const T* kb = k + b * a.ksb + g * a.ksg;
  const T* vb = v + b * a.vsb + g * a.vsg;
  for (int i = threadIdx.x; i < tt * ld; i += blockDim.x) {
    const int t = i / ld, d = i - t * ld;
    const bool in = d < a.D;
    ks[i] = in ? to_f(kb[(t0 + t) * a.kst + d]) : 0.f;
    vs[i] = in ? to_f(vb[(t0 + t) * a.vst + d]) : 0.f;
  }
  for (int i = threadIdx.x; i < tt; i += blockDim.x)
    pad[i] = mask[static_cast<int64_t>(b) * a.T + t0 + i];
}

// Thread per query, D <= DMAX <= 32; each thread carries R queries of the
// row (n = tile * R * blockDim + r * blockDim + tid, so each r is a coalesced
// sweep), which amortizes the block's word staging and its two barriers over
// R times as many queries and gives R independent FMA chains per word.
template <typename T, int DMAX, int R>
__global__ void __launch_bounds__(kSmallThreads)
attn_small(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, T* __restrict__ out, Args a) {
  __shared__ float ks[kSmallTileT * DMAX];
  __shared__ float vs[kSmallTileT * DMAX];
  __shared__ uint8_t pad[kSmallTileT];
  int b, g, tile;
  block_coords(a, b, g, tile);
  const int n0 = tile * R * blockDim.x + threadIdx.x;

  float qv[R][DMAX], acc[R][DMAX], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * blockDim.x;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) qv[r][d] = acc[r][d] = 0.f;
    if (n < a.N) load_row<T, DMAX>(q + b * a.qsb + g * a.qsg + n * a.qsn, a.D, qv[r]);
#pragma unroll
    for (int d = 0; d < DMAX; ++d) qv[r][d] *= a.scale * kLog2e;  // scores in log2 units
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int t0 = 0; t0 < a.T; t0 += kSmallTileT) {
    const int tt = min(kSmallTileT, a.T - t0);
    __syncthreads();  // the previous tile has been read by every thread
    stage_words(a, k, v, mask, b, g, t0, tt, DMAX, ks, vs, pad);
    __syncthreads();
    // Queries past N compute on zeros and are not stored.
    float mt[R];  // the tile's largest score per query
#pragma unroll
    for (int r = 0; r < R; ++r) mt[r] = -INFINITY;
    for (int t = 0; t < tt; ++t) {
      if (pad[t]) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) mt[r] = fmaxf(mt[r], dot<DMAX>(qv[r], ks + t * DMAX));
    }
    if (mt[0] == -INFINITY) continue;  // every word of the tile is padded (uniform)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_new = fmaxf(m[r], mt[r]);
      const float alpha = exp2f(m[r] - m_new);  // rescale of the old mass, 0 when m = -inf
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) acc[r][d] *= alpha;
      m[r] = m_new;
    }
    for (int t = 0; t < tt; ++t) {
      if (pad[t]) continue;
      const float* kt = ks + t * DMAX;
      const float* vt = vs + t * DMAX;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = exp2f(dot<DMAX>(qv[r], kt) - m[r]);
        l[r] += p;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) acc[r][d] = fmaf(p, vt[d], acc[r][d]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * blockDim.x;
    if (n >= a.N) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int d = 0; d < DMAX; ++d) acc[r][d] = acc[r][d] / denom;
    store_row<T, DMAX>(out + b * a.osb + g * a.osg + n * a.osn, a.D, acc[r]);
  }
}

// Warp per query, 32 < D <= 256: lane owns dimensions lane + 32 j.
template <typename T>
__global__ void __launch_bounds__(kWideWarps * 32)
attn_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const uint8_t* __restrict__ mask, T* __restrict__ out, Args a) {
  __shared__ float ks[kWideTileT * kMaxD];
  __shared__ float vs[kWideTileT * kMaxD];
  __shared__ uint8_t pad[kWideTileT];
  int b, g, tile;
  block_coords(a, b, g, tile);
  const int lane = threadIdx.x & 31;
  const int n = tile * kWideWarps + (threadIdx.x >> 5);
  const bool active = n < a.N;

  float qv[kPerLane], acc[kPerLane];
  const T* qrow = q + b * a.qsb + g * a.qsg + n * a.qsn;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int d = lane + 32 * j;
    qv[j] = (active && d < a.D) ? to_f(qrow[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int t0 = 0; t0 < a.T; t0 += kWideTileT) {
    const int tt = min(kWideTileT, a.T - t0);
    __syncthreads();
    stage_words(a, k, v, mask, b, g, t0, tt, kMaxD, ks, vs, pad);
    __syncthreads();
    if (!active) continue;  // whole warps: n is uniform over a warp
    float s[kWideTileT];  // the tile's scores in log2 units, -inf for padded words
    float mt = -INFINITY;
#pragma unroll
    for (int t = 0; t < kWideTileT; ++t) {
      s[t] = -INFINITY;
      if (t >= tt || pad[t]) continue;  // uniform over the block
      const float* kt = ks + t * kMaxD;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < a.D) part = fmaf(qv[j], kt[d], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      s[t] = part * (a.scale * kLog2e);
      mt = fmaxf(mt, s[t]);
    }
    if (mt == -INFINITY) continue;
    const float m_new = fmaxf(m, mt);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] *= alpha;
#pragma unroll
    for (int t = 0; t < kWideTileT; ++t) {
      if (s[t] == -INFINITY) continue;
      const float p = exp2f(s[t] - m_new);
      const float* vt = vs + t * kMaxD;
      l += p;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < a.D) acc[j] = fmaf(p, vt[d], acc[j]);
      }
    }
    m = m_new;
  }
  if (!active) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = out + b * a.osb + g * a.osg + n * a.osn;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < a.D) orow[d] = from_f<T>(acc[j] / denom);
  }
}


// ---------------------------------------------------------------- attn_grouped

constexpr int kGroupedThreads = 256;
constexpr int kGroupedWarps = kGroupedThreads / 32;
constexpr int kGroupedStages = 3;      // slabs in shared memory: one computing, two in flight
constexpr int kGroupedTileBytes = 16384;
constexpr int kGroupedMaxG = 32;
constexpr int kGroupedMaxT = 32;       // one warp's ballot of the mask row
constexpr int kChunk = 16;             // bytes of one cp.async
constexpr float kShiftCap = 32.f;      // largest score bound (log2 units) used as the shift

struct GroupedArgs {
  int G, N, T, tile, tiles_per_block, splits, lcpr, ltile;  // log2 of chunks a query, of tile
  int64_t qsb, qsg, qsd, ksb, ksg, kst, ksd, vsb, vsg, vst, vsd, osb, osg;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float dot4(const float (&q)[4], const float4& k) {
  float x = q[0] * k.x;
  x = fmaf(q[1], k.y, x);
  x = fmaf(q[2], k.z, x);
  return fmaf(q[3], k.w, x);
}

// A 16-byte chunk of a query's row: one group's D = 4 values in fp32, two
// groups' in bf16; a thread takes kQueries queries of one chunk at once:
// bf16 is bound by its arithmetic, and 4 queries (8 rows) a thread halve the
// word loads a row against 2 (fp32, bound by its bytes: its 2 queries keep
// the slab at 16 KB).
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kGroups = 1;
  static constexpr int kQueries = 2;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (*r)[4]) {
    r[0][0] = __uint_as_float(raw.x);
    r[0][1] = __uint_as_float(raw.y);
    r[0][2] = __uint_as_float(raw.z);
    r[0][3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static void store(float* p, const float (&r)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kGroups = 2;
  static constexpr int kQueries = 4;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (*r)[4]) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int d = 0; d < 4; ++d) r[j][d] = __bfloat162float(h[4 * j + d]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&r)[4]) {
    uint2 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int d = 0; d < 4; ++d) h[d] = __float2bfloat16_rn(r[d]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Queries a tile: a 16 KB slab, and at least one 32-query block for each
// of the `queries` a thread takes at once.
__host__ __device__ constexpr int grouped_tile(int cpr, int queries) {
  return kGroupedTileBytes / (kChunk * cpr) > 32 * queries ? kGroupedTileBytes / (kChunk * cpr)
                                                            : 32 * queries;
}

// One block: row b, tiles [first, first + count) of its queries (see the
// header).  PLANES: q's layout, 0 = rows (q[b, g, n, d] at b*qsb + (n*G + g)*4
// + d), 1 = planes (at b*qsb + g*qsg + d*qsd + n).
template <typename T, int PLANES>
__global__ void __launch_bounds__(kGroupedThreads, 2)
attn_grouped(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const uint8_t* __restrict__ mask, T* __restrict__ out, GroupedArgs a) {
  constexpr int GPC = Chunk<T>::kGroups;  // groups a thread takes: a chunk of a query's row
  constexpr int CPI = Chunk<T>::kQueries;
  constexpr int ROWS = GPC * CPI;         // row i * GPC + j: query nl[i], group col * GPC + j
  constexpr int EPC = kChunk / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpr = 1 << a.lcpr;            // chunks a query
  const int sw = min(cpr, 8) - 1;         // rows: chunk c of query n at c ^ (n & sw)
  const int slab_chunks = a.tile << a.lcpr;
  uint4* slabs = reinterpret_cast<uint4*>(smem);
  float4* ks = reinterpret_cast<float4*>(slabs + kGroupedStages * slab_chunks);  // [G][T]
  float4* vs = ks + a.G * a.T;
  float* kmax = reinterpret_cast<float*>(vs + a.G * a.T);  // [G]: the largest key norm
  int* idx = reinterpret_cast<int*>(kmax + a.G);          // the real words, in order
  int* nreal_s = idx + kGroupedMaxT;

  const int b = blockIdx.x / a.splits;
  const int first = (blockIdx.x - b * a.splits) * a.tiles_per_block;
  const int ntiles = (a.N + a.tile - 1) / a.tile;
  const int count = min(a.tiles_per_block, ntiles - first);  // >= 1: the plan's split
  const T* qb = q + b * a.qsb;
  const uint32_t slab0 = static_cast<uint32_t>(__cvta_generic_to_shared(slabs));

  // Tile `it` of the block into slab it % kGroupedStages; queries past N
  // are zero-filled.  Rows: the contiguous [tile, G, D] slab, swizzled.
  // Planes: the G * D runs of `tile` queries, one after another.
  auto load_tile = [&](int it) {
    const int n0 = (first + it) * a.tile;
    const uint32_t base = slab0 + (it % kGroupedStages) * slab_chunks * kChunk;
    for (int c = threadIdx.x; c < slab_chunks; c += kGroupedThreads) {
      if constexpr (PLANES) {
        const int lrun = a.ltile - (EPC == 4 ? 2 : 3);  // log2 of chunks a run
        const int run = c >> lrun, n = n0 + ((c & ((1 << lrun) - 1)) * EPC);
        const int bytes = max(0, min(kChunk, (a.N - n) * static_cast<int>(sizeof(T))));
        const T* src = bytes ? qb + (run >> 2) * a.qsg + (run & 3) * a.qsd + n : qb;
        cp_async16(base + c * kChunk, src, bytes);
      } else {
        const int nl = c >> a.lcpr, col = c & (cpr - 1);
        const bool in = n0 + nl < a.N;
        const T* src = in ? qb + (static_cast<int64_t>(n0) * cpr + c) * EPC : qb;
        cp_async16(base + ((nl << a.lcpr) + (col ^ (nl & sw))) * kChunk, src, in ? kChunk : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kGroupedStages - 1; ++s) {
    if (s < count) load_tile(s);
    cp_async_commit();
  }

  // The row's real words, while the first slabs arrive: keys (scaled to
  // log2 units) and values of every group, and each group's largest key norm.
  if (threadIdx.x < 32) {
    const int t = threadIdx.x;
    const bool real = t < a.T && mask[static_cast<int64_t>(b) * a.T + t] == 0;
    const unsigned bits = __ballot_sync(0xffffffffu, real);
    if (real) idx[__popc(bits & ((1u << t) - 1u))] = t;
    if (t == 0) *nreal_s = __popc(bits);
  }
  __syncthreads();
  const int nreal = *nreal_s;
  const float c2 = a.scale * kLog2e;
  for (int i = threadIdx.x; i < a.G * nreal; i += kGroupedThreads) {
    const int g = i / nreal, j = i - g * nreal;
    const T* kp = k + b * a.ksb + g * a.ksg + idx[j] * a.kst;
    const T* vp = v + b * a.vsb + g * a.vsg + idx[j] * a.vst;
    ks[g * a.T + j] = make_float4(to_f(kp[0]) * c2, to_f(kp[a.ksd]) * c2,
                                  to_f(kp[2 * a.ksd]) * c2, to_f(kp[3 * a.ksd]) * c2);
    vs[g * a.T + j] = make_float4(to_f(vp[0]), to_f(vp[a.vsd]), to_f(vp[2 * a.vsd]),
                                  to_f(vp[3 * a.vsd]));
  }
  __syncthreads();
  if (threadIdx.x < a.G) {
    float n2 = 0.f;
    for (int j = 0; j < nreal; ++j) {
      const float4 kk = ks[threadIdx.x * a.T + j];
      n2 = fmaxf(n2, kk.x * kk.x + kk.y * kk.y + kk.z * kk.z + kk.w * kk.w);
    }
    kmax[threadIdx.x] = sqrtf(n2);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = ((a.tile >> 5) / CPI) << a.lcpr;  // (query block, column) items a tile
  for (int it = 0; it < count; ++it) {
    cp_async_wait<kGroupedStages - 2>();
    __syncthreads();  // tile `it` has landed; every thread is done with tile it - 1's slab
    if (it + kGroupedStages - 1 < count) load_tile(it + kGroupedStages - 1);
    cp_async_commit();
    const uint4* slab = slabs + (it % kGroupedStages) * slab_chunks;
    const int n0 = (first + it) * a.tile;
    for (int p = warp; p < items; p += kGroupedWarps) {
      const int col = p & (cpr - 1);
      const int nb = (p >> a.lcpr) * CPI;
      float qv[ROWS][4];
      int nl[CPI];
#pragma unroll
      for (int i = 0; i < CPI; ++i) {
        nl[i] = (nb + i) * 32 + lane;
        if constexpr (PLANES) {
          const T* plane = reinterpret_cast<const T*>(slab);
#pragma unroll
          for (int j = 0; j < GPC; ++j)
#pragma unroll
            for (int d = 0; d < 4; ++d)
              qv[i * GPC + j][d] = to_f(plane[(((col * GPC + j) * 4 + d) << a.ltile) + nl[i]]);
        } else {
          Chunk<T>::unpack(slab[(nl[i] << a.lcpr) + (col ^ (nl[i] & sw))], qv + i * GPC);
        }
      }
      const float4* kg = ks + col * GPC * a.T;
      const float4* vg = vs + col * GPC * a.T;
      // The shift: |q| max|k| bounds every score of the row (Cauchy-Schwarz);
      // where it exceeds kShiftCap for a row of the warp, the exact maximum.
      float m[ROWS];
      bool wide = false;
#pragma unroll
      for (int j = 0; j < GPC; ++j) {
        const float km = kmax[col * GPC + j];
#pragma unroll
        for (int i = 0; i < CPI; ++i) {
          const int r = i * GPC + j;
          m[r] = sqrt_approx(qv[r][0] * qv[r][0] + qv[r][1] * qv[r][1] + qv[r][2] * qv[r][2] +
                             qv[r][3] * qv[r][3]) * km;
          wide |= m[r] > kShiftCap;
        }
      }
      if (__any_sync(0xffffffffu, wide)) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) m[r] = -INFINITY;
        for (int t = 0; t < nreal; ++t)
#pragma unroll
          for (int j = 0; j < GPC; ++j) {
            const float4 kk = kg[j * a.T + t];
#pragma unroll
            for (int i = 0; i < CPI; ++i)
              m[i * GPC + j] = fmaxf(m[i * GPC + j], dot4(qv[i * GPC + j], kk));
          }
      }
      // One pass over the real words: each score once, one exp2 each.
      float l[ROWS], acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        l[r] = 0.f;
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[r][d] = 0.f;
      }
#pragma unroll 4
      for (int t = 0; t < nreal; ++t) {
#pragma unroll
        for (int j = 0; j < GPC; ++j) {
          const float4 kk = kg[j * a.T + t];  // broadcasts
          const float4 vv = vg[j * a.T + t];
#pragma unroll
          for (int i = 0; i < CPI; ++i) {
            const int r = i * GPC + j;
            float x = fmaf(qv[r][0], kk.x, -m[r]);
            x = fmaf(qv[r][1], kk.y, x);
            x = fmaf(qv[r][2], kk.z, x);
            const float e = ex2(fmaf(qv[r][3], kk.w, x));
            l[r] += e;
            acc[r][0] = fmaf(e, vv.x, acc[r][0]);
            acc[r][1] = fmaf(e, vv.y, acc[r][1]);
            acc[r][2] = fmaf(e, vv.z, acc[r][2]);
            acc[r][3] = fmaf(e, vv.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < CPI; ++i) {
        const int n = n0 + nl[i];
        if (n >= a.N) continue;
#pragma unroll
        for (int j = 0; j < GPC; ++j) {
          const int r = i * GPC + j;
          const float inv = 1.f / fmaxf(l[r], 1e-30f);
          const float o[4] = {acc[r][0] * inv, acc[r][1] * inv, acc[r][2] * inv,
                              acc[r][3] * inv};
          Chunk<T>::store(out + b * a.osb + (col * GPC + j) * a.osg + n * 4, o);
        }
      }
    }
  }
}

template <typename T, int PLANES>
int launch_grouped(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                   const GroupedArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kGroupedStages) * (a.tile << a.lcpr) * kChunk +
                      2 * static_cast<size_t>(a.G) * a.T * sizeof(float4) +
                      a.G * sizeof(float) + (kGroupedMaxT + 1) * sizeof(int);
  const auto kern = attn_grouped<T, PLANES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, kGroupedThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

constexpr int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The plan's attn_grouped launch, if attn_grouped takes it (the header's
// precondition, and the tile its shared-memory layout is built for).
template <typename T>
int grouped(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
            int G, int N, int T_, int D, int64_t qsb, int64_t qsg, int64_t qsn, int64_t qsd,
            const int64_t (&kvs)[8], int64_t osb, int64_t osg, int64_t osn, float scale,
            int planes, int threads, int blocks, int tile, int tiles_per_block,
            cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  constexpr int es = sizeof(T);
  if (D != 4 || G < 2 || G > kGroupedMaxG || (G & (G - 1)) != 0 || T_ < 1 ||
      T_ > kGroupedMaxT || reinterpret_cast<uintptr_t>(q) % kChunk != 0 || (qsb * es) % kChunk)
    return bad;
  if (planes == 0 && (qsd != 1 || qsg != D || qsn != static_cast<int64_t>(G) * D)) return bad;
  if (planes == 1 && (qsn != 1 || (qsg * es) % kChunk || (qsd * es) % kChunk)) return bad;
  if (planes != 0 && planes != 1) return bad;
  if (osn != D || osg % 4 != 0 || osb % 4 != 0 || reinterpret_cast<uintptr_t>(out) % kChunk)
    return bad;
  const int cpr = G * D * es / kChunk;
  if (threads != kGroupedThreads || tile != grouped_tile(cpr, Chunk<T>::kQueries) ||
      tiles_per_block < 1 ||
      blocks % B != 0)
    return bad;
  const int splits = blocks / B;
  const int ntiles = (N + tile - 1) / tile;
  if (splits != (ntiles + tiles_per_block - 1) / tiles_per_block) return bad;
  const GroupedArgs a{G,      N,      T_,     tile,   tiles_per_block, splits, log2_exact(cpr),
                      log2_exact(tile), qsb,    qsg,    qsd,    kvs[0],          kvs[1], kvs[2],
                      kvs[3], kvs[4],   kvs[5], kvs[6], kvs[7], osb,             osg,    scale};
  return planes ? launch_grouped<T, 1>(q, k, v, mask, out, a, blocks, stream)
                : launch_grouped<T, 0>(q, k, v, mask, out, a, blocks, stream);
}

// attn_small or attn_wide, with the geometry each is built for; the plan's
// must be the same.
template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
           Args a, int kernel, int threads_planned, int blocks_planned, int tile_planned,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  // queries per thread: 4 for D <= 4, 2 for D <= 8, else 1 (registers)
  const int per_thread = a.D <= 4 ? 4 : a.D <= 8 ? 2 : 1;
  int threads, per_block;
  if (a.D <= 32) {
    const int need = (a.N + per_thread - 1) / per_thread;
    threads = need >= kSmallThreads ? kSmallThreads : ((need + 31) / 32) * 32;
    per_block = threads * per_thread;
  } else {
    threads = kWideWarps * 32;
    per_block = kWideWarps;
  }
  a.ntiles = (a.N + per_block - 1) / per_block;
  const int64_t blocks = static_cast<int64_t>(B) * a.G * a.ntiles;
  if (blocks > 0x7fffffffLL || kernel != (a.D <= 32 ? 0 : 1) || threads != threads_planned ||
      blocks != blocks_planned || per_block != tile_planned)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (a.D <= 4) {
    attn_small<T, 4, 4><<<grid, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  } else if (a.D <= 8) {
    attn_small<T, 8, 2><<<grid, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  } else if (a.D <= 16) {
    attn_small<T, 16, 1><<<grid, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  } else if (a.D <= 32) {
    attn_small<T, 32, 1><<<grid, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  } else {
    attn_wide<T><<<grid, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xmc_cross_attention(const void* q, const void* k, const void* v,
                                   const uint8_t* mask, void* out, int B, int G, int N, int T,
                                   int D, int64_t qsb, int64_t qsg, int64_t qsn, int64_t qsd,
                                   int64_t ksb, int64_t ksg, int64_t kst, int64_t ksd,
                                   int64_t vsb, int64_t vsg, int64_t vst, int64_t vsd,
                                   int64_t osb, int64_t osg, int64_t osn, float scale, int dtype,
                                   int kernel, int layout, int threads, int blocks, int tile,
                                   int tiles_per_block, void* stream) {
  if (D < 1 || D > kMaxD || G < 1 || N < 0 || T < 0 || B < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || B == 0) return 0;  // nothing to compute
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 2) {
    const int64_t kvs[8] = {ksb, ksg, kst, ksd, vsb, vsg, vst, vsd};
    return dtype == 0 ? grouped<float>(q, k, v, mask, out, B, G, N, T, D, qsb, qsg, qsn, qsd,
                                       kvs, osb, osg, osn, scale, layout, threads, blocks,
                                       tile, tiles_per_block, s)
                      : grouped<__nv_bfloat16>(q, k, v, mask, out, B, G, N, T, D, qsb, qsg,
                                               qsn, qsd, kvs, osb, osg, osn, scale, layout,
                                               threads, blocks, tile, tiles_per_block, s);
  }
  if (qsd != 1 || ksd != 1 || vsd != 1 || layout != 0 || tiles_per_block != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{G, N, T, D, 0, qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn, scale};
  if (dtype == 0) return launch<float>(q, k, v, mask, out, B, a, kernel, threads, blocks, tile, s);
  return launch<__nv_bfloat16>(q, k, v, mask, out, B, a, kernel, threads, blocks, tile, s);
}
