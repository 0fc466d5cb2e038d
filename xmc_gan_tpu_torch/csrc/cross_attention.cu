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
// it (acc / max(l, 1e-30)); the dense softmax would give NaN there.
//
// Words stream through shared memory in tiles with an online softmax (running
// max m, sum l and accumulator acc per query), as the Pallas kernel streams
// 128-word blocks, so any T fits.  Per tile: the scores' max first, then one
// rescale of (l, acc) and one exp2 per word (scores are kept in log2 units,
// q pre-scaled by scale * log2(e)).  Padded words are skipped, so their
// values never enter.
//
// Bound: bytes.  On the concept generators' path D = 4 and T = 15: a query
// reads 4 values and writes 4, and does ~10 flops and one exp per word, about
// 15 flops per byte of q and ctx (fp32), under the ~20 flops per byte at which
// the fp32 CUDA cores (67 TFLOP/s) would bound it ahead of 3.35 TB/s.  The
// word tiles are read once per block and stay in L2.  Design for that: CUDA
// cores, fp32 math, q and ctx each touched once.
//
//   * D <= 32: one thread per query, its q and its D accumulators in
//     registers (templated on DMAX in {4, 8, 16, 32}), R = 4 queries per
//     thread for D <= 4 (2 for D <= 8); a block of 128 threads of one
//     (b, g) stages 128-word tiles of k and v as fp32 in shared memory, and
//     every thread of a warp reads the same word at once (a broadcast).  For
//     D = 4 the q row (16 bytes fp32, 8 bf16) is one vector load and the
//     ctx row one vector store.
//   * 32 < D <= 256: one warp per query, each lane owning the dimensions
//     lane + 32 j; the score is a butterfly sum over the warp (every lane
//     ends with the same value: fp32 addition commutes).  16-word tiles.
//
// q, k, v and out are strided views (element (b, g, l, d) at
// p + b*sb + g*sg + l*sl + d), so the generator's grouped queries, which lie
// as [B, N, G, D] in memory, are read where they are, without a copy.  Blocks
// are numbered with g fastest: the blocks that run together read neighbouring
// groups of the same queries, so the 32-byte sectors that a strided q row
// leaves half used are read from L2, not twice from device memory.  out is
// written dense, [B, G, N, D].
//
// C interface (bound with ctypes, pointers and stream as void*):
//   int xmc_cross_attention(q, k, v, mask, out, B, G, N, T, D,
//                           qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst,
//                           osb, osg, osn, scale, dtype, stream)
//   dtype 0 = fp32, 1 = bf16 (q, k, v and out alike); mask is uint8 [B, T].
//   Returns cudaGetLastError() after the launch (0 = success), or
//   cudaErrorInvalidValue for a D outside 1..256 or a grid too large.

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

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
           Args a, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (a.N == 0 || B == 0) return 0;  // nothing to compute
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
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
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
                                   int D, int64_t qsb, int64_t qsg, int64_t qsn, int64_t ksb,
                                   int64_t ksg, int64_t kst, int64_t vsb, int64_t vsg,
                                   int64_t vst, int64_t osb, int64_t osg, int64_t osn,
                                   float scale, int dtype, void* stream) {
  if (D < 1 || D > kMaxD || G < 1 || N < 0 || T < 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{G, N, T, D, 0, qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, mask, out, B, a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, mask, out, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
