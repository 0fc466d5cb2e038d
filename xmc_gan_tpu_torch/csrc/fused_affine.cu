// Fused text-conditioned modulation epilogue for Hopper (sm_90a).
//
// Replaces the Pallas kernels of xmc_gan_tpu/ops/pallas/fused_affine.py:
//   modulate_lrelu_pallas         (NMOD = 1)  lrelu(g0 * x + b0)
//   double_modulate_lrelu_pallas  (NMOD = 2)  lrelu(g1 * lrelu(g0 * x + b0) + b1)
// over a channels_last activation, memory order [B, H*W, C], with the
// modulation vectors g*/b* given as fp32 [B, C].  Math is fp32; the result is
// rounded once, on store, to x's type (fp32 or bf16), as the Pallas kernel does.
//
// Bound: bytes.  Every element is read once and written once and there is no
// reuse (2 * B*H*W*C * sizeof(T) bytes against 3.35 TB/s on an H100 SXM); the
// 2-4 FMAs per element are far below the card's compute rate.  Design for
// that: a flat grid-stride loop where each thread moves 16 bytes per load and
// per store (4 fp32 or 8 bf16 channels of one pixel) when C is a multiple of
// that width and the pointers are 16-byte aligned, and one element per step
// otherwise.  The [B, C] vectors are small and stay in L1/L2; they are read
// through the read-only path, as float4s on the vector path (one scalar
// load per value would be 2-4 load instructions per byte of x).  The kernel allocates nothing and does not
// synchronise; it launches on the caller's stream.
//
// Backward (the Pallas kernels have none; training needs it for G): from x
// and the upstream dy it recomputes y0 = g0*x + b0 (and, for NMOD = 2,
// y1 = g1*lrelu(y0) + b1) and writes dx, rounded once to x's type, and the
// fp32 sums over H*W of dg0 = dy0*x, db0 = dy0 (dg1 = dy1*lrelu(y0),
// db1 = dy1).  LeakyReLU's derivative at 0 is 1, as jnp.where(y >= 0, ...)
// gives it.  Bound: bytes (x and dy read once, dx written once: 1.5x the
// forward's traffic).  A block owns (b, 32 channels, a run of pixels) as 32 x
// 8 threads: a warp reads 32 consecutive channels of one pixel, the 8 warps
// walk the pixels.  The four [B, C] sums are reduced over the warps in
// shared memory and then added with one fp32 atomicAdd per block and value
// into zeroed [B, C] buffers: the runs per (b, c) are few (about 4 x 132 x 8
// blocks spread over B x C / 32 channel tiles), so a second pass over a
// scratch buffer would cost more than the atomics.  The order of those adds
// varies from run to run (fp32 sums, not bit-reproducible).
//
// C interface (bound with ctypes, pointers and stream as void*):
//   int xmc_fused_affine(x, out, g0, b0, g1, b1, B, HW, C, nmod, dtype, slope, stream)
//   int xmc_fused_affine_bwd(x, dy, dx, g0, b0, g1, b1, dg0, db0, dg1, db1,
//                            B, HW, C, nmod, dtype, slope, stream)
//   dtype 0 = fp32, 1 = bf16; g1/b1 (dg1/db1) are ignored when nmod == 1.
//   dg*/db* are fp32 [B, C] and must hold zeros.
//   Returns cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float lrelu(float y, float slope) {
  return y >= 0.f ? y : slope * y;
}

// g * x + b with the product rounded before the add (no FMA contraction), as
// the plain version computes it: the backward branches on the sign of this
// value, so it must round the same way or elements within an ulp of 0 take
// the other slope.
__device__ __forceinline__ float affine_rn(float g, float x, float b) {
  return __fadd_rn(__fmul_rn(g, x), b);
}

template <int NMOD, typename I>
__device__ __forceinline__ float apply(float v, I m, const float* __restrict__ g0,
                                       const float* __restrict__ b0,
                                       const float* __restrict__ g1,
                                       const float* __restrict__ b1, float slope) {
  float y = lrelu(fmaf(__ldg(g0 + m), v, __ldg(b0 + m)), slope);
  if constexpr (NMOD == 2) y = lrelu(fmaf(__ldg(g1 + m), y, __ldg(b1 + m)), slope);
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive fp32 values from a 16-byte aligned address, as N/4 float4s.
template <int N>
__device__ __forceinline__ void load_f4(const float* __restrict__ p, float (&v)[N]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 t = __ldg(p4 + j);
    v[4 * j] = t.x;
    v[4 * j + 1] = t.y;
    v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}

// 16-byte vectors: VEC = 16 / sizeof(T) channels of one pixel per step.
// Requires C % VEC == 0, so a vector never straddles two pixels and its
// index m into the [B, C] vectors is a multiple of VEC: the modulation values
// of a vector are read as float4s too (all pointers 16-byte aligned).  I is
// the index type: 32-bit where the element count allows (integer division by
// H*W*C and C is the kernel's only non-trivial arithmetic besides the FMAs,
// and 64-bit division costs several times more), else 64-bit.
template <typename T, int NMOD, typename I>
__global__ void __launch_bounds__(kThreads)
fused_affine_vec(const T* __restrict__ x, T* __restrict__ out,
                 const float* __restrict__ g0, const float* __restrict__ b0,
                 const float* __restrict__ g1, const float* __restrict__ b1,
                 I n_vec, I hwc, I C, float slope) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec; i += stride) {
    const I e = i * VEC;
    const I m = (e / hwc) * C + e % C;  // index into the [B, C] vectors
    uint4 raw = xv[i];
    T* vals = reinterpret_cast<T*>(&raw);
    float ga[VEC], ba[VEC], gb[VEC], bb[VEC];
    load_f4(g0 + m, ga);
    load_f4(b0 + m, ba);
    if constexpr (NMOD == 2) {
      load_f4(g1 + m, gb);
      load_f4(b1 + m, bb);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float y = lrelu(fmaf(ga[k], to_f(vals[k]), ba[k]), slope);
      if constexpr (NMOD == 2) y = lrelu(fmaf(gb[k], y, bb[k]), slope);
      vals[k] = from_f<T>(y);
    }
    ov[i] = raw;
  }
}

// One element per step: any C, any alignment.
template <typename T, int NMOD, typename I>
__global__ void __launch_bounds__(kThreads)
fused_affine_scalar(const T* __restrict__ x, T* __restrict__ out,
                    const float* __restrict__ g0, const float* __restrict__ b0,
                    const float* __restrict__ g1, const float* __restrict__ b1,
                    I n, I hwc, I C, float slope) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I e = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; e < n; e += stride) {
    const I m = (e / hwc) * C + e % C;
    out[e] = from_f<T>(apply<NMOD>(to_f(x[e]), m, g0, b0, g1, b1, slope));
  }
}

int grid_for(int64_t work) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * kBlocksPerSM;
  }
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <typename T, int NMOD, typename I>
void launch_indexed(const T* x, T* out, const float* g0, const float* b0, const float* g1,
                    const float* b1, I n, I hwc, I C, float slope, bool vec,
                    cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    fused_affine_vec<T, NMOD, I><<<grid_for(n / VEC), kThreads, 0, stream>>>(
        x, out, g0, b0, g1, b1, n / VEC, hwc, C, slope);
  } else {
    fused_affine_scalar<T, NMOD, I><<<grid_for(n), kThreads, 0, stream>>>(
        x, out, g0, b0, g1, b1, n, hwc, C, slope);
  }
}

template <typename T, int NMOD>
void launch(const void* x, void* out, const float* g0, const float* b0, const float* g1,
            const float* b1, int64_t B, int64_t HW, int64_t C, float slope,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t n = B * HW * C;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  bool vec = C % VEC == 0;
  for (const void* p : {x, static_cast<const void*>(out), static_cast<const void*>(g0),
                        static_cast<const void*>(b0), static_cast<const void*>(g1),
                        static_cast<const void*>(b1)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  // 32-bit indices need headroom for the grid-stride step past the end.
  if (n + static_cast<int64_t>(kThreads) * grid_for(n) < (int64_t{1} << 32)) {
    launch_indexed<T, NMOD, uint32_t>(xt, ot, g0, b0, g1, b1, static_cast<uint32_t>(n),
                                      static_cast<uint32_t>(HW * C),
                                      static_cast<uint32_t>(C), slope, vec, stream);
  } else {
    launch_indexed<T, NMOD, int64_t>(xt, ot, g0, b0, g1, b1, n, HW * C, C, slope, vec,
                                     stream);
  }
}

constexpr int kBwdCols = 32;  // channels per block: one warp-wide row
constexpr int kBwdRows = 8;   // pixels walked in parallel: one per warp

template <typename T, int NMOD>
__global__ void __launch_bounds__(kBwdCols * kBwdRows)
fused_affine_bwd(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                 const float* __restrict__ g0, const float* __restrict__ b0,
                 const float* __restrict__ g1, const float* __restrict__ b1,
                 float* __restrict__ dg0, float* __restrict__ db0, float* __restrict__ dg1,
                 float* __restrict__ db1, int64_t HW, int64_t C, int64_t pix_per_block,
                 float slope) {
  __shared__ float red[4][kBwdRows][kBwdCols];
  const int64_t c = int64_t(blockIdx.x) * kBwdCols + threadIdx.x;
  const int64_t b = blockIdx.z;
  const int64_t p0 = int64_t(blockIdx.y) * pix_per_block;
  const int64_t p1 = p0 + pix_per_block < HW ? p0 + pix_per_block : HW;
  float s_g0 = 0.f, s_b0 = 0.f, s_g1 = 0.f, s_b1 = 0.f;
  if (c < C) {
    const int64_t m = b * C + c;
    const float gg0 = g0[m], bb0 = b0[m];
    const float gg1 = NMOD == 2 ? g1[m] : 0.f, bb1 = NMOD == 2 ? b1[m] : 0.f;
    for (int64_t p = p0 + threadIdx.y; p < p1; p += kBwdRows) {
      const int64_t e = (b * HW + p) * C + c;
      const float xv = to_f(x[e]);
      float da0 = to_f(dy[e]);
      const float y0 = affine_rn(gg0, xv, bb0);
      if constexpr (NMOD == 2) {
        const float a0 = lrelu(y0, slope);
        const float d1 = affine_rn(gg1, a0, bb1) >= 0.f ? da0 : slope * da0;
        s_g1 = fmaf(d1, a0, s_g1);
        s_b1 += d1;
        da0 = d1 * gg1;
      }
      const float d0 = y0 >= 0.f ? da0 : slope * da0;
      s_g0 = fmaf(d0, xv, s_g0);
      s_b0 += d0;
      dx[e] = from_f<T>(d0 * gg0);
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s_g0;
  red[1][threadIdx.y][threadIdx.x] = s_b0;
  red[2][threadIdx.y][threadIdx.x] = s_g1;
  red[3][threadIdx.y][threadIdx.x] = s_b1;
  __syncthreads();
  if (threadIdx.y < 2 * NMOD && c < C) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) acc += red[threadIdx.y][r][threadIdx.x];
    float* dst[4] = {dg0, db0, dg1, db1};
    atomicAdd(dst[threadIdx.y] + b * C + c, acc);
  }
}

template <typename T, int NMOD>
void launch_bwd(const void* x, const void* dy, void* dx, const float* g0, const float* b0,
                const float* g1, const float* b1, float* dg0, float* db0, float* dg1,
                float* db1, int64_t B, int64_t HW, int64_t C, float slope,
                cudaStream_t stream) {
  static int target = 0;  // blocks that fill the card: 8 resident per SM
  if (target == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    target = sms * 8;
  }
  const int64_t ctiles = (C + kBwdCols - 1) / kBwdCols;
  int64_t chunks = (target + B * ctiles - 1) / (B * ctiles);
  int64_t ppb = (HW + chunks - 1) / chunks;
  ppb = (ppb + kBwdRows - 1) / kBwdRows * kBwdRows;
  chunks = (HW + ppb - 1) / ppb;
  dim3 grid(static_cast<unsigned>(ctiles), static_cast<unsigned>(chunks),
            static_cast<unsigned>(B));
  dim3 block(kBwdCols, kBwdRows);
  fused_affine_bwd<T, NMOD><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), g0, b0, g1, b1,
      dg0, db0, dg1, db1, HW, C, ppb, slope);
}

}  // namespace

extern "C" int xmc_fused_affine_bwd(const void* x, const void* dy, void* dx, const void* g0,
                                    const void* b0, const void* g1, const void* b1, void* dg0,
                                    void* db0, void* dg1, void* db1, int64_t B, int64_t HW,
                                    int64_t C, int nmod, int dtype, float slope,
                                    void* stream) {
  if (B * HW * C == 0) return 0;
  if (nmod != 1 && nmod != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.z
  const float* f[4] = {static_cast<const float*>(g0), static_cast<const float*>(b0),
                       static_cast<const float*>(g1), static_cast<const float*>(b1)};
  float* o[4] = {static_cast<float*>(dg0), static_cast<float*>(db0), static_cast<float*>(dg1),
                 static_cast<float*>(db1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XMC_FA_BWD(T, N)                                                                \
  launch_bwd<T, N>(x, dy, dx, f[0], f[1], f[2], f[3], o[0], o[1], o[2], o[3], B, HW, C, \
                   slope, s)
  if (dtype == 0) {
    if (nmod == 1) XMC_FA_BWD(float, 1); else XMC_FA_BWD(float, 2);
  } else if (dtype == 1) {
    if (nmod == 1) XMC_FA_BWD(__nv_bfloat16, 1); else XMC_FA_BWD(__nv_bfloat16, 2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XMC_FA_BWD
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xmc_fused_affine(const void* x, void* out, const void* g0, const void* b0,
                                const void* g1, const void* b1, int64_t B, int64_t HW,
                                int64_t C, int nmod, int dtype, float slope, void* stream) {
  if (B * HW * C == 0) return 0;
  const float* fg0 = static_cast<const float*>(g0);
  const float* fb0 = static_cast<const float*>(b0);
  const float* fg1 = static_cast<const float*>(g1);
  const float* fb1 = static_cast<const float*>(b1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nmod != 1 && nmod != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (nmod == 1) launch<float, 1>(x, out, fg0, fb0, fg1, fb1, B, HW, C, slope, s);
    else launch<float, 2>(x, out, fg0, fb0, fg1, fb1, B, HW, C, slope, s);
  } else if (dtype == 1) {
    if (nmod == 1) launch<__nv_bfloat16, 1>(x, out, fg0, fb0, fg1, fb1, B, HW, C, slope, s);
    else launch<__nv_bfloat16, 2>(x, out, fg0, fb0, fg1, fb1, B, HW, C, slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
