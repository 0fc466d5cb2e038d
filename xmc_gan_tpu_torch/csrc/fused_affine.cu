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
// C interface (bound with ctypes, pointers and stream as void*):
//   int xmc_fused_affine(x, out, g0, b0, g1, b1, B, HW, C, nmod, dtype, slope, stream)
//   dtype 0 = fp32, 1 = bf16; g1/b1 are ignored when nmod == 1.
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

}  // namespace

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
