// Fused text-conditioned modulation epilogue for Hopper (sm_90a).
//
// Replaces the Pallas kernels of xmc_gan_tpu/ops/pallas/fused_affine.py:
//   modulate_lrelu_pallas         (NMOD = 1)  lrelu(g0 * x + b0)
//   double_modulate_lrelu_pallas  (NMOD = 2)  lrelu(g1 * lrelu(g0 * x + b0) + b1)
// over a channels_last activation, memory order [B, H*W, C], with the
// modulation vectors g*/b* given as [B, C] (fp32 to the forward; fp32 or
// bf16 to the backward).  Math is fp32; the result is
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
// db1 = dy1) into one zeroed fp32 buffer [2 * NMOD, B, C].  LeakyReLU's
// derivative at 0 is 1, as jnp.where(y >= 0, ...) gives it.  The [B, C]
// vectors are read in their own type V (fp32 or bf16), so the caller casts
// nothing before the launch.  Bound: bytes (x and dy read once, dx written
// once: 1.5x the forward's traffic, 6 bytes an element in bf16).  What
// held the first design (one element a thread, 32 channels x 8 pixels a
// block) at half the card's bandwidth in bf16: a warp load carried 64
// bytes, so 8 resident blocks kept ~8 KB in flight an SM where ~18 KB is
// needed at ~700 ns of DRAM latency, and each element paid a 64-bit index.
// fused_affine_bwd_vec answers both: 16 bytes a thread and array, four
// steps' loads issued before the first use (~64 KB in flight an SM at two
// blocks of 256 threads), pointer increments in place of index arithmetic,
// each thread on one fixed channel chunk so its vector values and sums stay
// in registers.  Each block adds its sums with one fp32 atomicAdd a value
// and channel; the order of those adds varies from run to run (fp32 sums,
// not bit-reproducible).  fused_affine_bwd_scalar (one element a thread)
// takes every other C and alignment.  Which of the two runs, and its grid,
// is the caller's plan (ops/cuda/fused_affine.py plan_bwd); the C entry
// refuses a launch that the named kernel does not take.
//
// Double backward of the single form (NMOD = 1; the Pallas kernel has none,
// and JAX autodiffs its plain epilogue: it replaces no Pallas kernel).  The
// concept discriminator (CONCEPT_NETD) runs the epilogue inside D, and MAGP
// differentiates D's input gradient, so the first backward's outputs
// (dx, dg0, db0) are differentiated again.  With s = 1 where
// g0*x + b0 >= 0 (affine_rn, as the backward branches) and slope elsewhere,
// and the gradients (gx, gg, gb) arriving at (dx, dg0, db0):
//   g_dy = s * (g0*gx + gg*x + gb)      written, x's type
//   g_x  = s * dy * gg                  written, x's type
//   g_g0 = sum over H*W of s * dy * gx  one fp32 sum a (b, c)
//   g_b0 = 0                            s is piecewise constant
// Rounding: fp32 math, each product rounded before its add (__fmul_rn,
// __fadd_rn: the plain version's order), g_dy and g_x rounded once on store
// to x's type, the sums in fp32 and cast once by the caller.  Bound: bytes
// (x, dy, gx read once, g_dy and g_x written once: 5 activation passes
// against the backward's 3).  fused_affine_bwd2_vec keeps the backward's
// design: 16 bytes a thread and array, kBwd2Unroll steps' loads issued
// before the first use (2, not the backward's 4: three arrays a step, 96
// bytes in flight a thread, keep the registers within the 128 that two
// blocks of 256 threads leave each), each thread on one fixed channel chunk
// with its four vector values and VEC sums in registers, one shared-memory
// reduction a block and one fp32 atomicAdd a (b, c).  It is the only
// double-backward kernel: the caller plans it with plan_bwd, as the
// backward, and refuses a shape or alignment that plan names the scalar
// kernel for (C not a multiple of the 16-byte width, or a pointer not
// 16-byte aligned); CONCEPT_NETD's C = 128 and fresh tensors never are.
//
// C interface (bound with ctypes, pointers and stream as void*):
//   int xmc_fused_affine(x, out, g0, b0, g1, b1, B, HW, C, nmod, dtype, slope, stream)
//   int xmc_fused_affine_bwd(x, dy, dx, g0, b0, g1, b1, sums, B, HW, C, nmod, dtype,
//                            vdtype, slope, kernel, threads, chunks, run, stream)
//   dtype (x's) and vdtype (the vectors') 0 = fp32, 1 = bf16; g1/b1 are
//   ignored when nmod == 1.  sums is fp32 [2 * nmod, B, C] (dg0, db0[, dg1,
//   db1]) and must hold zeros.  kernel 0 = fused_affine_bwd_vec (grid
//   (chunks, B), threads a block), 1 = fused_affine_bwd_scalar (grid
//   (ceil(C / 32), chunks, B), 256 threads); each block walks run pixels.
//   int xmc_fused_affine_bwd2(x, dy, gx, g0, b0, gg, gb, g_dy, g_x, sums, B, HW, C,
//                             dtype, vdtype, slope, kernel, threads, chunks, run, stream)
//   x, dy, gx, g_dy, g_x in x's type; g0, b0, gg, gb [B, C] in vdtype; sums
//   fp32 [B, C], zeroed by the caller; kernel, threads, chunks and run as
//   for the backward; kernel must be 0 (fused_affine_bwd2_vec).
//   Returns cudaGetLastError() after the launch (0 = success), or
//   cudaErrorInvalidValue for a launch that the named kernel does not take.

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

// ---- backward ----

// One element of the backward chain from x and its upstream gradient da0
// (for NMOD = 2, the gradient of the second modulation's output): adds its
// terms to the thread's sums and returns dx in fp32.
template <int NMOD>
__device__ __forceinline__ float bwd_elem(float xv, float da0, float gg0, float bb0, float gg1,
                                          float bb1, float slope, float& s_g0, float& s_b0,
                                          float& s_g1, float& s_b1) {
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
  return d0 * gg0;
}

constexpr int kBwdThreads = 256;  // the vector kernel's widest block
constexpr int kBwdUnroll = 4;     // pixel steps whose loads issue before the first use

// 16 bytes of T as fp32 values, and back (bf16 packed in pairs: one
// conversion instruction for two values, the same rounding as one by one).
template <typename T, int VEC>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[VEC]) {
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f(t[k]);
}
template <typename T, int VEC>
__device__ __forceinline__ uint4 pack16(const float (&v)[VEC]) {
  uint4 raw;
  if constexpr (sizeof(T) == 4) {
    raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                     __float_as_uint(v[3]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  return raw;
}

// The backward over 16-byte vectors: VEC = 16 / sizeof(T) channels of one
// pixel a thread and step.  Precondition (checked by the C entry): C % VEC
// == 0, L = C / VEC chunks a pixel with blockDim.x a multiple of L and at
// most kBwdThreads, x, dy and dx 16-byte aligned.  A block owns image
// blockIdx.y and the pixels [blockIdx.x * run, + run) of it; thread t takes
// chunk t % L of pixels t / L, + P, + 2P, ... (P = blockDim.x / L, so
// neighbouring threads read neighbouring 16 bytes and a block-wide step
// reads P whole pixels).  Its channels never change, so its [B, C] vector
// values (read once, in V) and its 2 * NMOD * VEC fp32 sums stay in
// registers.  kBwdUnroll steps' loads of x and dy issue before the first
// use: 4 x 32 bytes in flight a thread.  At the end the block sums each
// (value, channel) over its P rows in shared memory and adds it to
// sums[value][b][c] with one fp32 atomicAdd, consecutive threads on
// consecutive channels.
template <typename T, typename V, int NMOD>
__global__ void __launch_bounds__(kBwdThreads, 2)
fused_affine_bwd_vec(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                     const V* __restrict__ g0, const V* __restrict__ b0,
                     const V* __restrict__ g1, const V* __restrict__ b1,
                     float* __restrict__ sums, int B, int HW, int C, int run, float slope) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KV = 2 * NMOD * VEC;  // the sums a thread keeps
  constexpr int PAD = KV + 1;         // odd: a warp's shared-memory stores hit 32 banks
  __shared__ float red[kBwdThreads * PAD];
  const int L = C / VEC;
  const int P = blockDim.x / L;
  const int row = threadIdx.x / L;
  const int j = threadIdx.x - row * L;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * run;
  const int p1 = min(p0 + run, HW);
  float gg0[VEC], bb0[VEC], gg1[VEC], bb1[VEC];
  float s_g0[VEC], s_b0[VEC], s_g1[VEC], s_b1[VEC];
  const size_t m = size_t(b) * C + size_t(j) * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gg0[k] = to_f(g0[m + k]);
    bb0[k] = to_f(b0[m + k]);
    gg1[k] = NMOD == 2 ? to_f(g1[m + k]) : 0.f;
    bb1[k] = NMOD == 2 ? to_f(b1[m + k]) : 0.f;
    s_g0[k] = s_b0[k] = s_g1[k] = s_b1[k] = 0.f;
  }
  const size_t step = size_t(P) * C;  // elements between a thread's pixels
  size_t off = (size_t(b) * HW + p0 + row) * C + size_t(j) * VEC;
  for (int p = p0 + row; p < p1; p += kBwdUnroll * P, off += kBwdUnroll * step) {
    uint4 xr[kBwdUnroll], dr[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (p + u * P < p1) {
        xr[u] = __ldg(reinterpret_cast<const uint4*>(x + off + u * step));
        dr[u] = __ldg(reinterpret_cast<const uint4*>(dy + off + u * step));
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (p + u * P < p1) {
        float xv[VEC], dv[VEC];
        unpack16<T>(xr[u], xv);
        unpack16<T>(dr[u], dv);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          xv[k] = bwd_elem<NMOD>(xv[k], dv[k], gg0[k], bb0[k], gg1[k], bb1[k], slope, s_g0[k],
                                 s_b0[k], s_g1[k], s_b1[k]);
        *reinterpret_cast<uint4*>(dx + off + u * step) = pack16<T>(xv);
      }
    }
  }
  float* mine = red + threadIdx.x * PAD;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mine[k] = s_g0[k];
    mine[VEC + k] = s_b0[k];
    if constexpr (NMOD == 2) {
      mine[2 * VEC + k] = s_g1[k];
      mine[3 * VEC + k] = s_b1[k];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * NMOD * C; o += blockDim.x) {
    const int v = o / C, c = o - v * C;  // value (dg0, db0, dg1, db1) and channel
    const float* col = red + (c / VEC) * PAD + v * VEC + c % VEC;
    float acc = 0.f;
    for (int r = 0; r < P; ++r) acc += col[r * L * PAD];
    atomicAdd(sums + (size_t(v) * B + b) * C + c, acc);
  }
}

// One element a thread and step: any C, any alignment.  A block owns (image
// b = blockIdx.z, 32 channels, a run of pixels) as 32 x 8 threads: a warp
// reads 32 consecutive channels of one pixel, the 8 warps walk the pixels;
// the sums are reduced over the warps in shared memory and added with one
// atomicAdd a block, value and channel.
constexpr int kBwdCols = 32;
constexpr int kBwdRows = 8;

template <typename T, typename V, int NMOD>
__global__ void __launch_bounds__(kBwdCols * kBwdRows)
fused_affine_bwd_scalar(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                        const V* __restrict__ g0, const V* __restrict__ b0,
                        const V* __restrict__ g1, const V* __restrict__ b1,
                        float* __restrict__ sums, int64_t B, int64_t HW, int64_t C,
                        int64_t run, float slope) {
  __shared__ float red[4][kBwdRows][kBwdCols];
  const int64_t c = int64_t(blockIdx.x) * kBwdCols + threadIdx.x;
  const int64_t b = blockIdx.z;
  const int64_t p0 = int64_t(blockIdx.y) * run;
  const int64_t p1 = p0 + run < HW ? p0 + run : HW;
  float s_g0 = 0.f, s_b0 = 0.f, s_g1 = 0.f, s_b1 = 0.f;
  if (c < C) {
    const int64_t m = b * C + c;
    const float gg0 = to_f(g0[m]), bb0 = to_f(b0[m]);
    const float gg1 = NMOD == 2 ? to_f(g1[m]) : 0.f, bb1 = NMOD == 2 ? to_f(b1[m]) : 0.f;
    for (int64_t p = p0 + threadIdx.y; p < p1; p += kBwdRows) {
      const int64_t e = (b * HW + p) * C + c;
      dx[e] = from_f<T>(bwd_elem<NMOD>(to_f(x[e]), to_f(dy[e]), gg0, bb0, gg1, bb1, slope,
                                       s_g0, s_b0, s_g1, s_b1));
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
    atomicAdd(sums + (threadIdx.y * B + b) * C + c, acc);
  }
}

enum BwdKernel { kBwdVec = 0, kBwdScalar = 1 };

// The launch the plan named, or cudaErrorInvalidValue where the named kernel
// does not take it (nothing runs then).
template <typename T, typename V, int NMOD>
int launch_bwd(const void* x, const void* dy, void* dx, const void* const* vecs, float* sums,
               int64_t B, int64_t HW, int64_t C, float slope, int kernel, int threads,
               int64_t chunks, int64_t run, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const V* v[4];
  for (int i = 0; i < 4; ++i) v[i] = static_cast<const V*>(vecs[i]);
  if (kernel == kBwdVec) {
    constexpr int VEC = 16 / sizeof(T);
    const int64_t L = C / VEC;
    // pixel indices run up to chunks * run plus a loop turn's steps, in int
    bool ok = C % VEC == 0 && threads >= L && threads <= kBwdThreads && threads % L == 0 &&
              chunks * run + int64_t(kBwdUnroll) * threads < INT32_MAX && C <= INT32_MAX;
    for (const void* p : {x, dy, static_cast<const void*>(dx)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    fused_affine_bwd_vec<T, V, NMOD><<<dim3(unsigned(chunks), unsigned(B)), threads, 0, stream>>>(
        xt, dyt, dxt, v[0], v[1], v[2], v[3], sums, int(B), int(HW), int(C), int(run), slope);
  } else if (kernel == kBwdScalar) {
    const int64_t ctiles = (C + kBwdCols - 1) / kBwdCols;
    if (threads != kBwdCols * kBwdRows || chunks > 65535 || ctiles > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    fused_affine_bwd_scalar<T, V, NMOD>
        <<<dim3(unsigned(ctiles), unsigned(chunks), unsigned(B)), dim3(kBwdCols, kBwdRows), 0,
           stream>>>(xt, dyt, dxt, v[0], v[1], v[2], v[3], sums, B, HW, C, run, slope);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename V>
int launch_bwd_nmod(int nmod, const void* x, const void* dy, void* dx, const void* const* vecs,
                    float* sums, int64_t B, int64_t HW, int64_t C, float slope, int kernel,
                    int threads, int64_t chunks, int64_t run, cudaStream_t stream) {
  if (nmod == 1)
    return launch_bwd<T, V, 1>(x, dy, dx, vecs, sums, B, HW, C, slope, kernel, threads, chunks,
                               run, stream);
  return launch_bwd<T, V, 2>(x, dy, dx, vecs, sums, B, HW, C, slope, kernel, threads, chunks,
                             run, stream);
}

// ---- double backward of the single form ----

// One element: writes g_dy and g_x (fp32) and adds s * dy * gx to the sum.
__device__ __forceinline__ void bwd2_elem(float xv, float dyv, float gxv, float gg0, float bb0,
                                          float ag, float ab, float slope, float& g_dy,
                                          float& g_x, float& s_g) {
  const bool pos = affine_rn(gg0, xv, bb0) >= 0.f;
  const float d = pos ? dyv : __fmul_rn(slope, dyv);  // s * dy
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(gg0, gxv), __fmul_rn(ag, xv)), ab);
  g_dy = pos ? a : __fmul_rn(slope, a);
  g_x = __fmul_rn(d, ag);
  s_g = fmaf(d, gxv, s_g);
}

constexpr int kBwd2Unroll = 2;  // pixel steps whose loads issue before the first use

// The vector kernel: fused_affine_bwd_vec's layout (see there) with three
// arrays read and two written.  Precondition (checked by the C entry): C %
// VEC == 0, blockDim.x a multiple of L = C / VEC and at most kBwdThreads,
// x, dy, gx, g_dy and g_x 16-byte aligned.
template <typename T, typename V>
__global__ void __launch_bounds__(kBwdThreads, 2)
fused_affine_bwd2_vec(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ gx, const V* __restrict__ g0,
                      const V* __restrict__ b0, const V* __restrict__ gg,
                      const V* __restrict__ gb, T* __restrict__ g_dy, T* __restrict__ g_x,
                      float* __restrict__ sums, int HW, int C, int run, float slope) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PAD = VEC + 1;  // odd: a warp's shared-memory stores hit 32 banks
  __shared__ float red[kBwdThreads * PAD];
  const int L = C / VEC;
  const int P = blockDim.x / L;
  const int row = threadIdx.x / L;
  const int j = threadIdx.x - row * L;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * run;
  const int p1 = min(p0 + run, HW);
  float gg0[VEC], bb0[VEC], ag[VEC], ab[VEC], s_g[VEC];
  const size_t m = size_t(b) * C + size_t(j) * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gg0[k] = to_f(g0[m + k]);
    bb0[k] = to_f(b0[m + k]);
    ag[k] = to_f(gg[m + k]);
    ab[k] = to_f(gb[m + k]);
    s_g[k] = 0.f;
  }
  const size_t step = size_t(P) * C;
  size_t off = (size_t(b) * HW + p0 + row) * C + size_t(j) * VEC;
  for (int p = p0 + row; p < p1; p += kBwd2Unroll * P, off += kBwd2Unroll * step) {
    uint4 xr[kBwd2Unroll], dr[kBwd2Unroll], gr[kBwd2Unroll];
#pragma unroll
    for (int u = 0; u < kBwd2Unroll; ++u) {
      if (p + u * P < p1) {
        xr[u] = __ldg(reinterpret_cast<const uint4*>(x + off + u * step));
        dr[u] = __ldg(reinterpret_cast<const uint4*>(dy + off + u * step));
        gr[u] = __ldg(reinterpret_cast<const uint4*>(gx + off + u * step));
      }
    }
#pragma unroll
    for (int u = 0; u < kBwd2Unroll; ++u) {
      if (p + u * P < p1) {
        float xv[VEC], dv[VEC], gv[VEC], o_dy[VEC], o_x[VEC];
        unpack16<T>(xr[u], xv);
        unpack16<T>(dr[u], dv);
        unpack16<T>(gr[u], gv);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          bwd2_elem(xv[k], dv[k], gv[k], gg0[k], bb0[k], ag[k], ab[k], slope, o_dy[k], o_x[k],
                    s_g[k]);
        *reinterpret_cast<uint4*>(g_dy + off + u * step) = pack16<T>(o_dy);
        *reinterpret_cast<uint4*>(g_x + off + u * step) = pack16<T>(o_x);
      }
    }
  }
  float* mine = red + threadIdx.x * PAD;
#pragma unroll
  for (int k = 0; k < VEC; ++k) mine[k] = s_g[k];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* col = red + (c / VEC) * PAD + c % VEC;
    float acc = 0.f;
    for (int r = 0; r < P; ++r) acc += col[r * L * PAD];
    atomicAdd(sums + size_t(b) * C + c, acc);
  }
}

template <typename T, typename V>
int launch_bwd2(const void* x, const void* dy, const void* gx, const void* const* vecs,
                void* g_dy, void* g_x, float* sums, int64_t B, int64_t HW, int64_t C,
                float slope, int kernel, int threads, int64_t chunks, int64_t run,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* gxt = static_cast<const T*>(gx);
  T* gdyt = static_cast<T*>(g_dy);
  T* gxo = static_cast<T*>(g_x);
  const V* v[4];
  for (int i = 0; i < 4; ++i) v[i] = static_cast<const V*>(vecs[i]);
  if (kernel == kBwdVec) {
    constexpr int VEC = 16 / sizeof(T);
    const int64_t L = C / VEC;
    bool ok = C % VEC == 0 && threads >= L && threads <= kBwdThreads && threads % L == 0 &&
              chunks * run + int64_t(kBwd2Unroll) * threads < INT32_MAX && C <= INT32_MAX;
    for (const void* p : {x, dy, gx, static_cast<const void*>(g_dy),
                          static_cast<const void*>(g_x)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    fused_affine_bwd2_vec<T, V><<<dim3(unsigned(chunks), unsigned(B)), threads, 0, stream>>>(
        xt, dyt, gxt, v[0], v[1], v[2], v[3], gdyt, gxo, sums, int(HW), int(C), int(run), slope);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xmc_fused_affine_bwd2(const void* x, const void* dy, const void* gx,
                                     const void* g0, const void* b0, const void* gg,
                                     const void* gb, void* g_dy, void* g_x, void* sums,
                                     int64_t B, int64_t HW, int64_t C, int dtype, int vdtype,
                                     float slope, int kernel, int threads, int64_t chunks,
                                     int64_t run, void* stream) {
  if (B < 1 || HW < 1 || C < 1 || B > 65535 || chunks < 1 || run < 1 || chunks * run < HW ||
      (dtype != 0 && dtype != 1) || (vdtype != 0 && vdtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* vecs[4] = {g0, b0, gg, gb};
  float* s = static_cast<float*>(sums);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XMC_FA_BWD2(T, V) \
  launch_bwd2<T, V>(x, dy, gx, vecs, g_dy, g_x, s, B, HW, C, slope, kernel, threads, chunks, \
                    run, st)
  if (dtype == 0)
    return vdtype == 0 ? XMC_FA_BWD2(float, float) : XMC_FA_BWD2(float, __nv_bfloat16);
  return vdtype == 0 ? XMC_FA_BWD2(__nv_bfloat16, float)
                     : XMC_FA_BWD2(__nv_bfloat16, __nv_bfloat16);
#undef XMC_FA_BWD2
}

extern "C" int xmc_fused_affine_bwd(const void* x, const void* dy, void* dx, const void* g0,
                                    const void* b0, const void* g1, const void* b1, void* sums,
                                    int64_t B, int64_t HW, int64_t C, int nmod, int dtype,
                                    int vdtype, float slope, int kernel, int threads,
                                    int64_t chunks, int64_t run, void* stream) {
  if (B < 1 || HW < 1 || C < 1 || B > 65535 || chunks < 1 || run < 1 || chunks * run < HW ||
      (nmod != 1 && nmod != 2) || (dtype != 0 && dtype != 1) || (vdtype != 0 && vdtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* vecs[4] = {g0, b0, g1, b1};
  float* s = static_cast<float*>(sums);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XMC_FA_BWD(T, V) \
  launch_bwd_nmod<T, V>(nmod, x, dy, dx, vecs, s, B, HW, C, slope, kernel, threads, chunks, run, st)
  if (dtype == 0)
    return vdtype == 0 ? XMC_FA_BWD(float, float) : XMC_FA_BWD(float, __nv_bfloat16);
  return vdtype == 0 ? XMC_FA_BWD(__nv_bfloat16, float)
                     : XMC_FA_BWD(__nv_bfloat16, __nv_bfloat16);
#undef XMC_FA_BWD
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
