// Pairwise word-region (DAMSM) matching scores for Hopper (sm_90a): forward,
// d_regions and d_words.
//
// Replaces the Pallas kernels of xmc_gan_tpu/ops/pallas/damsm_score.py:
//   _fwd_kernel      (pallas_call :314)  scores [B, Bc]
//   _bwd_dr_kernel   (pallas_call :343)  d_regions [B, R, D], summed over captions
//   _bwd_dw_kernel   (pallas_call :362)  d_words [Bc, T, D], summed over images
// On l2-normalized regions r [B, R, D] and words w [Bc, T, D] (fp32 or bf16
// storage; the operand type of the products) and mask [Bc, T] (uint8, 1 =
// padded word), for image i and caption j:
//   sim = w_j r_i^T [T, R]; a = softmax_R(g1 * sim); c = a r_i [T, D]
//   c_hat = c / max(|c|, 1e-12); rel = sum_D rnd(c_hat) * w_j
//   score = logsumexp_T(padded ? -1e30 : g2 * rel) / g2
// where rnd() rounds to bf16 on the bf16 path (also a before the c product
// and aT d_c, and the cotangents d c_hat and d a, as autograd of the plain
// version rounds them); sums and everything else are fp32.
//
// This is attention with queries = the T words of a caption and keys =
// values = the R regions of an image, over all B x Bc pairs.  Bound:
// operations (2*T*R*D per product: 2 products forward, 5 for d_regions, 4
// for d_words; 86 / 215 / 172 GFLOP at B = Bc = 128, T = 20, R = D = 256),
// against 67 TFLOP/s fp32 on the CUDA cores this kernel uses (989 TFLOP/s
// bf16 would need the tensor cores: a later step).  Design for a first,
// simple and correct version:
//  * A block takes one image and a sub-block of vb captions (vb*T <= 64 word
//    rows), keeps the words, the [rows, R] similarity/attention (and, in the
//    backward, its cotangent) and the [rows, D] context in shared memory,
//    and streams the image's regions through a 32-row shared tile, three or
//    four times per sub-block (the regions of one image, 256 KB in fp32, do
//    not fit in the 227 KB a block can have).  vb is the largest that fits:
//    3 captions forward, 2 backward at T = 20, D = R = 256.
//  * Products are register-tiled: a warp owns rows, a lane owns a region or
//    a feature column; the shared-memory operand that all lanes share is a
//    16-byte broadcast, so each shared load feeds 4 to 8 FMAs.
//  * d_regions sums over captions and d_words over images.  Each block owns
//    one split of that axis and accumulates its part in an exclusive slice
//    of an fp32 scratch buffer with plain read-modify-write (no atomics);
//    a second kernel sums the splits in a fixed order.  The result is
//    deterministic, run to run.
// The kernels allocate nothing and launch on the caller's stream.
//
// C interface (ctypes; pointers and the stream as void*):
//   int xmc_damsm_fwd(r, w, mask, out, B, Bc, R, T, D, vb, g1, g2, dtype, stream)
//   int xmc_damsm_bwd_dr(r, w, mask, g, partial, dr, B, Bc, R, T, D, vb, nsplit,
//                        g1, g2, dtype, stream)
//   int xmc_damsm_bwd_dw(r, w, mask, g, partial, dw, B, Bc, R, T, D, vb, nsplit,
//                        g1, g2, dtype, stream)
//   g is the upstream cotangent [B, Bc] fp32.  partial is [B, nsplit, R, D]
//   (d_regions) or [nsplit, Bc, T, D] (d_words) fp32 scratch; with
//   nsplit == 1 it may be the output itself.  dtype 0 = fp32, 1 = bf16.
//   Returns cudaGetLastError() after the launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RT = 32;         // region rows per staged tile (one per lane)
constexpr int MAX_ROWS = 64;   // word rows per block: 8 warps x MB rows
constexpr int MAX_DP = 256;    // padded feature width: 8 columns per lane
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Dims {
  int B, Bc, R, T, D;
  int vb, M;       // captions per block, word rows per block (vb * T)
  int Dp, SD;      // padded feature width (multiple of 8) = row stride of W/C
  int SR;          // row stride of S/DA: R padded to a whole number of tiles
  int SB;          // row stride of the region tile: Dp + 4 (conflict-free float4)
  float g1, g2;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

Dims make_dims(int B, int Bc, int R, int T, int D, int vb, float g1, float g2) {
  Dims d;
  d.B = B; d.Bc = Bc; d.R = R; d.T = T; d.D = D;
  d.vb = vb; d.M = vb * T;
  d.Dp = round_up(D, 8); d.SD = d.Dp;
  d.SR = round_up(R, RT);
  d.SB = d.Dp + 4;
  d.g1 = g1; d.g2 = g2;
  return d;
}

size_t smem_bytes(const Dims& d, bool backward) {
  return sizeof(float) * (size_t(d.M) * (2 * d.SD + (backward ? 2 : 1) * d.SR + 4) +
                          size_t(RT) * d.SB);
}

// Shared memory of one block, carved from the dynamic allocation.
struct Smem {
  float* W;    // [M][SD]  words of the sub-block (rounded to the operand type)
  float* C;    // [M][SD]  context c -> c_hat -> d_c
  float* S;    // [M][SR]  sim -> a (fp32)
  float* DA;   // [M][SR]  d a -> d sim (backward only)
  float* Rt;   // [RT][SB] staged region rows
  float* nrm;  // [M] max(|c|, 1e-12)
  float* rel;  // [M]
  float* drel; // [M]
  float* tmp;  // [M]
};

__device__ Smem carve(float* base, const Dims& d, bool backward) {
  Smem s;
  s.W = base;
  s.C = s.W + d.M * d.SD;
  s.S = s.C + d.M * d.SD;
  s.DA = s.S + d.M * d.SR;
  s.Rt = s.DA + (backward ? d.M * d.SR : 0);
  s.nrm = s.Rt + RT * d.SB;
  s.rel = s.nrm + d.M;
  s.drel = s.rel + d.M;
  s.tmp = s.drel + d.M;
  return s;
}

// Words of captions j0 .. j0+vb-1 into W (rows past Bc and columns past D are 0).
template <typename T>
__device__ void load_words(const T* __restrict__ w, int j0, const Dims& d, float* W) {
  for (int e = threadIdx.x; e < d.M * d.Dp; e += kThreads) {
    const int m = e / d.Dp, k = e % d.Dp;
    const int j = j0 + m / d.T, t = m % d.T;
    W[m * d.SD + k] = (j < d.Bc && k < d.D) ? to_f(w[(size_t(j) * d.T + t) * d.D + k]) : 0.f;
  }
}

// Region rows r0 .. r0+RT-1 of image i into Rt (rows past R and columns past D are 0).
template <typename T>
__device__ void load_tile(const T* __restrict__ r, int i, int r0, const Dims& d, float* Rt) {
  for (int e = threadIdx.x; e < RT * d.Dp; e += kThreads) {
    const int n = e / d.Dp, k = e % d.Dp;
    const int rr = r0 + n;
    Rt[n * d.SB + k] = (rr < d.R && k < d.D) ? to_f(r[(size_t(i) * d.R + rr) * d.D + k]) : 0.f;
  }
}

// out[m][r0 + lane] = (rnd?) sum_k A[m][k] * Rt[lane][k]   (rows m of this warp)
template <int MB, bool BF16, bool ROUND_OUT>
__device__ void gemm_nt(const float* A, const float* Rt, float* out, int r0, const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) acc[i] = 0.f;
  for (int k = 0; k < d.Dp; k += 4) {
    const float4 b = *reinterpret_cast<const float4*>(Rt + lane * d.SB + k);
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int m = warp + kWarps * i;
      if (m < d.M) {
        const float4 a = *reinterpret_cast<const float4*>(A + m * d.SD + k);
        acc[i] = fmaf(a.x, b.x, acc[i]);
        acc[i] = fmaf(a.y, b.y, acc[i]);
        acc[i] = fmaf(a.z, b.z, acc[i]);
        acc[i] = fmaf(a.w, b.w, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int m = warp + kWarps * i;
    if (m < d.M) out[m * d.SR + r0 + lane] = ROUND_OUT ? rnd<BF16>(acc[i]) : acc[i];
  }
}

// acc[i][jj] += sum_{n < RT} rnd?(P[m][r0 + n]) * Rt[n][lane + 32 jj]   (m = warp + 8 i)
template <int MB, bool BF16, bool ROUND_P>
__device__ void gemm_nn_tile(float (&acc)[MB][8], const float* P, int r0, const float* Rt,
                             const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = 0; n < RT; n += 4) {
    float b[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int k = lane + 32 * jj;
        b[q][jj] = k < d.Dp ? Rt[(n + q) * d.SB + k] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int m = warp + kWarps * i;
      if (m < d.M) {
        float4 p = *reinterpret_cast<const float4*>(P + m * d.SR + r0 + n);
        if (ROUND_P) {
          p.x = rnd<BF16>(p.x); p.y = rnd<BF16>(p.y);
          p.z = rnd<BF16>(p.z); p.w = rnd<BF16>(p.w);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          acc[i][jj] = fmaf(p.x, b[0][jj], acc[i][jj]);
          acc[i][jj] = fmaf(p.y, b[1][jj], acc[i][jj]);
          acc[i][jj] = fmaf(p.z, b[2][jj], acc[i][jj]);
          acc[i][jj] = fmaf(p.w, b[3][jj], acc[i][jj]);
        }
      }
    }
  }
}

// a = softmax_R(g1 * sim) per row, in place in S; padded columns set to 0.
__device__ void softmax_rows(float* S, const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < d.M; m += kWarps) {
    float* row = S + m * d.SR;
    float mx = -INFINITY;
    for (int r = lane; r < d.R; r += 32) mx = fmaxf(mx, d.g1 * row[r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < d.R; r += 32) {
      const float e = expf(d.g1 * row[r] - mx);
      row[r] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int r = lane; r < d.SR; r += 32) row[r] = r < d.R ? row[r] / sum : 0.f;
  }
}

// The forward of one (image, caption sub-block) pair set up to c_hat and rel:
// S holds a (fp32), C holds c_hat, nrm and rel are filled.
template <typename T, int MB, bool BF16>
__device__ void forward_chain(const T* __restrict__ r, int i, const Dims& d, const Smem& s) {
  for (int r0 = 0; r0 < d.SR; r0 += RT) {  // sim = W R^T
    __syncthreads();
    load_tile(r, i, r0, d, s.Rt);
    __syncthreads();
    gemm_nt<MB, BF16, false>(s.W, s.Rt, s.S, r0, d);
  }
  __syncthreads();
  softmax_rows(s.S, d);
  float acc[MB][8];
#pragma unroll
  for (int a = 0; a < MB; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int r0 = 0; r0 < d.SR; r0 += RT) {  // c = rnd(a) R
    __syncthreads();
    load_tile(r, i, r0, d, s.Rt);
    __syncthreads();
    gemm_nn_tile<MB, BF16, true>(acc, s.S, r0, s.Rt, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < MB; ++a) {
    const int m = warp + kWarps * a;
    if (m < d.M)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int k = lane + 32 * jj;
        if (k < d.Dp) s.C[m * d.SD + k] = acc[a][jj];
      }
  }
  __syncthreads();
  for (int m = warp; m < d.M; m += kWarps) {  // c_hat, rel
    float* c = s.C + m * d.SD;
    float sq = 0.f;
    for (int k = lane; k < d.Dp; k += 32) sq = fmaf(c[k], c[k], sq);
    const float nrm = fmaxf(sqrtf(warp_sum(sq)), 1e-12f);
    float rel = 0.f;
    for (int k = lane; k < d.Dp; k += 32) {
      const float ch = c[k] / nrm;
      c[k] = ch;
      rel = fmaf(rnd<BF16>(ch), s.W[m * d.SD + k], rel);
    }
    rel = warp_sum(rel);
    if (lane == 0) {
      s.nrm[m] = nrm;
      s.rel[m] = rel;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool padded(const uint8_t* mask, int j, int t, const Dims& d) {
  return j >= d.Bc || mask[size_t(j) * d.T + t] != 0;
}

template <typename T, int MB, bool BF16>
__global__ void __launch_bounds__(kThreads)
damsm_fwd_kernel(const T* __restrict__ r, const T* __restrict__ w,
                 const uint8_t* __restrict__ mask, float* __restrict__ out, Dims d) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(reinterpret_cast<float*>(smem_raw), d, false);
  const int i = blockIdx.x, j0 = blockIdx.y * d.vb;
  load_words(w, j0, d, s.W);
  forward_chain<T, MB, BF16>(r, i, d, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < d.vb; c += kWarps) {  // logsumexp over the words of caption j
    const int j = j0 + c;
    if (j >= d.Bc) continue;
    float mx = -INFINITY;
    for (int t = lane; t < d.T; t += 32)
      mx = fmaxf(mx, padded(mask, j, t, d) ? NEG : d.g2 * s.rel[c * d.T + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < d.T; t += 32)
      sum += expf((padded(mask, j, t, d) ? NEG : d.g2 * s.rel[c * d.T + t]) - mx);
    sum = warp_sum(sum);
    if (lane == 0) out[size_t(i) * d.Bc + j] = (mx + logf(sum)) / d.g2;
  }
}

// Backward through the chain to d_sim, for image i and captions j0.. of the
// sub-block.  On return: S = a, DA = d_sim, C = d_c, drel = d rel.
// DW_TERM: also add drel * rnd(c_hat) into the d_words slice dw_acc [dw_rows][D]
// (the rows of real captions; the others carry 0).
template <typename T, int MB, bool BF16, bool DW_TERM>
__device__ void backward_chain(const T* __restrict__ r, const uint8_t* __restrict__ mask,
                               const float* __restrict__ g, int i, int j0, const Dims& d,
                               const Smem& s, float* dw_acc, int dw_rows) {
  forward_chain<T, MB, BF16>(r, i, d, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < d.vb; c += kWarps) {  // d rel = g_ij * softmax_T, 0 where padded
    const int j = j0 + c;
    float mx = -INFINITY;
    for (int t = lane; t < d.T; t += 32)
      mx = fmaxf(mx, padded(mask, j, t, d) ? NEG : d.g2 * s.rel[c * d.T + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < d.T; t += 32)
      sum += expf((padded(mask, j, t, d) ? NEG : d.g2 * s.rel[c * d.T + t]) - mx);
    sum = warp_sum(sum);
    const float gij = j < d.Bc ? g[size_t(i) * d.Bc + j] : 0.f;
    for (int t = lane; t < d.T; t += 32) {
      const bool pad = padded(mask, j, t, d);
      s.drel[c * d.T + t] =
          pad ? 0.f : gij * (expf(d.g2 * s.rel[c * d.T + t] - mx) / sum);
    }
  }
  __syncthreads();
  for (int m = warp; m < d.M; m += kWarps) {  // d_c = (d c_hat - c_hat <c_hat, d c_hat>) / nrm
    float* c = s.C + m * d.SD;
    const float* wr = s.W + m * d.SD;
    const float dr = s.drel[m];
    float inner = 0.f;
    for (int k = lane; k < d.Dp; k += 32) inner = fmaf(c[k], rnd<BF16>(dr * wr[k]), inner);
    inner = warp_sum(inner);
    const float nrm = s.nrm[m];
    for (int k = lane; k < d.Dp; k += 32) {
      if (DW_TERM && k < d.D && m < dw_rows) dw_acc[size_t(m) * d.D + k] += dr * rnd<BF16>(c[k]);
      c[k] = (rnd<BF16>(dr * wr[k]) - c[k] * inner) / nrm;
    }
  }
  for (int r0 = 0; r0 < d.SR; r0 += RT) {  // d a = rnd(d_c R^T)
    __syncthreads();
    load_tile(r, i, r0, d, s.Rt);
    __syncthreads();
    gemm_nt<MB, BF16, true>(s.C, s.Rt, s.DA, r0, d);
  }
  __syncthreads();
  for (int m = warp; m < d.M; m += kWarps) {  // d sim = g1 * a * (d a - sum_R a d a)
    const float* a = s.S + m * d.SR;
    float* da = s.DA + m * d.SR;
    float rs = 0.f;
    for (int q = lane; q < d.R; q += 32) rs = fmaf(a[q], da[q], rs);
    rs = warp_sum(rs);
    for (int q = lane; q < d.SR; q += 32) da[q] = q < d.R ? d.g1 * (a[q] * (da[q] - rs)) : 0.f;
  }
  __syncthreads();
}

// d_regions: block (image i, split). The split's caption sub-blocks add
// rnd(a)^T d_c + d_sim^T W into partial[i][split] ([R][D]).
template <typename T, int MB, bool BF16>
__global__ void __launch_bounds__(kThreads)
damsm_bwd_dr_kernel(const T* __restrict__ r, const T* __restrict__ w,
                    const uint8_t* __restrict__ mask, const float* __restrict__ g,
                    float* __restrict__ partial, Dims d, int nsplit) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(reinterpret_cast<float*>(smem_raw), d, true);
  const int i = blockIdx.x, split = blockIdx.y;
  const int nsub = (d.Bc + d.vb - 1) / d.vb;
  const int per = (nsub + nsplit - 1) / nsplit;
  const int sb0 = split * per, sb1 = min(nsub, sb0 + per);
  float* acc_out = partial + (size_t(i) * nsplit + split) * d.R * d.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sb0 >= sb1) {  // an empty split still owns its slice
    for (int e = threadIdx.x; e < d.R * d.D; e += kThreads) acc_out[e] = 0.f;
    return;
  }
  for (int sb = sb0; sb < sb1; ++sb) {
    const int j0 = sb * d.vb;
    __syncthreads();
    load_words(w, j0, d, s.W);
    backward_chain<T, MB, BF16, false>(r, mask, g, i, j0, d, s, nullptr, 0);
    for (int q0 = 0; q0 < d.R; q0 += 4 * kWarps) {  // rows q0 + warp + 8 ii of d_r
      float acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int m = 0; m < d.M; ++m) {
        float cv[8], wv[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int k = lane + 32 * jj;
          cv[jj] = k < d.Dp ? s.C[m * d.SD + k] : 0.f;
          wv[jj] = k < d.Dp ? s.W[m * d.SD + k] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int q = q0 + warp + kWarps * a;  // q < SR: padded columns hold 0
          const float av = rnd<BF16>(s.S[m * d.SR + q]);
          const float sv = s.DA[m * d.SR + q];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[a][jj] = fmaf(sv, wv[jj], fmaf(av, cv[jj], acc[a][jj]));
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int q = q0 + warp + kWarps * a;
        if (q >= d.R) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int k = lane + 32 * jj;
          if (k >= d.D) continue;
          float* o = acc_out + size_t(q) * d.D + k;
          *o = (sb == sb0) ? acc[a][jj] : *o + acc[a][jj];
        }
      }
    }
  }
}

// d_words: block (caption sub-block, split). The split's images add
// drel * rnd(c_hat) + d_sim R into partial[split][captions of the block].
template <typename T, int MB, bool BF16>
__global__ void __launch_bounds__(kThreads)
damsm_bwd_dw_kernel(const T* __restrict__ r, const T* __restrict__ w,
                    const uint8_t* __restrict__ mask, const float* __restrict__ g,
                    float* __restrict__ partial, Dims d, int nsplit) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(reinterpret_cast<float*>(smem_raw), d, true);
  const int j0 = blockIdx.x * d.vb, split = blockIdx.y;
  const int per = (d.B + nsplit - 1) / nsplit;
  const int i0 = split * per, i1 = min(d.B, i0 + per);
  const int rows = min(d.vb, d.Bc - j0) * d.T;  // rows of real captions
  float* acc_out = partial + (size_t(split) * d.Bc * d.T + size_t(j0) * d.T) * d.D;
  for (int e = threadIdx.x; e < rows * d.D; e += kThreads) acc_out[e] = 0.f;
  load_words(w, j0, d, s.W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = i0; i < i1; ++i) {
    __syncthreads();
    backward_chain<T, MB, BF16, true>(r, mask, g, i, j0, d, s, acc_out, rows);
    float acc[MB][8];
#pragma unroll
    for (int a = 0; a < MB; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    for (int r0 = 0; r0 < d.SR; r0 += RT) {  // d_sim R
      __syncthreads();
      load_tile(r, i, r0, d, s.Rt);
      __syncthreads();
      gemm_nn_tile<MB, BF16, false>(acc, s.DA, r0, s.Rt, d);
    }
#pragma unroll
    for (int a = 0; a < MB; ++a) {
      const int m = warp + kWarps * a;
      if (m >= rows) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int k = lane + 32 * jj;
        if (k < d.D) acc_out[size_t(m) * d.D + k] += acc[a][jj];
      }
    }
  }
}

// out[o][x] = sum_s part[o][s][x], in split order.
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t outer,
                  int nsplit, int64_t inner) {
  const int64_t n = outer * inner;
  for (int64_t e = int64_t(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += int64_t(gridDim.x) * kThreads) {
    const int64_t o = e / inner, x = e % inner;
    const float* p = part + o * nsplit * inner + x;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) acc += p[s * inner];
    out[e] = acc;
  }
}

template <typename K>
bool prepare(K kernel, size_t bytes) {
  if (bytes > size_t(SMEM_LIMIT)) return false;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes)) == cudaSuccess;
}

bool dims_ok(const Dims& d) {
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.D > 0 && d.vb > 0 &&
         d.M <= MAX_ROWS && d.Dp <= MAX_DP;
}

template <typename T, int MB, bool BF16>
int launch_fwd(const void* r, const void* w, const uint8_t* mask, float* out, const Dims& d,
               cudaStream_t st) {
  auto k = damsm_fwd_kernel<T, MB, BF16>;
  const size_t bytes = smem_bytes(d, false);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, (d.Bc + d.vb - 1) / d.vb);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(r), static_cast<const T*>(w), mask,
                                   out, d);
  return int(cudaGetLastError());
}

void launch_sum(const float* part, float* out, int64_t outer, int nsplit, int64_t inner,
                cudaStream_t st) {
  const int64_t n = outer * inner;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<int(blocks), kThreads, 0, st>>>(part, out, outer, nsplit, inner);
}

template <typename T, int MB, bool BF16>
int launch_dr(const void* r, const void* w, const uint8_t* mask, const float* g,
              float* partial, float* dr, const Dims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dr_kernel<T, MB, BF16>;
  const size_t bytes = smem_bytes(d, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(r), static_cast<const T*>(w), mask,
                                   g, partial, d, nsplit);
  if (partial != dr) launch_sum(partial, dr, d.B, nsplit, int64_t(d.R) * d.D, st);
  return int(cudaGetLastError());
}

template <typename T, int MB, bool BF16>
int launch_dw(const void* r, const void* w, const uint8_t* mask, const float* g,
              float* partial, float* dw, const Dims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dw_kernel<T, MB, BF16>;
  const size_t bytes = smem_bytes(d, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid((d.Bc + d.vb - 1) / d.vb, nsplit);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(r), static_cast<const T*>(w), mask,
                                   g, partial, d, nsplit);
  if (partial != dw) launch_sum(partial, dw, 1, nsplit, int64_t(d.Bc) * d.T * d.D, st);
  return int(cudaGetLastError());
}

// Dispatch on the operand type and on MB = rows per warp (4 for <= 32 word
// rows per block, else 8).
#define XMC_DAMSM_DISPATCH(LAUNCH, ...)                                            \
  do {                                                                             \
    const bool small = d.M <= 4 * kWarps;                                          \
    if (dtype == 0)                                                                \
      return small ? LAUNCH<float, 4, false>(__VA_ARGS__)                          \
                   : LAUNCH<float, 8, false>(__VA_ARGS__);                         \
    if (dtype == 1)                                                                \
      return small ? LAUNCH<__nv_bfloat16, 4, true>(__VA_ARGS__)                   \
                   : LAUNCH<__nv_bfloat16, 8, true>(__VA_ARGS__);                  \
    return int(cudaErrorInvalidValue);                                             \
  } while (0)

}  // namespace

extern "C" int xmc_damsm_fwd(const void* r, const void* w, const void* mask, void* out,
                             int B, int Bc, int R, int T, int D, int vb, float g1, float g2,
                             int dtype, void* stream) {
  const Dims d = make_dims(B, Bc, R, T, D, vb, g1, g2);
  if (!dims_ok(d)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  XMC_DAMSM_DISPATCH(launch_fwd, r, w, m, o, d, st);
}

extern "C" int xmc_damsm_bwd_dr(const void* r, const void* w, const void* mask, const void* g,
                                void* partial, void* dr, int B, int Bc, int R, int T, int D,
                                int vb, int nsplit, float g1, float g2, int dtype,
                                void* stream) {
  const Dims d = make_dims(B, Bc, R, T, D, vb, g1, g2);
  if (!dims_ok(d) || nsplit < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* gg = static_cast<const float*>(g);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dr);
  XMC_DAMSM_DISPATCH(launch_dr, r, w, m, gg, p, o, d, nsplit, st);
}

extern "C" int xmc_damsm_bwd_dw(const void* r, const void* w, const void* mask, const void* g,
                                void* partial, void* dw, int B, int Bc, int R, int T, int D,
                                int vb, int nsplit, float g1, float g2, int dtype,
                                void* stream) {
  const Dims d = make_dims(B, Bc, R, T, D, vb, g1, g2);
  if (!dims_ok(d) || nsplit < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* gg = static_cast<const float*>(g);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dw);
  XMC_DAMSM_DISPATCH(launch_dw, r, w, m, gg, p, o, d, nsplit, st);
}
