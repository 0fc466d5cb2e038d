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
// Four forward kernels and three backward ones (attn_bwd_warp, attn_bwd,
// attn_bwd_long); the
// wrapper's plans (ops/cuda/cross_attention.py, plan() and plan_bwd()) name
// the kernel and its launch geometry before any launch, and the C entries
// refuse a launch whose kernel or geometry is not one they take.
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

// attn_short: the Out sampler's shapes, each (b, g) row short in both
// queries and words.  OutConceptBlock attends the 16 concept states of a
// row (D = 4) over its T = 15 (or 20) words: B = 128 rows at a 256^2
// request, 88 at the 64^2 train step, ~0.1 MB of operands a launch in
// fp32.  Neither bytes (0.03 us) nor arithmetic bound it; its time is latency:
// the dependent chain from the first load to the store, beside the launch
// itself (~1 us for an empty kernel on an H100).  attn_small took ~5 us a
// launch there (PERF.md): a block of one warp carried 4 query slots a lane
// with 16 queries, so 7 of 8 chains computed on zeros, and each block went
// load q, barrier, stage k and v, barrier, a max pass, a rescaled pass,
// store.  The design:
//   * A warp owns one (b, g) row.  At N <= 16 (SPLIT 2) two lanes take a
//     query, lane l query l % 16 over the words l / 16 + 2 i; at
//     16 < N <= 32 (SPLIT 1) a lane a query over every word.  No lane
//     holds a dead query slot past the row's 32 / SPLIT.
//   * One memory round trip: every lane issues its q load, its mask byte
//     (lane t: word t; compacted with a ballot into a bit mask of the real
//     words) and its words' k and v loads before the first use: 16-byte
//     (fp32) or 8-byte (bf16) vectors where D = 4 and the rows of q, k and
//     v are aligned, else a value at a time.  The loads are unconditional
//     (indices clamped, the bit mask and the stores leave out what lies
//     past N or T) and converted to fp32 in the same straight line, so no
//     branch makes the warp wait for one load before it issues the next
//     (a bf16 conversion inside a guarded branch did: 4.0 against 2.6 us
//     fp32, PERF.md).  No shared memory, no barrier.  Where v is k (the
//     same address and strides: the Out block passes the keys as the
//     values) a word is read once.
//   * Exact maximum, no rescale: the lane's TMAX / SPLIT scores stay in
//     registers in log2 units (TMAX 16 up to T = 16, else 32), the body
//     unrolled to them and masked by the bit mask (padded words -inf, their
//     values never read into a sum), so no word costs a branch; then the
//     max (one __shfl_xor with the other lane), one exp2 a pair, the
//     weighted sum, and one __shfl_xor each for the sum and the 4
//     accumulators.  Both lanes hold the same merged fp32 sums; the first
//     divides and rounds them once and stores, the stores of a warp's
//     queries contiguous.
//   * Grid: one warp a block up to 4,096 rows (one wave on 132 SMs at 32
//     blocks each; 128 blocks at the request, 88 at the step), 4 past it.
// Precondition (the plan's rule): D <= 4, 1 <= T <= 32, 1 <= N <= 32, any
// G, q, k, v with a dense last dimension.

// attn_small (D <= 32) and attn_wide (32 < D <= 256) take every other
// shape, any grouping (the JAX package's kernel shapes, N > 32 at D <= 4);
// q, k, v are strided views with a dense last dimension:
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
// The backward (no Pallas kernel has one: the JAX package differentiates
// its XLA einsum chain; the port's word-attention generators train through
// attn_bwd_warp).  With s = scale q.k over the real words,
//   P = softmax_t(s), dP = dO v^T, Delta = sum_t P dP, dS = P (dP - Delta),
//   dq = scale dS k, dk = scale dS^T q, dv = P^T dO,
// recomputed from q and k (the forward saves neither P nor its output:
// Delta is taken from sum_t P dP, not dO . O).  Math is fp32; dq, dk and dv
// are rounded once on store to the operands' type.  A fully padded row gets
// zero dq, dk and dv.  q, k, v and dO at any strides, dq at the strides the
// wrapper gives it (q's), dk and dv dense [B, G, T, D].  In both kernels one
// block owns a (b, g) row, so dk and dv, sums over the row's N queries, are
// folded in a fixed order: two runs are bit-equal (no float atomics, no
// second pass).
//
// attn_bwd_warp: the word-attention training path's shapes (D <= 4, T <= 32,
// templated on TMAX in {16, 32}, the real words a lane holds).  At the 64^2
// step's In launches (B = 88, G = 16, N = 256..4096, T = 15: 1,408 rows,
// 2.05e7 query rows, ~1.6e8 (query, real word) pairs) the bytes are q and
// dO read and dq written, 48 / 24 bytes a query (fp32 / bf16): 0.296 / 0.148
// ms at 3.35 TB/s; the pairs' ~20 fp32 instructions and one exp2 each
// issue in ~0.1 ms on 132 SMs.  What binds it on the H100 is shared
// memory's delivery to registers, 128 bytes a cycle an SM: a word's key
// broadcast to a warp costs 4 cycles, whoever shares it.  The design:
//   * A warp takes 32 queries at a time, a lane a query: one pass over the
//     real words keeps each score (rounded once, __fmul_rn, so the largest
//     word's weight is exp2(0) = 1 exactly and a one-word row's dS is
//     exactly 0) and dP in registers; then the exact maximum, one exp2 a
//     pair, P, dS and dq.  No dot product is computed twice.  The body is
//     unrolled for the row's real words in steps of four slots (those past
//     the words masked), so no word costs a branch, and the few bodies
//     that run side by side on an SM stay in its instruction cache; where
//     the values are the keys (both samplers pass them so) a word is read
//     once.
//   * dk and dv on every thread, with no block barrier in the loop: the
//     warp puts dS and P of its 32 queries into its own rows ([2 TMAX][36]
//     floats, a word pair's rows TMAX / 2 apart: no bank conflicts) and q
//     and dO as fp32 rows; each lane owns two rows of one kind (dS against
//     q, P against dO), D = 4 features each, over a share of the batch's
//     queries, so one load of a query's x feeds eight FMAs, and adds the
//     batch into registers.  At the end the lanes' sums go through shared
//     memory and are folded warps by index, shares in order.
//   * No partial wave: 64 threads a block (32 for N <= 32) and ~18 KB of
//     shared memory, so 11 blocks fit an SM (8 at TMAX = 32) and the 1,408
//     rows run as one wave.
//   * A warp stages its next two batches of q and dO with cp.async while it
//     computes one (three 1 KB stages), so its loads wait on no compute.
//   * q and dq as planes ([B, G, D, N], the In sampler's on the card): a
//     lane loads and stores four consecutive queries of a plane (16 bytes
//     fp32, 8 bf16) through the warp's stage; as rows, a query's four values
//     are one vector; any other strides (D < 4, unaligned) a value at a
//     time, unstaged.  dO sliced from the Out block's concatenation is rows.
//   * It stays on the CUDA cores in fp32: at D = 4 a tensor-core product
//     would be 75% padding, and rounding P and dS to bf16 for mma would
//     leave the plain version's numbers.
//
// attn_bwd (every other shape: D <= 32, templated on DMAX in {4, 8, 16, 32},
// T <= 256, any G and N):
//   * The block stages its row's real words (compacted from the mask) as
//     fp32, then walks the queries a tile of blockDim at a time, a thread a
//     query: three passes over the words (the exact maximum; the softmax's
//     sum and sum_t P dP; P, dS and dq), P and dS of the tile into shared
//     memory as [word][query] with the queries and dO as [feature][query]
//     (rows padded by one float: no bank conflicts).
//   * Then each of the 2 x real words x D outputs has one thread, which
//     adds the tile's queries in order into its accumulator in shared
//     memory.  The tile shrinks with T (256 queries up to T = 32, 32 at
//     T = 256) so that the tiles fit.
//
// attn_bwd_long (captions past attn_bwd's 256 words: D <= 32, templated on
// DMAX, any T > 256 whose grid fits).  attn_bwd keeps every word's keys,
// values and sums in shared memory beside [T][tile] weight tiles: 209 KB at
// T = 256, D = 32, so it cannot take a longer caption.  Here the words
// stream through shared memory in tiles of 64 (keys and values as fp32,
// the mask as flags), and a block of one (b, g) row walks its queries a
// tile of up to 128 at a time, a thread a query:
//   * Pass 1 over the word tiles: each tile's maximum first, then the
//     running maximum, sum and sum_t P dP rescaled once a tile (exact at the
//     end; each score rounded once, __fmul_rn, the same in both passes, so
//     the largest word's weight is exp2(0) = 1 and a one-word row's dS is
//     exactly 0).  Delta = sum_t P dP / sum_t P.
//   * Pass 2 over the word tiles: P, dS and dq (in registers) a word at a
//     time, the tile's P and dS into shared memory as [word][query], the
//     queries and dO as [feature][query] (rows padded by one float); then
//     each (dk or dv, word) of the tile has one owner thread, which adds the
//     tile's queries in order, all D features at once, into its fp32
//     accumulators.
//   * The accumulators ([2][T][DMAX]) stay in shared memory where they fit
//     beside the tiles (up to 227 KB a block: with 128-query tiles T <=
//     4,999 at D <= 4, 456 at D = 32), else in the block's own part of an fp32 scratch in device
//     memory ([B * G][2][T][DMAX], from the wrapper), which no other block
//     touches.  A last sweep rounds dk and dv once and stores them; a
//     padded word gets 0.
//   * Bound at the 64^2 In step at T = 300 (2.05e7 query rows, ~150 real
//     words a caption): ~45 fp32 operations a (query, real word) pair,
//     ~2 ms of FMA issue on 132 SMs against ~0.3 ms of bytes.  This first
//     version is simple, not fast: it recomputes each score three times and
//     runs 4-8 warps an SM.
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
//   rows, 1 = planes; 0 for the others), 3 = attn_short; threads, blocks,
//   tile (queries a block, or a tile; attn_short: rows a block) and
//   tiles_per_block are the plan's geometry.  Returns
//   cudaGetLastError() after the launch (0 = success), or
//   cudaErrorInvalidValue for a launch the named kernel does not take.
//   int xmc_cross_attention_bwd(q, k, v, mask, dout, dq, dk, dv, B, G, N, T,
//                               D, qsb, qsg, qsn, qsd, ksb, ksg, kst, ksd,
//                               vsb, vsg, vst, vsd, gsb, gsg, gsn, gsd, dqsb,
//                               dqsg, dqsn, dqsd, scale, dtype, dmax, threads,
//                               blocks, smem, stream)
//   dout's strides are gs*, dq's dqs*; dk and dv are dense [B, G, T, D].
//   dmax, threads (the queries of a tile), blocks (B * G) and smem (bytes of
//   dynamic shared memory) are the plan's (plan_bwd); the entry recomputes
//   them and refuses a launch where they differ.  Returns as above.
//   int xmc_cross_attention_bwd_long(q, k, v, mask, dout, dq, dk, dv, scratch,
//                                    ... as xmc_cross_attention_bwd ...)
//   attn_bwd_long's: T > 256; dmax, threads (N rounded up to a warp, at
//   most 128), blocks (B * G), smem (long_smem) and scratch (NULL where the
//   accumulators fit in shared memory, else 8 * T * dmax bytes a block, in
//   block order) are the plan's, checked as above.
//   int xmc_cross_attention_bwd_warp(... the same operands, shapes and
//                                    strides ..., scale, dtype, tmax,
//                                    threads, blocks, smem, stream)
//   attn_bwd_warp's: tmax (16 up to T = 16, else 32), threads (32 up to
//   N = 32, else 64), blocks (B * G) and smem are the plan's, checked as
//   above.

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

// ------------------------------------------------------------------ attn_short

constexpr int kShortMaxT = 32;         // one warp's ballot of the mask row
constexpr int kShortMaxN = 32;         // a query a lane at least
constexpr int kShortMaxD = 4;
constexpr int kShortWideWarps = 4;     // rows a block past kShortOneWarpRows rows
constexpr int kShortOneWarpRows = 4096;  // one warp a block up to here: 132 SMs x 32 blocks

struct ShortArgs {
  int rows, G, N, T, D;
  int vec, kv;  // vec: q's, k's and v's rows are aligned 4-vectors; kv: v is k
  int64_t qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn;
  float scale;
};

// The first D (<= 4) values of a row, zeros past D: VEC, one 16-byte (fp32)
// or 8-byte (bf16) load (D = 4, the row aligned); else a value at a time,
// feature min(d, D - 1) read and the ones past D set to 0 after.  No
// branch: a load and its conversion sit in one straight line with every
// other load of the row, so all are in flight before the first is used (a
// conversion inside a branch would make the warp wait for its load there).
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int D, float (&r)[4]) {
  if constexpr (VEC && sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else if constexpr (VEC) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    r[0] = __uint_as_float(raw.x << 16);  // bf16 -> fp32: the high half of a word
    r[1] = __uint_as_float(raw.x & 0xffff0000u);
    r[2] = __uint_as_float(raw.y << 16);
    r[3] = __uint_as_float(raw.y & 0xffff0000u);
  } else {
    T x[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) x[d] = p[min(d, D - 1)];
#pragma unroll
    for (int d = 0; d < 4; ++d) r[d] = d < D ? to_f(x[d]) : 0.f;
  }
}

// The warp's row (b, g): lane `lane` takes query lane % (32 / SPLIT) over
// the words t = lane / (32 / SPLIT) + SPLIT i, i < TMAX / SPLIT (see the
// header).  KV: the values are the keys, read once.  VEC: q, k and v are
// read as vectors.
template <typename T, int TMAX, int SPLIT, bool KV, bool VEC>
__device__ __forceinline__ void short_row(const T* __restrict__ q, const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const uint8_t* __restrict__ mask, T* __restrict__ out,
                                          const ShortArgs& a, int b, int g, int lane) {
  constexpr int S = TMAX / SPLIT;         // word slots a lane holds
  constexpr int QL = 32 / SPLIT;          // queries a warp holds
  const int n = lane & (QL - 1), half = lane / QL;
  // One round trip, every load unconditional: the query (lanes past N read
  // query N - 1 and store nothing), the row's mask bytes (a lane each) and
  // the lane's words (slots past T read word T - 1, which the bit mask
  // leaves out), all issued before the first use.
  float qv[4];
  load4<T, VEC>(q + b * a.qsb + g * a.qsg + min(n, a.N - 1) * a.qsn, a.D, qv);
  const uint8_t pad = mask[static_cast<int64_t>(b) * a.T + min(lane, a.T - 1)];
  const T* kb = k + b * a.ksb + g * a.ksg;
  const T* vb = v + b * a.vsb + g * a.vsg;
  float kr[S][4], vr[S][4];  // vr unused where KV
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = min(half + SPLIT * i, a.T - 1);
    load4<T, VEC>(kb + t * a.kst, a.D, kr[i]);
    if constexpr (!KV) load4<T, VEC>(vb + t * a.vst, a.D, vr[i]);
  }
  const unsigned real = __ballot_sync(0xffffffffu, lane < a.T && pad == 0);  // bit t: word t

  // The scores in log2 units, padded words -inf; the exact maximum over the
  // query's lanes; one exp2 a (query, word) pair, no rescale.
  const float c2 = a.scale * kLog2e;
#pragma unroll
  for (int d = 0; d < 4; ++d) qv[d] *= c2;
  float s[S];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = half + SPLIT * i;
    float x = qv[0] * kr[i][0];
    x = fmaf(qv[1], kr[i][1], x);
    x = fmaf(qv[2], kr[i][2], x);
    x = fmaf(qv[3], kr[i][3], x);
    s[i] = (real >> t) & 1u ? x : -INFINITY;
    m = fmaxf(m, s[i]);
  }
  if constexpr (SPLIT == 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
  const float shift = m == -INFINITY ? 0.f : m;  // a fully padded row: every weight 0
  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = half + SPLIT * i;
    const bool in = (real >> t) & 1u;
    const float e = ex2(s[i] - shift);  // exactly 0 for a padded word
    l += e;
#pragma unroll
    for (int d = 0; d < 4; ++d)  // a padded word's value never enters, whatever its bits
      acc[d] = fmaf(e, in ? (KV ? kr : vr)[i][d] : 0.f, acc[d]);
  }
  if constexpr (SPLIT == 2) {  // the query's two lanes: the same sums on both
    l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], 16);
  }
  if (half == 0 && n < a.N) {  // rounded once, from the merged sums
    const float denom = fmaxf(l, 1e-30f);
    float o[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) o[d] = acc[d] / denom;
    store_row<T, 4>(out + b * a.osb + g * a.osg + n * a.osn, a.D, o);
  }
}

// A warp a (b, g) row, D <= 4, 1 <= T <= TMAX <= 32, N <= 32 / SPLIT
// queries (see the header).
template <typename T, int TMAX, int SPLIT>
__global__ void __launch_bounds__(kShortWideWarps * 32)
attn_short(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, T* __restrict__ out, ShortArgs a) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // whole warps
  const int b = row / a.G, g = row - b * a.G, lane = threadIdx.x & 31;
  if (a.kv && a.vec)
    short_row<T, TMAX, SPLIT, true, true>(q, k, v, mask, out, a, b, g, lane);
  else if (a.kv)
    short_row<T, TMAX, SPLIT, true, false>(q, k, v, mask, out, a, b, g, lane);
  else if (a.vec)
    short_row<T, TMAX, SPLIT, false, true>(q, k, v, mask, out, a, b, g, lane);
  else
    short_row<T, TMAX, SPLIT, false, false>(q, k, v, mask, out, a, b, g, lane);
}

// Whether an operand's rows of D = 4 values are aligned vectors of its type.
template <typename T>
int rows_aligned(const void* p, int D, int64_t sb, int64_t sg, int64_t sn) {
  return D == 4 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0 && sb % 4 == 0 &&
         sg % 4 == 0 && sn % 4 == 0;
}

// The plan's attn_short launch, if attn_short takes it (D <= 4, 1 <= T <=
// 32, 1 <= N <= 32, dense last dimensions) with the geometry the plan's rule
// gives: TMAX 16 up to T = 16, else 32; SPLIT 2 up to N = 16, else 1; one
// warp a block up to kShortOneWarpRows rows, else kShortWideWarps (`tile`,
// the rows a block).
template <typename T>
int short_launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                 int B, int G, int N, int T_, int D, int64_t qsb, int64_t qsg, int64_t qsn,
                 int64_t ksb, int64_t ksg, int64_t kst, int64_t vsb, int64_t vsg, int64_t vst,
                 int64_t osb, int64_t osg, int64_t osn, float scale, int threads, int blocks,
                 int tile, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (D > kShortMaxD || T_ < 1 || T_ > kShortMaxT || N > kShortMaxN) return bad;
  const int64_t rows = static_cast<int64_t>(B) * G;
  if (rows > 0x7fffff00LL) return bad;
  const int warps = rows <= kShortOneWarpRows ? 1 : kShortWideWarps;
  const int64_t want_blocks = (rows + warps - 1) / warps;
  if (tile != warps || threads != 32 * warps || want_blocks > 0x7fffffffLL ||
      blocks != want_blocks)
    return bad;
  const int kv = k == v && ksb == vsb && ksg == vsg && kst == vst;
  const ShortArgs a{static_cast<int>(rows),
                    G, N, T_, D,
                    rows_aligned<T>(q, D, qsb, qsg, qsn) && rows_aligned<T>(k, D, ksb, ksg, kst)
                        && rows_aligned<T>(v, D, vsb, vsg, vst),
                    kv, qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn, scale};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (T_ <= 16) {
    if (N <= 16)
      attn_short<T, 16, 2><<<blocks, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
    else
      attn_short<T, 16, 1><<<blocks, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  } else {
    if (N <= 16)
      attn_short<T, 32, 2><<<blocks, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
    else
      attn_short<T, 32, 1><<<blocks, threads, 0, stream>>>(qp, kp, vp, mask, op, a);
  }
  return static_cast<int>(cudaGetLastError());
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


// ------------------------------------------------------------------ attn_bwd

constexpr int kBwdMaxT = 256;
constexpr int kBwdMaxD = 32;

struct BwdArgs {
  int G, N, T, D, tile;
  int64_t qsb, qsg, qsn, qsd, ksb, ksg, kst, ksd, vsb, vsg, vst, vsd;
  int64_t gsb, gsg, gsn, gsd, dqsb, dqsg, dqsn, dqsd;
  float scale;
};

// The queries a block takes at once (its threads) by caption length: the
// [T][tile] weight and cotangent tiles stay within shared memory.
__host__ __device__ constexpr int bwd_tile(int T) {
  return T <= 32 ? 256 : T <= 64 ? 128 : T <= 128 ? 64 : 32;
}

__host__ __device__ constexpr size_t bwd_smem(int T, int dmax, int tile) {
  return sizeof(float) * (4 * static_cast<size_t>(T) * dmax +
                          2 * static_cast<size_t>(T + dmax) * (tile + 1)) +
         2 * sizeof(int) * static_cast<size_t>(T);
}

// The first DMAX values of a row at a d-stride of sd (zeros past D).
template <typename E, int DMAX>
__device__ __forceinline__ void load_strided(const E* __restrict__ p, int D, int64_t sd,
                                             float (&r)[DMAX]) {
  if (sd == 1) {
    load_row<E, DMAX>(p, D, r);
    return;
  }
#pragma unroll
  for (int d = 0; d < DMAX; ++d) r[d] = d < D ? to_f(p[d * sd]) : 0.f;
}

template <typename E, int DMAX>
__device__ __forceinline__ void store_strided(E* __restrict__ p, int D, int64_t sd,
                                              const float (&r)[DMAX]) {
  if (sd == 1) {
    store_row<E, DMAX>(p, D, r);
    return;
  }
#pragma unroll
  for (int d = 0; d < DMAX; ++d)
    if (d < D) p[d * sd] = from_f<E>(r[d]);
}

// One block per (b, g), walking its N queries a tile of blockDim at a time
// (see the backward's part of the header).  dk and dv are written dense,
// [B, G, T, D].
template <typename E, int DMAX>
__global__ void __launch_bounds__(256)
attn_bwd(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
         const uint8_t* __restrict__ mask, const E* __restrict__ dout, E* __restrict__ dq,
         E* __restrict__ dk, E* __restrict__ dv, BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int nreal_s;
  const int tile = a.tile, ld = tile + 1, tid = threadIdx.x;
  const int b = blockIdx.x / a.G, g = blockIdx.x - b * a.G;
  float* ks = sm;                           // [T][DMAX]: the real words' keys, fp32
  float* vs = ks + a.T * DMAX;              // [T][DMAX]: their values
  float* acc = vs + a.T * DMAX;             // [2][T][DMAX]: sum dS q, sum P dO
  float* ps = acc + 2 * a.T * DMAX;         // [T][ld]: the tile's weights P
  float* dss = ps + a.T * ld;               // [T][ld]: its dS
  float* qt = dss + a.T * ld;               // [DMAX][ld]: its queries
  float* gt = qt + DMAX * ld;               // [DMAX][ld]: its dO
  int* idx = reinterpret_cast<int*>(gt + DMAX * ld);  // [T]: the real words, in order
  int* pos = idx + a.T;                     // [T]: each word's real index, -1 if padded

  if (tid == 0) {
    int nr = 0;
    for (int t = 0; t < a.T; ++t) {
      const bool real = mask[static_cast<int64_t>(b) * a.T + t] == 0;
      pos[t] = real ? nr : -1;
      if (real) idx[nr++] = t;
    }
    nreal_s = nr;
  }
  __syncthreads();
  const int nreal = nreal_s;
  for (int i = tid; i < nreal * DMAX; i += blockDim.x) {
    const int j = i / DMAX, d = i - j * DMAX;
    const bool in = d < a.D;
    ks[i] = in ? to_f(k[b * a.ksb + g * a.ksg + idx[j] * a.kst + d * a.ksd]) : 0.f;
    vs[i] = in ? to_f(v[b * a.vsb + g * a.vsg + idx[j] * a.vst + d * a.vsd]) : 0.f;
    acc[i] = 0.f;
    acc[a.T * DMAX + i] = 0.f;
  }
  __syncthreads();

  const float c2 = a.scale * kLog2e;  // scores in log2 units
  const int outputs = 2 * nreal * a.D;
  for (int n0 = 0; n0 < a.N; n0 += tile) {
    const int n = n0 + tid;
    const bool active = n < a.N;
    float qv[DMAX], gv[DMAX], dqv[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) qv[d] = gv[d] = dqv[d] = 0.f;
    if (active) {
      load_strided<E, DMAX>(q + b * a.qsb + g * a.qsg + n * a.qsn, a.D, a.qsd, qv);
      load_strided<E, DMAX>(dout + b * a.gsb + g * a.gsg + n * a.gsn, a.D, a.gsd, gv);
    }
    if (nreal > 0) {
      // P from the exact maximum; Delta = sum_t P dP from a first pass.
      // Each score is rounded once (__fmul_rn: no FMA into the shift), the
      // same in every pass, so the largest word's weight is exp2(0) = 1
      // exactly and a one-word row's dS is exactly 0, as the plain version's
      float m = -INFINITY;
      for (int j = 0; j < nreal; ++j) m = fmaxf(m, __fmul_rn(dot<DMAX>(qv, ks + j * DMAX), c2));
      float l = 0.f, pdp = 0.f;
      for (int j = 0; j < nreal; ++j) {
        const float e = exp2f(__fmul_rn(dot<DMAX>(qv, ks + j * DMAX), c2) - m);
        l += e;
        pdp = fmaf(e, dot<DMAX>(gv, vs + j * DMAX), pdp);
      }
      const float inv = 1.f / l;
      const float delta = pdp * inv;
      for (int j = 0; j < nreal; ++j) {
        const float* kj = ks + j * DMAX;
        const float p = exp2f(__fmul_rn(dot<DMAX>(qv, kj), c2) - m) * inv;
        const float ds = p * (dot<DMAX>(gv, vs + j * DMAX) - delta);
#pragma unroll
        for (int d = 0; d < DMAX; ++d) dqv[d] = fmaf(ds, kj[d], dqv[d]);
        ps[j * ld + tid] = active ? p : 0.f;
        dss[j * ld + tid] = active ? ds : 0.f;
      }
    }
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      qt[d * ld + tid] = qv[d];
      gt[d * ld + tid] = gv[d];
      dqv[d] *= a.scale;
    }
    if (active)
      store_strided<E, DMAX>(dq + b * a.dqsb + g * a.dqsg + n * a.dqsn, a.D, a.dqsd, dqv);
    __syncthreads();
    // dk and dv over the tile: output o (dk first, then dv; word j, feature
    // d) has one owner, which adds the tile's queries in order
    const int cnt = min(tile, a.N - n0);
    for (int o = tid; o < outputs; o += blockDim.x) {
      const int which = o / (nreal * a.D), r = o - which * nreal * a.D;
      const int j = r / a.D, d = r - j * a.D;
      const float* w = (which ? ps : dss) + j * ld;
      const float* x = (which ? gt : qt) + d * ld;
      float s = 0.f;
      for (int i = 0; i < cnt; ++i) s = fmaf(w[i], x[i], s);
      acc[(which * a.T + j) * DMAX + d] += s;
    }
    __syncthreads();
  }
  const int64_t row = (static_cast<int64_t>(b) * a.G + g) * a.T;
  for (int i = tid; i < 2 * a.T * a.D; i += blockDim.x) {
    const int which = i / (a.T * a.D), r = i - which * a.T * a.D;
    const int t = r / a.D, d = r - t * a.D;
    const int j = pos[t];
    const float x = j < 0 ? 0.f : acc[(which * a.T + j) * DMAX + d];
    (which ? dv : dk)[(row + t) * a.D + d] = from_f<E>(which ? x : x * a.scale);
  }
}

template <typename E, int DMAX>
int launch_bwd(const void* q, const void* k, const void* v, const uint8_t* mask,
               const void* dout, void* dq, void* dk, void* dv, const BwdArgs& a, int blocks,
               size_t smem, cudaStream_t stream) {
  const auto kern = attn_bwd<E, DMAX>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, a.tile, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), mask,
      static_cast<const E*>(dout), static_cast<E*>(dq), static_cast<E*>(dk),
      static_cast<E*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int bwd(const void* q, const void* k, const void* v, const uint8_t* mask, const void* dout,
        void* dq, void* dk, void* dv, const BwdArgs& a, int dmax, int blocks, size_t smem,
        cudaStream_t s) {
  switch (dmax) {
    case 4: return launch_bwd<E, 4>(q, k, v, mask, dout, dq, dk, dv, a, blocks, smem, s);
    case 8: return launch_bwd<E, 8>(q, k, v, mask, dout, dq, dk, dv, a, blocks, smem, s);
    case 16: return launch_bwd<E, 16>(q, k, v, mask, dout, dq, dk, dv, a, blocks, smem, s);
    default: return launch_bwd<E, 32>(q, k, v, mask, dout, dq, dk, dv, a, blocks, smem, s);
  }
}


// ------------------------------------------------------------- attn_bwd_long

constexpr int kLongTileT = 64;          // words a staged tile
constexpr int kLongMaxThreads = 128;    // queries a tile, a thread each
constexpr size_t kMaxBlockSmem = 232448;  // an H100 block's shared memory (227 KB)

// The queries a tile: N rounded up to a warp, at most kLongMaxThreads.
__host__ __device__ constexpr int long_threads(int N) {
  return N > kLongMaxThreads ? kLongMaxThreads : N > 32 ? (N + 31) / 32 * 32 : 32;
}

// Shared memory but the accumulators: the word tile's keys and values, the
// [word][query] P and dS, the [feature][query] q and dO, the pad flags.
__host__ __device__ constexpr size_t long_smem_tiles(int dmax, int threads) {
  return sizeof(float) * (2 * static_cast<size_t>(kLongTileT) * dmax +
                          2 * static_cast<size_t>(kLongTileT + dmax) * (threads + 1) +
                          kLongTileT);
}

__host__ __device__ constexpr size_t long_acc_bytes(int T, int dmax) {
  return 2 * sizeof(float) * static_cast<size_t>(T) * dmax;
}

// dk's and dv's accumulators in shared memory where they fit beside the tiles.
__host__ __device__ constexpr bool long_acc_shared(int T, int dmax, int threads) {
  return long_smem_tiles(dmax, threads) + long_acc_bytes(T, dmax) <= kMaxBlockSmem;
}

__host__ __device__ constexpr size_t long_smem(int T, int dmax, int threads) {
  return long_smem_tiles(dmax, threads) +
         (long_acc_shared(T, dmax, threads) ? long_acc_bytes(T, dmax) : 0);
}

// One block per (b, g), its queries a tile of blockDim at a time, the words
// streamed a tile of kLongTileT at a time (see the header).  dk and dv are
// written dense, [B, G, T, D]; scratch is NULL where the accumulators are in
// shared memory, else [B * G][2][T][DMAX] fp32, the block's own part.
template <typename E, int DMAX>
__global__ void __launch_bounds__(kLongMaxThreads)
attn_bwd_long(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
              const uint8_t* __restrict__ mask, const E* __restrict__ dout,
              E* __restrict__ dq, E* __restrict__ dk, E* __restrict__ dv,
              float* __restrict__ scratch, BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tile = a.tile, ld = tile + 1, tid = threadIdx.x;
  const int b = blockIdx.x / a.G, g = blockIdx.x - b * a.G;
  float* ks = sm;                           // [kLongTileT][DMAX]: the tile's keys, fp32
  float* vs = ks + kLongTileT * DMAX;       // [kLongTileT][DMAX]: its values
  float* ps = vs + kLongTileT * DMAX;       // [kLongTileT][ld]: the query tile's P
  float* dss = ps + kLongTileT * ld;        // [kLongTileT][ld]: its dS
  float* qt = dss + kLongTileT * ld;        // [DMAX][ld]: its queries
  float* gt = qt + DMAX * ld;               // [DMAX][ld]: its dO
  int* pad = reinterpret_cast<int*>(gt + DMAX * ld);  // [kLongTileT]: 1 = padded
  float* acc = scratch ? scratch + static_cast<int64_t>(blockIdx.x) * 2 * a.T * DMAX
                       : reinterpret_cast<float*>(pad + kLongTileT);  // [2][T][DMAX]
  const int64_t nacc = 2 * static_cast<int64_t>(a.T) * DMAX;
  for (int64_t i = tid; i < nacc; i += blockDim.x) acc[i] = 0.f;
  const uint8_t* mrow = mask + static_cast<int64_t>(b) * a.T;
  const E* kb = k + b * a.ksb + g * a.ksg;
  const E* vb = v + b * a.vsb + g * a.vsg;
  const float c2 = a.scale * kLog2e;  // scores in log2 units

  // words [t0, t0 + tt) into ks and vs (zero past D) and pad; all threads
  auto stage = [&](int t0, int tt) {
    for (int i = tid; i < tt * DMAX; i += blockDim.x) {
      const int j = i / DMAX, d = i - j * DMAX;
      const int64_t t = t0 + j;
      const bool in = d < a.D;
      ks[i] = in ? to_f(kb[t * a.kst + d * a.ksd]) : 0.f;
      vs[i] = in ? to_f(vb[t * a.vst + d * a.vsd]) : 0.f;
    }
    for (int j = tid; j < tt; j += blockDim.x) pad[j] = mrow[t0 + j] != 0;
  };

  for (int n0 = 0; n0 < a.N; n0 += tile) {
    const int n = n0 + tid;
    const bool active = n < a.N;
    float qv[DMAX], gv[DMAX], dqv[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) qv[d] = gv[d] = dqv[d] = 0.f;
    if (active) {
      load_strided<E, DMAX>(q + b * a.qsb + g * a.qsg + n * a.qsn, a.D, a.qsd, qv);
      load_strided<E, DMAX>(dout + b * a.gsb + g * a.gsg + n * a.gsn, a.D, a.gsd, gv);
    }
    // pass 1: the running maximum, sum and sum_t P dP, rescaled once a tile
    float m = -INFINITY, l = 0.f, pdp = 0.f;
    for (int t0 = 0; t0 < a.T; t0 += kLongTileT) {
      const int tt = min(kLongTileT, a.T - t0);
      __syncthreads();  // every thread is done with the previous tile
      stage(t0, tt);
      __syncthreads();
      float mt = -INFINITY;
      for (int j = 0; j < tt; ++j)
        if (!pad[j]) mt = fmaxf(mt, __fmul_rn(dot<DMAX>(qv, ks + j * DMAX), c2));
      if (mt > m) {  // a larger maximum: the sums so far scaled to it (0 from -inf)
        const float f = exp2f(m - mt);
        l *= f;
        pdp *= f;
        m = mt;
      }
      for (int j = 0; j < tt; ++j) {
        if (pad[j]) continue;
        const float e = exp2f(__fmul_rn(dot<DMAX>(qv, ks + j * DMAX), c2) - m);
        l += e;
        pdp = fmaf(e, dot<DMAX>(gv, vs + j * DMAX), pdp);
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a fully padded row: P = 0
    const float delta = pdp * inv;
    // (pass 1's barriers: the previous query tile's sums are done with qt, gt)
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      qt[d * ld + tid] = qv[d];
      gt[d * ld + tid] = gv[d];
    }
    // pass 2: P, dS and dq a word at a time; dk and dv of each word tile
    const int cnt = min(tile, a.N - n0);
    for (int t0 = 0; t0 < a.T; t0 += kLongTileT) {
      const int tt = min(kLongTileT, a.T - t0);
      __syncthreads();  // the previous tile's P and dS are summed
      stage(t0, tt);
      __syncthreads();
      for (int j = 0; j < tt; ++j) {
        if (pad[j]) continue;
        const float* kj = ks + j * DMAX;
        const float p = exp2f(__fmul_rn(dot<DMAX>(qv, kj), c2) - m) * inv;
        const float ds = p * (dot<DMAX>(gv, vs + j * DMAX) - delta);
#pragma unroll
        for (int d = 0; d < DMAX; ++d) dqv[d] = fmaf(ds, kj[d], dqv[d]);
        ps[j * ld + tid] = p;
        dss[j * ld + tid] = ds;
      }
      __syncthreads();
      // (dk or dv, word j) has one owner, which adds the tile's queries in
      // order, all features at once
      for (int o = tid; o < 2 * tt; o += blockDim.x) {
        const int which = o >= tt, j = o - which * tt;
        if (pad[j]) continue;
        const float* w = (which ? ps : dss) + j * ld;
        const float* x = which ? gt : qt;
        float s[DMAX];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) s[d] = 0.f;
        for (int i = 0; i < cnt; ++i) {
          const float wi = w[i];
#pragma unroll
          for (int d = 0; d < DMAX; ++d) s[d] = fmaf(wi, x[d * ld + i], s[d]);
        }
        float* out = acc + (static_cast<int64_t>(which) * a.T + t0 + j) * DMAX;
#pragma unroll
        for (int d = 0; d < DMAX; ++d) out[d] += s[d];
      }
    }
    if (active) {
#pragma unroll
      for (int d = 0; d < DMAX; ++d) dqv[d] *= a.scale;
      store_strided<E, DMAX>(dq + b * a.dqsb + g * a.dqsg + n * a.dqsn, a.D, a.dqsd, dqv);
    }
  }
  __syncthreads();
  const int64_t row = (static_cast<int64_t>(b) * a.G + g) * a.T;
  const int64_t td = static_cast<int64_t>(a.T) * a.D;
  for (int64_t i = tid; i < 2 * td; i += blockDim.x) {
    const int which = i >= td;
    const int64_t r = i - which * td, t = r / a.D;
    const int d = static_cast<int>(r - t * a.D);
    const float x = mrow[t] ? 0.f : acc[(which * a.T + t) * DMAX + d];
    (which ? dv : dk)[(row + t) * a.D + d] = from_f<E>(which ? x : x * a.scale);
  }
}

template <typename E, int DMAX>
int launch_bwd_long(const void* q, const void* k, const void* v, const uint8_t* mask,
                    const void* dout, void* dq, void* dk, void* dv, float* scratch,
                    const BwdArgs& a, int blocks, size_t smem, cudaStream_t stream) {
  const auto kern = attn_bwd_long<E, DMAX>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, a.tile, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), mask,
      static_cast<const E*>(dout), static_cast<E*>(dq), static_cast<E*>(dk),
      static_cast<E*>(dv), scratch, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int bwd_long(const void* q, const void* k, const void* v, const uint8_t* mask,
             const void* dout, void* dq, void* dk, void* dv, float* scratch, const BwdArgs& a,
             int dmax, int blocks, size_t smem, cudaStream_t s) {
  switch (dmax) {
    case 4:
      return launch_bwd_long<E, 4>(q, k, v, mask, dout, dq, dk, dv, scratch, a, blocks, smem, s);
    case 8:
      return launch_bwd_long<E, 8>(q, k, v, mask, dout, dq, dk, dv, scratch, a, blocks, smem, s);
    case 16:
      return launch_bwd_long<E, 16>(q, k, v, mask, dout, dq, dk, dv, scratch, a, blocks, smem,
                                    s);
    default:
      return launch_bwd_long<E, 32>(q, k, v, mask, dout, dq, dk, dv, scratch, a, blocks, smem,
                                    s);
  }
}


// ------------------------------------------------------------- attn_bwd_warp

constexpr int kWarpBwdMaxT = 32;       // real words a lane keeps in registers (TMAX <= 32)
constexpr int kWarpBwdMaxD = 4;
constexpr int kWarpBwdPitch = 36;      // floats a P or dS row of a warp's 32 queries (16-byte rows)
constexpr int kWarpBwdStages = 3;      // batches staged a warp: one computing, two in flight
enum { kLoadGeneric = 0, kLoadRows = 1, kLoadPlanes = 2 };

// Dynamic shared memory: the head (the real words' keys and values as
// float4, TMAX each), then per warp 4160 + 288 TMAX bytes: the x tiles of q
// and dO ([32] float4 each, the second 576 bytes on, so that one LDS.128 of
// both hits other banks), three stages of 1 KB (q, then dO: one batch's 32
// queries as loaded; two in flight while the third is computed) and the dS
// and P rows ([2 TMAX][36] floats).
__host__ __device__ constexpr int warp_bwd_head(int tmax) { return 32 * tmax; }
__host__ __device__ constexpr int warp_bwd_warp_bytes(int tmax) {
  return 1088 + 1024 * kWarpBwdStages + 288 * tmax;
}
__host__ __device__ constexpr int warp_bwd_smem(int tmax, int warps) {
  return warp_bwd_head(tmax) + warps * warp_bwd_warp_bytes(tmax);
}

struct WarpBwdArgs {
  int G, N, T, D, kv, qmode, gmode, dqmode;  // kv: v is k (same address and strides)
  int64_t qsb, qsg, qsn, qsd, ksb, ksg, kst, ksd, vsb, vsg, vst, vsd;
  int64_t gsb, gsg, gsn, gsd, dqsb, dqsg, dqsn, dqsd;
  float scale;
};

// Four consecutive values as one load or store: 16 bytes in fp32, 8 in bf16.
template <typename E>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};

template <typename E>
__device__ __forceinline__ void unpack4(const typename Raw4<E>::type& raw, float (&r)[4]) {
  const E* h = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int d = 0; d < 4; ++d) r[d] = to_f(h[d]);
}

template <typename E>
__device__ __forceinline__ typename Raw4<E>::type pack4(const float (&r)[4]) {
  typename Raw4<E>::type raw;
  E* h = reinterpret_cast<E*>(&raw);
#pragma unroll
  for (int d = 0; d < 4; ++d) h[d] = from_f<E>(r[d]);
  return raw;
}

// Four values (16 or 8 bytes) from global into shared memory; `bytes` of
// them read, the rest zero-filled.
template <typename E>
__device__ __forceinline__ void cp_async4(uint32_t dst, const E* src, int bytes) {
  if constexpr (sizeof(E) == 4) {
    cp_async16(dst, src, bytes);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  }
}

// Starts loading the batch of queries n0 .. n0 + 31 of row p into the stage
// st (zeros past N).  Rows: lane l loads query n0 + l, one vector; planes:
// lane l four consecutive queries of plane l / 8 (st as [4][32]).  The
// generic layout is read later, a value at a time (nothing staged).
template <typename E>
__device__ __forceinline__ void stage_batch(const E* __restrict__ p, int64_t sn, int64_t sd,
                                            int mode, int n0, int N, E* st) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(st));
  if (mode == kLoadRows) {
    const int n = n0 + lane;
    cp_async4<E>(base + lane * 4 * sizeof(E), n < N ? p + n * sn : p, n < N ? 4 * sizeof(E) : 0);
  } else if (mode == kLoadPlanes) {
    const int d = lane >> 3, m = (lane & 7) * 4, n = n0 + m;
    const int have = min(max(N - n, 0), 4);
    cp_async4<E>(base + (d * 32 + m) * sizeof(E), have ? p + d * sd + n : p,
                 have * static_cast<int>(sizeof(E)));
  }
}

// The D <= 4 values of query n0 + lane: from the stage (rows, planes) or
// from p (generic; zeros past D and past N).
template <typename E>
__device__ __forceinline__ void batch_values(const E* __restrict__ p, int64_t sn, int64_t sd,
                                             int D, int mode, int n0, int N, const E* st,
                                             float (&r)[4]) {
  const int lane = threadIdx.x & 31;
  if (mode == kLoadRows) {
    unpack4<E>(reinterpret_cast<const typename Raw4<E>::type*>(st)[lane], r);
    return;
  }
  if (mode == kLoadPlanes) {
#pragma unroll
    for (int d = 0; d < 4; ++d) r[d] = to_f(st[d * 32 + lane]);
    return;
  }
  const int n = n0 + lane;
#pragma unroll
  for (int d = 0; d < 4; ++d)  // unrolled: r stays in registers
    r[d] = d < D && n < N ? to_f(p[n * sn + d * sd]) : 0.f;
}

// dq of query n0 + lane into row p, rounded once, in the layouts the stages
// hold (planes: through st, the lane's values first, then four queries a
// lane).
template <typename E>
__device__ __forceinline__ void warp_store(E* __restrict__ p, int64_t sn, int64_t sd, int D,
                                           int mode, int n0, int N, E* st, const float (&r)[4]) {
  using V = typename Raw4<E>::type;
  const int lane = threadIdx.x & 31;
  if (mode == kLoadPlanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j * 32 + lane] = from_f<E>(r[j]);
    __syncwarp();
    const int d = lane >> 3, m = (lane & 7) * 4, n = n0 + m;
    E* dst = p + d * sd + n;
    if (n + 4 <= N) {
      *reinterpret_cast<V*>(dst) = *reinterpret_cast<const V*>(st + d * 32 + m);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < N) dst[i] = st[d * 32 + m + i];
    }
    return;
  }
  const int n = n0 + lane;
  if (n >= N) return;
  E* dst = p + n * sn;
  if (mode == kLoadRows) {
    *reinterpret_cast<V*>(dst) = pack4<E>(r);
  } else {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (d < D) dst[d * sd] = from_f<E>(r[d]);
  }
}

// The warp's row of slot j: a word pair's two rows (j = 2 jp, 2 jp + 1) lie
// TMAX / 2 rows apart, consecutive pairs in consecutive rows (one LDS.128 of
// eight pairs' first rows hits eight bank quads).
__host__ __device__ constexpr int warp_bwd_row(int j, int tmax) {
  return (j & 1) * (tmax / 2) + (j >> 1);
}

// The lane's query against NR word slots (a multiple of four, the slots
// past nreal masked: their score -inf, so P = dS = 0, their keys and values
// zeros), unrolled with no branch: the scores and dP in registers, the exact
// maximum, one exp2 a pair, then P, dS (into the warp's rows: dS of slot j
// at row warp_bwd_row(j), P TMAX rows on) and dq.  KV: the values are the
// keys (both samplers pass them so), read once.  A score is rounded once,
// as __fmul_rn (fmaf(x, c, 0) is the same rounding), so the largest word's
// weight is exp2(0) = 1 exactly and a one-word row's dS is exactly 0.
template <int NR, bool KV, int TMAX>
__device__ __forceinline__ void pairs(const float (&qv)[4], const float (&gv)[4],
                                      const float4* ks, const float4* vs, int nreal, float c2,
                                      float* ws, float (&dq)[4]) {
  float e[NR], dp[NR];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const float4 kk = ks[j];
    e[j] = fmaf(dot4(qv, kk), c2, j < nreal ? 0.f : -INFINITY);
    dp[j] = dot4(gv, KV ? kk : vs[j]);
    m = fmaxf(m, e[j]);
  }
  float l = 0.f, pdp = 0.f;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    e[j] = ex2(e[j] - m);
    l += e[j];
    pdp = fmaf(e[j], dp[j], pdp);
  }
  const float inv = 1.f / l;
  const float delta = pdp * inv;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const float pj = e[j] * inv;
    const float ds = pj * (dp[j] - delta);
    const float4 kk = ks[j];
    dq[0] = fmaf(ds, kk.x, dq[0]);
    dq[1] = fmaf(ds, kk.y, dq[1]);
    dq[2] = fmaf(ds, kk.z, dq[2]);
    dq[3] = fmaf(ds, kk.w, dq[3]);
    ws[warp_bwd_row(j, TMAX) * kWarpBwdPitch] = ds;
    ws[(TMAX + warp_bwd_row(j, TMAX)) * kWarpBwdPitch] = pj;
  }
}

// pairs over K steps of four slots (K <= TMAX / 4; larger K: never called).
template <int K, bool KV, int TMAX>
__device__ __forceinline__ void pairs_at(const float (&qv)[4], const float (&gv)[4],
                                         const float4* ks, const float4* vs, int nreal, float c2,
                                         float* ws, float (&dq)[4]) {
  if constexpr (4 * K <= TMAX) pairs<4 * K, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq);
}

// The body for the row's real words, in steps of four slots (uniform over
// the block).  Steps, not a body for each count: fewer bodies side by side
// on an SM, which the instruction cache holds (measured faster at the 64²
// step's mixed caption lengths, PERF.md).
template <bool KV, int TMAX>
__device__ __forceinline__ void pairs_for(int nreal, const float (&qv)[4], const float (&gv)[4],
                                          const float4* ks, const float4* vs, float c2,
                                          float* ws, float (&dq)[4]) {
  switch ((nreal + 3) / 4) {
    case 1: pairs_at<1, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 2: pairs_at<2, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 3: pairs_at<3, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 4: pairs_at<4, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 5: pairs_at<5, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 6: pairs_at<6, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 7: pairs_at<7, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    case 8: pairs_at<8, KV, TMAX>(qv, gv, ks, vs, nreal, c2, ws, dq); break;
    default: break;  // no real word: dq = 0
  }
}

// acc[r] += sum_{i0 <= i < i1} w_r[i] x[i], r = 0, 1, over a multiple of four
// queries: two rows of one kind (dS against the queries, or P against dO),
// four features each; one load of x[i] feeds both rows.
__device__ __forceinline__ void reduce_rows(const float* w0, const float* w1, const float4* x,
                                            int i0, int i1, float (&acc)[2][4]) {
  for (int i = i0; i < i1; i += 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(w0 + i);
    const float4 b4 = *reinterpret_cast<const float4*>(w1 + i);
    const float wa[4] = {a4.x, a4.y, a4.z, a4.w}, wb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 xi = x[i + u];
      acc[0][0] = fmaf(wa[u], xi.x, acc[0][0]);
      acc[0][1] = fmaf(wa[u], xi.y, acc[0][1]);
      acc[0][2] = fmaf(wa[u], xi.z, acc[0][2]);
      acc[0][3] = fmaf(wa[u], xi.w, acc[0][3]);
      acc[1][0] = fmaf(wb[u], xi.x, acc[1][0]);
      acc[1][1] = fmaf(wb[u], xi.y, acc[1][1]);
      acc[1][2] = fmaf(wb[u], xi.z, acc[1][2]);
      acc[1][3] = fmaf(wb[u], xi.w, acc[1][3]);
    }
  }
}

// One block per (b, g) row, D <= 4, T <= TMAX; each warp walks its 32-query
// batches, two staged ahead of the one it computes (see the backward's part
// of the header).  dk and dv are written dense, [B, G, T, D].
template <typename E, int TMAX>
__global__ void __launch_bounds__(64, TMAX <= 16 ? 11 : 8)
attn_bwd_warp(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
              const uint8_t* __restrict__ mask, const E* __restrict__ dout, E* __restrict__ dq,
              E* __restrict__ dk, E* __restrict__ dv, WarpBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pos[kWarpBwdMaxT];
  __shared__ int nreal_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int b = blockIdx.x / a.G, g = blockIdx.x - b * a.G;
  const int stride = warps * 32;  // a warp's batches: queries warp * 32 + stride i ...

  unsigned char* wb = smem + warp_bwd_head(TMAX) + warp * warp_bwd_warp_bytes(TMAX);
  float4* xq = reinterpret_cast<float4*>(wb);
  float4* xg = reinterpret_cast<float4*>(wb + 576);
  unsigned char* stages = wb + 1088;  // stage s at 1024 s bytes: q, then dO 512 bytes on
  float* ws = reinterpret_cast<float*>(stages + 1024 * kWarpBwdStages);
  const E* qb = q + b * a.qsb + g * a.qsg;
  const E* gb = dout + b * a.gsb + g * a.gsg;
  E* dqb = dq + b * a.dqsb + g * a.dqsg;
  auto stage = [&](int n0, int s) {  // batch n0 into stage s, one commit group
    if (n0 < a.N) {
      stage_batch<E>(qb, a.qsn, a.qsd, a.qmode, n0, a.N, reinterpret_cast<E*>(stages + 1024 * s));
      stage_batch<E>(gb, a.gsn, a.gsd, a.gmode, n0, a.N,
                     reinterpret_cast<E*>(stages + 1024 * s + 512));
    }
    cp_async_commit();
  };
  // the warp's first batches, in flight while the block stages the words
  for (int s = 0; s < kWarpBwdStages - 1; ++s) stage(warp * 32 + s * stride, s);

  // The row's real words: lane t of warp 0 reads word t's mask byte, key and
  // value at once (one round trip), the real ones compacted with a ballot
  // into slots as fp32; the slots past them zeros.
  float4* ks = reinterpret_cast<float4*>(smem);
  float4* vs = ks + TMAX;
  if (warp == 0) {
    float kr[4] = {0.f, 0.f, 0.f, 0.f}, vr[4] = {0.f, 0.f, 0.f, 0.f};
    bool real = false;
    if (lane < a.T) {
      real = mask[static_cast<int64_t>(b) * a.T + lane] == 0;
      const E* kp = k + b * a.ksb + g * a.ksg + lane * a.kst;
      const E* vp = v + b * a.vsb + g * a.vsg + lane * a.vst;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (d < a.D) {
          kr[d] = to_f(kp[d * a.ksd]);
          vr[d] = to_f(vp[d * a.vsd]);
        }
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, real);
    const int r = __popc(bits & ((1u << lane) - 1u)), nr = __popc(bits);
    pos[lane] = real ? r : -1;
    if (lane == 0) nreal_s = nr;
    if (real) {
      ks[r] = make_float4(kr[0], kr[1], kr[2], kr[3]);
      vs[r] = make_float4(vr[0], vr[1], vr[2], vr[3]);
    }
    if (lane >= nr && lane < TMAX) {  // the slots past the real words
      ks[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      vs[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const int nreal = nreal_s;

  // The lane's outputs: two rows of one kind, pair pr (words 2 jp and
  // 2 jp + 1; dS rows for pr < h, P rows after) over queries [i0, i1) of
  // each batch, `parts` lanes a pair, each a multiple of four queries.
  const int h = (nreal + 1) / 2, pairs2 = 2 * h;
  const int parts = pairs2 ? 32 / pairs2 : 0;
  const int len = parts ? ((32 + parts - 1) / parts + 3) & ~3 : 0;
  const int pr = pairs2 ? lane % pairs2 : 0, part = pairs2 ? lane / pairs2 : 0;
  const bool own = part < parts;
  const int kind = pr >= h, jp = pr - kind * h;
  const int i0 = min(part * len, 32), i1 = min(i0 + len, 32);
  const float* w0 = ws + (kind * TMAX + jp) * kWarpBwdPitch;
  const float4* x = kind ? xg : xq;

  const float c2 = a.scale * kLog2e;  // scores in log2 units
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  int s = 0;
  for (int n0 = warp * 32; n0 < a.N; n0 += stride, s = s == kWarpBwdStages - 1 ? 0 : s + 1) {
    // the batch two on into the stage freed last, while this one computes
    stage(n0 + (kWarpBwdStages - 1) * stride, s == 0 ? kWarpBwdStages - 1 : s - 1);
    cp_async_wait<kWarpBwdStages - 1>();
    __syncwarp();
    E* st = reinterpret_cast<E*>(stages + 1024 * s);
    E* st_g = reinterpret_cast<E*>(stages + 1024 * s + 512);
    float qv[4], gv[4];
    batch_values<E>(qb, a.qsn, a.qsd, a.D, a.qmode, n0, a.N, st, qv);
    batch_values<E>(gb, a.gsn, a.gsd, a.D, a.gmode, n0, a.N, st_g, gv);
    xq[lane] = make_float4(qv[0], qv[1], qv[2], qv[3]);  // zeros past N: add nothing below
    xg[lane] = make_float4(gv[0], gv[1], gv[2], gv[3]);
    float dqv[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.kv)
      pairs_for<true, TMAX>(nreal, qv, gv, ks, vs, c2, ws + lane, dqv);
    else
      pairs_for<false, TMAX>(nreal, qv, gv, ks, vs, c2, ws + lane, dqv);
#pragma unroll
    for (int d = 0; d < 4; ++d) dqv[d] *= a.scale;
    warp_store<E>(dqb, a.dqsn, a.dqsd, a.D, a.dqmode, n0, a.N, st, dqv);
    __syncwarp();
    // dk (dS rows against q) and dv (P rows against dO) over the batch
    if (own) reduce_rows(w0, w0 + (TMAX / 2) * kWarpBwdPitch, x, i0, i1, acc);
    __syncwarp();  // the tiles and this stage are free for the batch after next
  }
  cp_async_wait<0>();

  // Fold: each warp's lanes through its x tiles (a pair's first row in xq,
  // its second in xg), warps by index, parts in order.
  xq[lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  xg[lane] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  __syncthreads();
  const int64_t row = (static_cast<int64_t>(b) * a.G + g) * a.T;
  for (int i = tid; i < 2 * a.T; i += blockDim.x) {  // (dk or dv, word t): its D values
    const int which = i >= a.T, t = i - which * a.T, j = pos[t];
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    if (j >= 0) {
      const int o = which * h + j / 2;  // the pair, then its row
      for (int w = 0; w < warps; ++w) {
        const float4* f = reinterpret_cast<const float4*>(
            smem + warp_bwd_head(TMAX) + w * warp_bwd_warp_bytes(TMAX) + (j & 1) * 576);
        for (int p = 0; p < parts; ++p) {
          const float4 x4 = f[p * pairs2 + o];
          sum[0] += x4.x;
          sum[1] += x4.y;
          sum[2] += x4.z;
          sum[3] += x4.w;
        }
      }
    }
    const float sc = which ? 1.f : a.scale;
#pragma unroll
    for (int d = 0; d < 4; ++d) sum[d] *= sc;
    E* out = (which ? dv : dk) + (row + t) * a.D;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (d < a.D) out[d] = from_f<E>(sum[d]);
  }
}

// How a warp reads (and writes) an operand's queries at strides (sb, sg, sn,
// sd): as rows where each query's four values are one aligned vector, as
// planes where four consecutive queries of a plane are, else one value at a
// time.
template <typename E>
int warp_mode(const void* p, int D, int64_t sb, int64_t sg, int64_t sn, int64_t sd) {
  const bool aligned =
      D == 4 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(E)) == 0 && sb % 4 == 0 && sg % 4 == 0;
  if (aligned && sd == 1 && sn % 4 == 0) return kLoadRows;
  if (aligned && sn == 1 && sd % 4 == 0) return kLoadPlanes;
  return kLoadGeneric;
}

template <typename E, int TMAX>
int launch_bwd_warp(const void* q, const void* k, const void* v, const uint8_t* mask,
                    const void* dout, void* dq, void* dk, void* dv, const WarpBwdArgs& a,
                    int threads, int blocks, int smem, cudaStream_t stream) {
  const auto kern = attn_bwd_warp<E, TMAX>;
  // all shared memory, no L1: the one-wave launch needs 11 (8) blocks an SM
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), mask,
      static_cast<const E*>(dout), static_cast<E*>(dq), static_cast<E*>(dk),
      static_cast<E*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int bwd_warp(const void* q, const void* k, const void* v, const uint8_t* mask, const void* dout,
             void* dq, void* dk, void* dv, WarpBwdArgs a, int tmax, int threads, int blocks,
             int smem, cudaStream_t s) {
  a.qmode = warp_mode<E>(q, a.D, a.qsb, a.qsg, a.qsn, a.qsd);
  a.gmode = warp_mode<E>(dout, a.D, a.gsb, a.gsg, a.gsn, a.gsd);
  a.dqmode = warp_mode<E>(dq, a.D, a.dqsb, a.dqsg, a.dqsn, a.dqsd);
  return tmax == 16
             ? launch_bwd_warp<E, 16>(q, k, v, mask, dout, dq, dk, dv, a, threads, blocks, smem, s)
             : launch_bwd_warp<E, 32>(q, k, v, mask, dout, dq, dk, dv, a, threads, blocks, smem, s);
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
  if (kernel == 3 && dtype == 0)
    return short_launch<float>(q, k, v, mask, out, B, G, N, T, D, qsb, qsg, qsn, ksb, ksg, kst,
                               vsb, vsg, vst, osb, osg, osn, scale, threads, blocks, tile, s);
  if (kernel == 3)
    return short_launch<__nv_bfloat16>(q, k, v, mask, out, B, G, N, T, D, qsb, qsg, qsn, ksb,
                                       ksg, kst, vsb, vsg, vst, osb, osg, osn, scale, threads,
                                       blocks, tile, s);
  Args a{G, N, T, D, 0, qsb, qsg, qsn, ksb, ksg, kst, vsb, vsg, vst, osb, osg, osn, scale};
  if (dtype == 0) return launch<float>(q, k, v, mask, out, B, a, kernel, threads, blocks, tile, s);
  return launch<__nv_bfloat16>(q, k, v, mask, out, B, a, kernel, threads, blocks, tile, s);
}

extern "C" int xmc_cross_attention_bwd(
    const void* q, const void* k, const void* v, const uint8_t* mask, const void* dout, void* dq,
    void* dk, void* dv, int B, int G, int N, int T, int D, int64_t qsb, int64_t qsg, int64_t qsn,
    int64_t qsd, int64_t ksb, int64_t ksg, int64_t kst, int64_t ksd, int64_t vsb, int64_t vsg,
    int64_t vst, int64_t vsd, int64_t gsb, int64_t gsg, int64_t gsn, int64_t gsd, int64_t dqsb,
    int64_t dqsg, int64_t dqsn, int64_t dqsd, float scale, int dtype, int dmax, int threads,
    int blocks, int smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (D < 1 || D > kBwdMaxD || T < 0 || T > kBwdMaxT || G < 1 || N < 0 || B < 0 ||
      (dtype != 0 && dtype != 1))
    return bad;
  const int want_dmax = D <= 4 ? 4 : D <= 8 ? 8 : D <= 16 ? 16 : 32;
  const int n32 = N > 32 ? (N + 31) / 32 * 32 : 32;
  const int want_threads = bwd_tile(T) < n32 ? bwd_tile(T) : n32;
  if (dmax != want_dmax || threads != want_threads ||
      static_cast<int64_t>(blocks) != static_cast<int64_t>(B) * G ||
      static_cast<size_t>(smem) != bwd_smem(T, dmax, threads))
    return bad;
  if (B == 0) return 0;
  const BwdArgs a{G,   N,   T,   D,   threads, qsb, qsg,  qsn,  qsd,  ksb,  ksg,  kst, ksd,
                  vsb, vsg, vst, vsd, gsb,     gsg, gsn,  gsd,  dqsb, dqsg, dqsn, dqsd, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? bwd<float>(q, k, v, mask, dout, dq, dk, dv, a, dmax, blocks, smem, s)
             : bwd<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, a, dmax, blocks, smem, s);
}

extern "C" int xmc_cross_attention_bwd_long(
    const void* q, const void* k, const void* v, const uint8_t* mask, const void* dout, void* dq,
    void* dk, void* dv, void* scratch, int B, int G, int N, int T, int D, int64_t qsb,
    int64_t qsg, int64_t qsn, int64_t qsd, int64_t ksb, int64_t ksg, int64_t kst, int64_t ksd,
    int64_t vsb, int64_t vsg, int64_t vst, int64_t vsd, int64_t gsb, int64_t gsg, int64_t gsn,
    int64_t gsd, int64_t dqsb, int64_t dqsg, int64_t dqsn, int64_t dqsd, float scale, int dtype,
    int dmax, int threads, int blocks, int smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (D < 1 || D > kBwdMaxD || T <= kBwdMaxT || G < 1 || N < 0 || B < 0 ||
      (dtype != 0 && dtype != 1))
    return bad;
  const int want_dmax = D <= 4 ? 4 : D <= 8 ? 8 : D <= 16 ? 16 : 32;
  if (dmax != want_dmax || threads != long_threads(N) ||
      static_cast<int64_t>(blocks) != static_cast<int64_t>(B) * G ||
      static_cast<size_t>(smem) != long_smem(T, dmax, threads) ||
      (scratch == nullptr) != long_acc_shared(T, dmax, threads))
    return bad;
  if (B == 0) return 0;
  const BwdArgs a{G,   N,   T,   D,   threads, qsb, qsg,  qsn,  qsd,  ksb,  ksg,  kst, ksd,
                  vsb, vsg, vst, vsd, gsb,     gsg, gsn,  gsd,  dqsb, dqsg, dqsn, dqsd, scale};
  float* acc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_long<float>(q, k, v, mask, dout, dq, dk, dv, acc, a, dmax, blocks,
                                      smem, s)
                    : bwd_long<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, acc, a, dmax,
                                              blocks, smem, s);
}

extern "C" int xmc_cross_attention_bwd_warp(
    const void* q, const void* k, const void* v, const uint8_t* mask, const void* dout, void* dq,
    void* dk, void* dv, int B, int G, int N, int T, int D, int64_t qsb, int64_t qsg, int64_t qsn,
    int64_t qsd, int64_t ksb, int64_t ksg, int64_t kst, int64_t ksd, int64_t vsb, int64_t vsg,
    int64_t vst, int64_t vsd, int64_t gsb, int64_t gsg, int64_t gsn, int64_t gsd, int64_t dqsb,
    int64_t dqsg, int64_t dqsn, int64_t dqsd, float scale, int dtype, int tmax, int threads,
    int blocks, int smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (D < 1 || D > kWarpBwdMaxD || T < 0 || T > kWarpBwdMaxT || G < 1 || N < 0 || B < 0 ||
      (dtype != 0 && dtype != 1))
    return bad;
  const int want_tmax = T <= 16 ? 16 : 32;
  const int want_threads = N <= 32 ? 32 : 64;
  if (tmax != want_tmax || threads != want_threads ||
      static_cast<int64_t>(blocks) != static_cast<int64_t>(B) * G ||
      smem != warp_bwd_smem(tmax, threads / 32))
    return bad;
  if (B == 0) return 0;
  const int kv = k == v && ksb == vsb && ksg == vsg && kst == vst && ksd == vsd;
  const WarpBwdArgs a{G,   N,   T,   D,   kv,  0,   0,    0,    qsb,  qsg,  qsn,
                      qsd, ksb, ksg, kst, ksd, vsb, vsg,  vst,  vsd,  gsb,  gsg,
                      gsn, gsd, dqsb, dqsg, dqsn, dqsd, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_warp<float>(q, k, v, mask, dout, dq, dk, dv, a, tmax, threads, blocks,
                                      smem, s)
                    : bwd_warp<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, a, tmax, threads,
                                              blocks, smem, s);
}
