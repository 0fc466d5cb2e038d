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
// against 67 TFLOP/s fp32 on the CUDA cores, 989 TFLOP/s bf16 on the tensor
// cores.  Route (the wrapper's rule per kernel, ops/cuda/damsm_score.py
// route): every kernel at D > 1024 runs on the feature-streamed CUDA-core
// kernels ("The feature-streamed kernels", either dtype); below that the
// bf16 forward, d_regions and d_words run on the tensor cores
// where R <= 256 (the forward and d_regions with the regions
// resident in shared memory at D <= 256, streamed through it above; the
// d_words streams them at every D: their own sections below); the fp32
// forward, d_regions and d_words at R <= 256, D <= 1024 on the CUDA cores in
// passes of packed real words with the regions streamed ("The fp32
// d_regions", "The fp32 forward" at D <= 256, "The wide fp32 forward and
// d_regions" above it, "The fp32 d_words" at every D); every kernel at
// wider R on the CUDA-core kernels that take a caption sub-block per block
// (fp32 keeps 1e-5 against its plain version, which TF32 would not).
// Captions
// longer than a block's rows reach the kernels as sub-captions: the wrapper
// splits each caption's T slots into pieces of at most 64 and combines
// their scores by a logsumexp (exact: words are independent until the
// logsumexp over T), so every kernel here sees T <= 64.
// Design of the CUDA-core kernels, a first, simple and correct version:
//  * A block takes one image and a sub-block of vb captions (vb*T <= 64 word
//    rows), keeps the words, the [rows, R] similarity/attention (and, in the
//    backward, its cotangent) and the [rows, D] context in shared memory,
//    and streams the image's regions through a 32-row shared tile, three or
//    four times per sub-block (the regions of one image, 256 KB in fp32, do
//    not fit in the 227 KB a block can have).  vb is the largest that fits:
//    3 captions forward, 2 backward at T = 20, D = R = 256.
//  * D <= 1024: a lane holds 8 columns of a context product (c = a R,
//    d_sim R, the d_r sums), so those products run in 256-column chunks,
//    streaming the chunk's columns of the region tiles again for each.  At
//    D = 768, R = 256 a block holds 18 word rows forward, 16 backward (one
//    16-slot sub-caption of the LN config's T = 200).
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
// The bf16 kernels on the tensor cores: the forward (damsm_fwd_tc_kernel) and
// d_regions (damsm_bwd_dr_tc_kernel) at R, D <= 256, and the streamed forward
// (damsm_fwd_tcs_kernel) and d_regions (damsm_bwd_dr_tcs_kernel) at
// 256 < D <= 1024.  What the first two share (the streamed ones keep all of
// it but the resident regions):
//  * Products are mma.sync.m16n8k16 bf16 tiles with fp32 accumulators;
//    operands are bf16 in shared memory, read with ldmatrix (.trans where
//    the contraction runs along a tile's rows).
//  * Block = (image i, split of the captions); the image's regions stay
//    resident in shared memory for all of the block's passes.  A pass packs
//    the real words of whole captions, in order, into Mp = 16..64 word rows
//    (tc_pack_pass: padded words and all-padded captions take no row) and
//    runs the chain to rel (tc_attend) with the [Mp, R] similarity /
//    attention and the [Mp, D] context held in registers (a warp owns 8-wide
//    column tiles; row sums and maxima go through the quad and a [warps][Mp]
//    shared array in a fixed order).
//  * Mp is the largest of 64/48/32/16 that fits in shared memory and holds
//    T; R, D <= 256, T <= 64.  One block per multiprocessor (shared memory),
//    so the splits fill the card once (wrapper: nsplit = max(1, SMs / B)).
//  * Shared memory: bf16 strides padded by 8 so ldmatrix is conflict-free;
//    Rp, Dp = R, D rounded up to 16; the regions take Rp*(Dp+8)*2.
//  * Rounding points: as the plain version (operands r, w, a and c_hat in
//    bf16), not the Pallas forward, which keeps c_hat fp32 for rel.
//  * Deterministic: no atomics, fixed reduction orders.
//
// The forward (damsm_fwd_tc_kernel):
//  * Per pass: sim = W R^T and c = rnd(a) R (2 products), the softmax, the
//    norm and rel, then each caption of the pass writes its score, the
//    logsumexp over its real words of g2 * rel, / g2, to out[i][j] with one
//    warp.  A padded word adds exp(-1e30 - max) = 0 to the plain version's
//    sum, so packing only the real words changes nothing.  An all-padded
//    caption takes no row: the block writes the plain version's
//    (-1e30 + log T) / g2 for it before its passes.
//  * Shared memory: regions, words Mp*(Dp+8)*2, a Mp*(Rp+8)*2 and 14*Mp+4
//    fp32/int words (rel, the warps' row partials, the row map).  At
//    R = D = 256, Mp = 64: 135,168 + 67,584 + 3,600 = 206,352 of the 232,448
//    bytes a block may have, so 23 passes per image of whole captions at the
//    flagship's 1,262 real words of 128 captions (d_regions: 48).
//  * Bound: 2*R*D*2 operations per real word and image, 43 GFLOP at the
//    flagship, over 989 TFLOP/s: 0.043 ms; its ~18 MB of inputs and
//    scores take 0.005 ms at 3.35 TB/s.  What holds it back
//    (xmc_gan_tpu_torch/damsm_phases.py): the two products' phases, sim +
//    softmax and c + rel, ~72% of the cycles; then loading the words and
//    warp 0's pack, ~22%, during which the tensor cores idle.
//
// The d_regions (damsm_bwd_dr_tc_kernel):
//  * Products: all five (sim = W R^T, c = rnd(a) R, d a = d_c R^T, and
//    rnd(a)^T d_c + d_sim^T W into d_r).  A padded word's d rel is 0, so it
//    adds exactly 0 to d_r.  After the chain to rel each pass runs the
//    softmax backward and adds its part into the block's exclusive fp32
//    slice of partial (first pass: store).  A warp takes 16 x 64 of d_r at a
//    time, loads the slice's earlier sums before its products and moves its
//    accumulators through a shared staging tile, so the slice's
//    read-modify-write is 16-byte and row-contiguous; then sum_splits.
//  * Shared memory: regions, words and d_c 2*Mp*(Dp+8)*2, a and d_sim
//    2*Mp*(Rp+8)*2, 8 staging tiles 8*16*36*4, and 15*Mp+4 fp32/int words.
//    At R = D = 256: 135,168 + Mp*2,112 + 18,432 + 60*Mp + 16, so Mp = 32
//    (223,120 B; 48 would need 257,872).  At the flagship shape 128 blocks
//    each run ~48 passes of ~26 real words.
//  * Bound: the same 215 GFLOP-class count of products (for the real words
//    only: 2*R*D*5*words*B), over 989 TFLOP/s.  What holds it back
//    (xmc_gan_tpu_torch/damsm_phases.py): the products themselves, issued
//    as mma.sync from ldmatrix at a small share of the tensor rate, the d_r
//    ones most; then the per-pass d_r read-modify-write (R*D*4 bytes read
//    and written per pass).
//  * Rounding points: besides the shared ones, d c_hat and d a rounded to
//    bf16 as autograd of the plain version rounds them, and, as the Pallas
//    kernel does (xmc_gan_tpu/ops/pallas/damsm_score.py: d_c.astype(st),
//    d_sim.astype(cd)), d_c and d_sim rounded to bf16 before their products,
//    where the plain version keeps them fp32.  On the card this stays within
//    one bf16 ulp (2^-7) of the largest gradient (chip_smoke.py phase 3
//    prints the error).
//
// The streamed d_regions (damsm_bwd_dr_tcs_kernel), 256 < D <= 1024, R <= 256:
//  * The same blocks, passes, products, rounding points and d_r
//    accumulation as damsm_bwd_dr_tc_kernel, but the image's bf16 regions
//    (397 KB at R = 256, D = 768) do not fit in a block's shared memory: they
//    stream through it in TCS_KC = 64-column chunks, double-buffered with
//    cp.async (16-byte, zero-filled past R and D; plain loads where rows are
//    not 16-byte aligned), once for each product that reads them: sim = W R^T
//    and d a = d_c R^T add each chunk's contraction into the [Mp, R] tiles in
//    registers; c = rnd(a) R takes a chunk of columns at a time, and the
//    pass's [Mp, D] fp32 context stays in registers (a warp owns n-tile
//    q * 8 + warp of chunk q: 12 n-tiles, 96 fp32 a thread at Mp = 32,
//    D = 768), so the norm, rel, c_hat . d c_hat and d_c, each a reduction
//    over all of D, need no second product.  The d_r products read W, DC, P
//    and DS, already in shared memory; their staging tiles reuse the region
//    buffers.  Padded columns (D to Dp, Dp to the chunk's end) are 0 in the
//    regions and the words, so they add exactly 0 to sim, |c|, rel and d_r.
//  * Shared memory: words and d_c 2*Mp*(Dp+8)*2, a and d_sim 2*Mp*(Rp+8)*2,
//    then max(two region buffers 2*Rp*(TCS_KC+8)*2, 8 staging tiles
//    8*16*36*4), and 15*Mp+4 fp32/int words.  At R = 256, D = 768, Mp = 32:
//    99,328 + 33,792 + 73,728 + 1,936 = 208,784 bytes; at D = 1024, 32 rows
//    need 241,552, so Mp = 16 (157,648).  Mp <= 32: the context registers.
//  * Bound: the same count of products (5 per real word and image), 12.9 ms
//    at the LN word shape (B = Bc = 256, 25,300 real words) over 989 TFLOP/s.
//    What holds it back (xmc_gan_tpu_torch/damsm_phases.py, at that shape,
//    ~860 passes an image): the products, ~43% of the cycles, c = rnd(a) R
//    and the d_r pair the most; streaming the regions, ~20%, nearly all of
//    it in issuing the chunks' cp.async (the product phases include it);
//    the per-pass read-modify-write of the block's [R, D] fp32 d_r slice
//    (1.57 MB), ~18%; the two sweeps over D, ~11%.
//
// The fp32 d_regions (damsm_bwd_dr_f32_kernel), R, D <= 256, on the CUDA cores:
//  * The tensor-core kernels' blocks (image, split), passes of packed real
//    words (tc_pack_pass, Mp = 48 rows) and d_r slices, so a
//    padded word takes no row and at the flagship one split of all 128
//    captions per image: no partial buffer, no sum_splits.
//  * fp32 operands and sums throughout, the math of damsm_bwd_dr_kernel<float>
//    but for one reciprocal a row in place of divisions (a, c_hat, d_c).
//  * The image's fp32 regions (256 KB) do not fit beside the pass's tiles:
//    they stream through two 36 KB buffers with 16-byte cp.async, one
//    barrier a chunk, the next chunk loading under the current one's
//    products, once for each product that reads them: sim = W R^T and
//    d a = d_c R^T over 32-column chunks, c = a R over 32-row chunks, so
//    each product keeps its [Mp, 256] sums in registers across the chunks.
//  * Register tiles: a thread owns 6 rows x 8 columns of each [Mp, 256]
//    product (f32_rg, f32_cg) and 8 x 8 of each 128 x 128 tile of d_r, and
//    reads both operands as 16-byte rows (MT + 8 loads for 32 MT FMAs; 8 for
//    128 in d_r); strides of 260 and 36 floats keep a warp's 16-byte loads
//    in distinct bank groups.  The k loops of a chunk are not unrolled: at
//    ~130 KB the kernel's code does not stay in the instruction cache, and
//    less code ran faster (PERF.md).
//  * d_r: each pass adds A^T DC + DS^T W into the block's exclusive slice
//    (read-modify-write, no atomics, fixed order), a 128 x 128 tile at a
//    time, its earlier sums loaded before the products.
//  * Shared memory: words, d_c and a 3*Mp*260*4, the chunk buffers
//    2*256*36*4 (d_sim takes their place for the d_r accumulation) and 11*Mp+4
//    fp32/int words: 225,616 bytes at Mp = 48, the same at every R and D.
//  * Bound: 5 products per real word and image, 1.58 ms at the flagship
//    (106 GFLOP) over 67 TFLOP/s.  What holds it back
//    (xmc_gan_tpu_torch/damsm_phases.py): the products, ~50% of the FMA rate
//    each, ~83% of the cycles; the packing leaves ~15% of a pass's rows empty.
//
// The fp32 forward (damsm_fwd_f32_kernel), R, D <= 256, on the CUDA cores:
//  * The fp32 d_regions' blocks (image, split), passes of packed real words
//    and chain to rel (f32_attend: sim over 32-column chunks, the softmax, c
//    over 32-row chunks, the norm and rel), then the tensor-core forward's
//    scores: each caption of the pass writes the logsumexp over its real
//    words of g2 * rel, / g2, with one warp; an all-padded caption takes no
//    row and gets the plain version's (-1e30 + log T) / g2 before the passes.
//  * Mp = F32_FWD_ROWS = 64 word rows a pass (MT = 8: 8 x 8 accumulators a
//    thread); 64 beat 48 rows in turns on the H100 (PERF.md).
//  * Shared memory: the d_regions' carve without its d_c tile (f32_carve):
//    words and a 2*Mp*260*4, the chunk buffers 2*256*36*4 and 11*Mp+4
//    fp32/int words, 209,680 bytes at Mp = 64.
//  * Bound: 2 products per real word and image, 0.63 ms at the flagship
//    (42 GFLOP) over 67 TFLOP/s.
//
// The streamed forward (damsm_fwd_tcs_kernel), 256 < D <= 1024, R <= 256:
//  * The same blocks, passes, rounding points, all-padded captions and
//    scores as damsm_fwd_tc_kernel, and the streamed d_regions' chain to rel
//    (tcs_attend, shared with it): the regions stream through the two chunk
//    buffers twice a pass (sim = W R^T, then c = rnd(a) R into the [Mp, D]
//    fp32 context in registers), then the norm and rel sweep over D.  No
//    d_c, d_sim, staging tiles or d_r slice.
//  * Shared memory: words Mp*(Dp+8)*2, a Mp*(Rp+8)*2, two region buffers
//    2*Rp*(TCS_KC+8)*2 and 14*Mp+4 fp32/int words.  At R = 256, D = 768,
//    Mp = 32: 49,664 + 16,896 + 73,728 + 1,808 = 142,096 bytes (D = 1024:
//    158,480).  Passes are always Mp = 32 (TCS_FWD_ROWS): 16-row passes
//    (107,792 bytes, two blocks a multiprocessor) timed no faster at the LN
//    shape (PERF.md), so tcs_dims_ok refuses them for the forward.
//  * Bound: 2 products per real word and image, 5.2 ms at the LN word shape
//    (B = Bc = 256, R = 256, D = 768, 25,300 real words) over 989 TFLOP/s.
//
// The wide fp32 forward and d_regions (damsm_fwd_f32w_kernel,
// damsm_bwd_dr_f32w_kernel), 256 < D <= 1024, R <= 256, on the CUDA cores:
//  * The fp32 kernels' passes of packed real words (tc_pack_pass), register
//    tiles (f32_by_cols, f32_by_rows: 4 or 3 rows x 8 columns a thread),
//    double-buffered cp.async chunk buffers (f32_sweep; plain loads where
//    rows are not 16-byte aligned), softmax, d_sim and d_r tiles, and the
//    one reciprocal a row.  Blocks are (image, split), as the other packed
//    kernels'.
//  * Shared memory: the pass's words [Mp][SW] (SW = D rounded up to 256,
//    + 4) beside a [Mp][260], the chunk buffers 2*256*36*4 and 11*Mp+4
//    fp32/int words.  At D = 768, Mp = 32: 98,816 + 33,280 + 73,728 + 1,424
//    = 207,248 of the 232,448 bytes a block may have; D > 768 (SW = 1028)
//    takes Mp = 24: 198,448.  The [Mp, D] context fits neither beside the
//    words (another 98,816 bytes) nor in registers (96 a thread), so
//    neither kernel stores it:
//  * The chain to rel (f32w_attend): sim = W R^T over D / 32 column chunks
//    (one pass over the regions); a = softmax into A; then c = a R a group
//    of 256 features at a time over that group's R / 32 row chunks (a
//    second pass over the regions), each group folded into |c|^2 and c . w
//    as it completes, so rel = (c . w) / max(|c|, 1e-12).  The forward then
//    writes the scores as the fp32 forward does (all-padded captions: the
//    plain value before the passes).
//  * d_regions: d_c = d rel inrm (w - rel inrm c) needs, per feature, only
//    c, w and row scalars, so one more sweep takes a group's row chunks (c
//    again), writes d_c over the group's words in W, and takes the group's
//    column chunks for d a += d_c R^T (a third and fourth pass over the
//    regions: 6 products a pass against the 5 the bound counts); d_sim goes
//    into the chunk buffers, and d_r += A^T DC + DS^T W a group at a time
//    with the group's words loaded again beside d_sim ([Mp][260]).  The d_r
//    slice's read-modify-write (R*D*8 bytes a pass) stays once a pass: at
//    32 rows a pass and ~800 passes an image it moves ~1.57 MB a pass.
//  * Bound: 2 (forward) and 5 (d_regions) products per real word and image,
//    76.1 and 190.2 ms at the LN word shape (B = Bc = 256, R = 256, D = 768,
//    25,317 real words) over 67 TFLOP/s.
//
// The bf16 d_words (damsm_bwd_dw_tcs_kernel), R <= 256, D <= 1024, on the
// tensor cores (replaces the CUDA-core damsm_bwd_dw_kernel there, which
// recomputed the chain per caption sub-block and read-modify-wrote its d_w
// slice in device memory for every image):
//  * d_words sums over images, so the d_regions' structure turns around:
//    block = (pass p, split of the images).  A pass packs the real words of
//    whole captions (tc_pack_pass, Mp rows); damsm_dw_passes_kernel first
//    cuts the Bc captions into passes where tc_pack_pass would (one block,
//    the captions' word counts, then one thread's scan) and the grid has a
//    block for every caption, the ones past the last pass returning at once.
//  * The pass's words stay in shared memory for all of the split's images;
//    each image's regions stream through the two chunk buffers four times
//    (sim = W R^T and c = rnd(a) R in tcs_attend, d a = d_c R^T, d_sim R).
//    d_c goes to the d a product a 64-column chunk at a time (each warp
//    writes its n-tile of the chunk from registers, where it holds d_c as
//    bf16 pairs), so no [Mp, D] d_c tile is needed.
//  * d_w (fp32) stays on chip across the split's images, in the context's
//    layout (a warp owns n-tile q * 8 + warp of chunk q): the first QREG
//    chunks in registers, the rest in shared memory.  Each image adds
//    d rel rnd(c_hat) and d_sim R into it; after the last image the block
//    stores the pass's rows once, each element once, into its split's
//    exclusive slice of partial [nsplit, Bc, T, D], and 0 into the padded
//    slots of the pass's captions; sum_splits adds the splits in a fixed
//    order.  No atomics: bit-equal run to run.
//  * Rounding points: those of the d_regions (d c_hat, d a, and as the
//    Pallas kernel d_c and d_sim rounded to bf16 before their products);
//    d rel rnd(c_hat) in fp32, as the plain version.
//  * Mp, and QREG by the region chunks a pass's context takes: 64 rows at
//    D <= 256, 32 at D <= 768 (QREG = 2), 16 at D <= 1024; three kernels
//    (NQ = 4, 12, 16), each instance adding to the build's nvcc time.
//  * Shared memory: words Mp*(Dp+8)*2, a / d_c chunk / d_sim
//    Mp*max(Rp+8, 72)*2, the region buffers 2*Rp*72*2, d_w past the QREG
//    chunks Mp*((nq-QREG)*64+8)*4 and 15*Mp+4 fp32/int words: at R = 256,
//    D = 768, Mp = 32: 49,664 + 16,896 + 73,728 + 82,944 + 1,936 = 225,168
//    bytes (all of d_w in shared memory: 241,552, more than a block may
//    have); at D = 256, Mp = 64: 212,752.
//  * Bound: 4 products per real word and image (sim, c, d a, d_sim R), 0.086
//    ms at the flagship and 10.3 ms at the LN word shape over 989 TFLOP/s.
//    The split of the images: passes x splits about fill the card, from
//    passes counted as if every slot held a word (the wrapper's plan_dw).
//
// The fp32 d_words (damsm_bwd_dw_f32_kernel), R <= 256, D <= 1024, on the CUDA
// cores (replaces damsm_bwd_dw_kernel<float> there, for the same reason as
// the bf16 one):
//  * The bf16 d_words' blocks (pass p, split of the images), its passes
//    (damsm_dw_passes_kernel, tc_pack_pass) and its one store of d_w per
//    block into the split's slice of partial (padded slots 0, sum_splits in
//    a fixed order, no atomics), on the fp32 packed kernels' parts: the
//    pass's fp32 words stay in shared memory, each image's regions stream
//    through the two chunk buffers (f32_sweep), the products are
//    f32_by_cols / f32_by_rows.
//  * Per image: the wide kernels' chain to rel (f32w_chain, one group of 256
//    features at D <= 256), keeping the last group's context in registers;
//    d rel; d_c a group at a time into a [Mp][260] tile as the wide
//    d_regions takes it (f32w_dc), the last group's from the kept context,
//    every other group's after its row chunks again, each group's column
//    chunks then adding d_c R^T into d a (one sweep); d_sim over a; and
//    d_w += d rel c_hat (beside each d_c) + d_sim R (the row chunks of each
//    group).  The products: sim, c, d a and d_sim R, and the context again
//    for every group but the last: 4 at D <= 256, 4.67 at D = 768.
//  * d_w (fp32) stays on chip across the split's images in the products'
//    register layout (a thread owns rows rg + 8 i, features 4 cg + 128 h
//    + e of each group): the last group in registers, the others in
//    shared memory [Mp][(ng - 1) * 256 + 4], each element read and written
//    only by its thread.
//  * Shared memory: words [Mp][SW] (SW as the wide kernels'), a (d_sim in
//    its place) and a d_c group [Mp][260] each, d_w's shared groups, the
//    chunk buffers 2*256*36*4 and 11*Mp+4 fp32/int words: Mp = 32 at
//    D <= 256 (174,992 bytes), 16 above (D = 768: 190,160; D = 1024:
//    222,928; 24 rows at D = 768 would need 248,368).
//  * Bound: 4 products per real word and image, 1.264 ms at the flagship
//    and 152.1 ms at the LN word shape (B = Bc = 256) over 67 TFLOP/s.
//
// The feature-streamed kernels (damsm_fwd_fs_kernel, damsm_bwd_dr_fs_kernel,
// damsm_bwd_dw_fs_kernel), route 3: every launch at D > 1024, any R, either
// dtype, on the CUDA cores.  A first, simple and correct version: the other
// kernels keep [rows, D] tiles (words, context, d_c) in shared memory or
// registers, which no width past 1,024 features fits beside the rest.
//  * Blocks as the CUDA-core kernels': the forward and d_regions (image i,
//    caption sub-block of vb captions, M = vb*T <= 64 word rows; the
//    d_regions' block takes all sub-blocks of the image, in order, no
//    split), the d_words (caption sub-block, split of the images).  vb is
//    the largest that fits (plan_fs): no term of the shared memory depends
//    on D, so R alone limits the rows.  512 threads (16 warps, 4 rows a
//    warp): the backward's shared memory holds one block a multiprocessor.
//  * Shared memory: the [M, SR] sim / attention (and in the backward its
//    cotangent) stays; every product streams the features a chunk of
//    FS_KF = 128 at a time: the chunk's words Wc [M][132] (and d_c DC) and a
//    tile of 32 region rows of the chunk's columns Rt [32][132], zero past
//    R and D, each tile's loads issued into registers under the previous
//    tile's products (fs_region_tiles).  At R = 256: 110,976 bytes forward
//    at 3 captions of 20 words (M = 60), 204,096 backward; 64 rows fit up
//    to R = 256 backward, 59 at R = 300, one up to R = 26,784.
//  * The chain, one sweep over the regions per product, each a chunk at a
//    time: sim = W R^T accumulated into S; the softmax (columns past R
//    ignored, 0); then c = rnd(a) R chunk by chunk, folded as it completes
//    into |c|^2 and c . w per row (a lane's columns in order, then a warp
//    sum), so rel = c . w / max(|c|, 1e-12) and the context is never stored
//    whole.  The bf16 forward sweeps once more for rel = sum rnd(c_hat) w,
//    as the plain version rounds c_hat (the scores' tolerance is 2^-12);
//    the backward keeps the fp32 c_hat's rel, as the Pallas kernel computes
//    it, and <c_hat, d c_hat> = d rel * rel, both dtypes (the bf16
//    gradients within a bf16 ulp of the largest).  Then c once more,
//    d_c = (d c_hat - c_hat <c_hat, d c_hat>) / |c| a chunk at a time into
//    DC, each chunk's d a = d_c R^T added into DA; d sim from rnd(d a).
//    Rounding points of the bf16 CUDA-core kernels (the plain version's
//    autograd) otherwise: w, r, a operands, c_hat for d_w, d c_hat = rnd(d
//    rel w), d a; d_c and d sim stay fp32.
//  * d_regions: after each chunk's d_c, rnd(a)^T d_c into the chunk's
//    columns of the image's d_r, then d sim^T W a chunk at a time: a warp
//    takes 8 consecutive regions x 4 columns a lane, read-modify-write of
//    the block's own [R, D] (the output: no split, no scratch, no
//    atomics), first sub-block stores, the rest add in caption order, so a
//    row block of images is bit-equal to those rows of the whole launch.
//  * d_words: d rel rnd(c_hat) as d_c forms, then d sim R a chunk at a time,
//    added into the split's exclusive slice of partial [nsplit, Bc, T, D]
//    (zeroed first; padded slots stay 0), images in order; sum_splits adds
//    the splits in a fixed order.  The splits fill the card with the
//    sub-blocks in one wave, the scratch within 256 MiB (fs_nsplit).
//  * Products: forward 2 (bf16 3), d_regions 6, d_words 5 per word row and
//    image against the bound's 2, 5 and 4; all rows of a sub-block, padded
//    words too.  Every size_t-indexed: a [B, R, D] input at B = 128,
//    R = 256, D = 4096 has 1.3e8 elements.
//
// C interface (ctypes; pointers and the stream as void*):
//   int xmc_damsm_fwd(r, w, mask, out, B, Bc, R, T, D, vb, rows, nsplit, g1, g2,
//                     dtype, route, stream)
//   int xmc_damsm_bwd_dr(r, w, mask, g, partial, dr, B, Bc, R, T, D, vb, rows,
//                        nsplit, g1, g2, dtype, route, stream)
//   int xmc_damsm_bwd_dw(r, w, mask, g, plan, partial, dw, B, Bc, R, T, D, vb,
//                        rows, nsplit, g1, g2, dtype, route, stream)
//   g is the upstream cotangent [B, Bc] fp32.  partial is [B, nsplit, R, D]
//   (d_regions) or [nsplit, Bc, T, D] (d_words) fp32 scratch; with
//   nsplit == 1 it may be the output itself.  plan is [Bc + 2] int32 scratch
//   for the packed d_words' passes (routes 1 and 2; unused elsewhere).
//   dtype 0 = fp32, 1 = bf16.  route 0 = the CUDA-core kernel (either
//   dtype), 1 = the tensor-core one (bf16 only; the forward's and d_regions'
//   streamed kernel for D > 256), 2 = the fp32 kernel with packed words
//   (fp32 only, R <= 256, D <= 1024; the wide forward and d_regions for
//   D > 256), 3 = the feature-streamed kernel (either dtype, any R and D;
//   the wrapper's route for D > 1024).  vb is the captions per block of the
//   CUDA-core and feature-streamed kernels; rows
//   is the word rows per pass, Mp, of the tensor-core kernels (route 1) and
//   of the fp32 ones (route 2), whose forward and d_regions blocks are
//   (image, split) for nsplit splits, the d_words' (pass, split).
//   Each is ignored where the other applies.
//   Returns cudaGetLastError() after the launches (0 = success).  Built with
//   -DXMC_DAMSM_PART=1, 2 or 3, only the first, second or third of them.
//   Built with -DXMC_DAMSM_PHASES, the tensor-core kernels and the fp32
//   forward, d_regions and d_words also count their cycles per phase: int
//   xmc_damsm_phases_read(host [24] uint64),
//   int xmc_damsm_phases_reset() (xmc_gan_tpu_torch/damsm_phases.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RT = 32;         // region rows per staged tile (one per lane)
constexpr int MAX_ROWS = 64;   // word rows per block: 8 warps x MB rows
constexpr int MAX_DP = 1024;   // padded feature width
constexpr int CHUNK = 256;     // columns of the context products per pass: 8 per lane
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

// Columns k0 .. k1-1 of region rows r0 .. r0+RT-1 of image i into Rt (rows
// past R and columns past D are 0).
template <typename T>
__device__ void load_tile(const T* __restrict__ r, int i, int r0, const Dims& d, float* Rt,
                          int k0, int k1) {
  const int width = k1 - k0;
  for (int e = threadIdx.x; e < RT * width; e += kThreads) {
    const int n = e / width, k = k0 + e % width;
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

// acc[i][jj] += sum_{n < RT} rnd?(P[m][r0 + n]) * Rt[n][c0 + lane + 32 jj]
// (m = warp + 8 i): one CHUNK of the product's columns, from c0
template <int MB, bool BF16, bool ROUND_P>
__device__ void gemm_nn_tile(float (&acc)[MB][8], const float* P, int r0, const float* Rt,
                             const Dims& d, int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = 0; n < RT; n += 4) {
    float b[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int k = c0 + lane + 32 * jj;
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
    load_tile(r, i, r0, d, s.Rt, 0, d.Dp);
    __syncthreads();
    gemm_nt<MB, BF16, false>(s.W, s.Rt, s.S, r0, d);
  }
  __syncthreads();
  softmax_rows(s.S, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < d.Dp; c0 += CHUNK) {  // c = rnd(a) R, a CHUNK of columns at a time
    const int c1 = min(d.Dp, c0 + CHUNK);
    float acc[MB][8];
#pragma unroll
    for (int a = 0; a < MB; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    for (int r0 = 0; r0 < d.SR; r0 += RT) {
      __syncthreads();
      load_tile(r, i, r0, d, s.Rt, c0, c1);
      __syncthreads();
      gemm_nn_tile<MB, BF16, true>(acc, s.S, r0, s.Rt, d, c0);
    }
#pragma unroll
    for (int a = 0; a < MB; ++a) {
      const int m = warp + kWarps * a;
      if (m < d.M)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int k = c0 + lane + 32 * jj;
          if (k < c1) s.C[m * d.SD + k] = acc[a][jj];
        }
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

// The forward of block (image i, caption sub-block): scores out[i][j].
template <typename T, int MB, bool BF16>
__device__ void forward_block(const T* __restrict__ r, const T* __restrict__ w,
                              const uint8_t* __restrict__ mask, float* __restrict__ out,
                              const Dims& d) {
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

template <int MB>  // fp32 operands
__global__ void __launch_bounds__(kThreads)
damsm_fwd_kernel(const float* __restrict__ r, const float* __restrict__ w,
                 const uint8_t* __restrict__ mask, float* __restrict__ out, Dims d) {
  forward_block<float, MB, false>(r, w, mask, out, d);
}

// bf16 operands on the CUDA cores: the route for R > 256 or D > 256, which
// the tensor-core forward (damsm_fwd_tc_kernel) does not take
template <int MB>
__global__ void __launch_bounds__(kThreads)
damsm_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ w,
                      const uint8_t* __restrict__ mask, float* __restrict__ out, Dims d) {
  forward_block<__nv_bfloat16, MB, true>(r, w, mask, out, d);
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
    load_tile(r, i, r0, d, s.Rt, 0, d.Dp);
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
    for (int c0 = 0; c0 < d.Dp; c0 += CHUNK)  // columns c0 + lane + 32 jj
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
          const int k = c0 + lane + 32 * jj;
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
          const int k = c0 + lane + 32 * jj;
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
    for (int c0 = 0; c0 < d.Dp; c0 += CHUNK) {  // d_sim R, a CHUNK of columns at a time
      const int c1 = min(d.Dp, c0 + CHUNK);
      float acc[MB][8];
#pragma unroll
      for (int a = 0; a < MB; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int r0 = 0; r0 < d.SR; r0 += RT) {
        __syncthreads();
        load_tile(r, i, r0, d, s.Rt, c0, c1);
        __syncthreads();
        gemm_nn_tile<MB, BF16, false>(acc, s.DA, r0, s.Rt, d, c0);
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        const int m = warp + kWarps * a;
        if (m >= rows) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int k = c0 + lane + 32 * jj;
          if (k < d.D) acc_out[size_t(m) * d.D + k] += acc[a][jj];
        }
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
  void (*k)(const T*, const T*, const uint8_t*, float*, Dims);
  if constexpr (BF16) k = damsm_fwd_bf16_kernel<MB>;
  else k = damsm_fwd_kernel<MB>;
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

// ---------------------------------------------------------------------------
// bf16 forward and d_regions on the tensor cores (header: "The bf16 kernels
// on the tensor cores").
// ---------------------------------------------------------------------------

constexpr int TC_MAX_RD = 256;   // R and D limits (the [Mp, R] tiles live in registers)
constexpr int TC_MAX_ROWS = 64;  // word rows per pass
constexpr int TC_STAGE = 36;     // row stride (fp32) of a warp's [16][32] d_r staging tile

// Phase clocks of the tensor-core kernels, compiled in only with
// -DXMC_DAMSM_PHASES (xmc_gan_tpu_torch/damsm_phases.py): thread 0 of each
// block adds the clock64() cycles between the block's barriers to
// g_phase_cycles[phase] (TC_PHASE_SYNC adds a barrier of its own first), and
// [TC_PASSES] counts passes.  Inside tc_accumulate_dr, which has no barrier,
// thread 0 splits its own warp's time into the products and the
// read-modify-write of each 16 x 64 tile (TC_PHASE_ARGS / TC_PHASE_PASS hand
// it the clocks).  Slots 0-3 and 9 are both kernels' (pack, words, sim +
// softmax, c + rel, regions), 4-8 and 11 the d_regions', 12 the forward's
// scores.  The streamed d_regions (damsm_bwd_dr_tcs_kernel) shares 0, 1, 4,
// 7, 8 and 11 and has its own 13-20: the waits for its region chunks
// (cp.async and the barrier after it), the sim, c and d a products, the
// softmax, the two sweeps over all of D (norm + rel, d_c) and d_sim.  The
// streamed forward (damsm_fwd_tcs_kernel) has 0, 1, 12 and of those 13-17
// (its all-padded captions fall in pack).  The fp32 d_regions
// (damsm_bwd_dr_f32_kernel) has the streamed d_regions' slots, the fp32
// forward (damsm_fwd_f32_kernel) the streamed forward's, and so has the wide
// fp32 forward; the wide fp32 d_regions has them too but 18 (its d_c falls
// in 19, the sweep that also takes c again and d a) and adds 21, its loads
// of the words again for the d_r products.  The fp32 d_words
// (damsm_bwd_dw_f32_kernel) has the wide fp32 forward's, 4, 18 (the last
// group's d_c), 19 (its d a sweep), 20, and its own 22 (the d_sim R
// products into d_w) and 23 (the store of d_w and the padded slots' 0).
// Without the flag the macros are empty.
constexpr int TC_NPHASE = 24, TC_PASSES = 10;
#ifdef XMC_DAMSM_PHASES
__device__ unsigned long long g_phase_cycles[TC_NPHASE];
#define TC_PHASE_ARGS , long long (&phase_acc)[TC_NPHASE], long long& phase_t
#define TC_PHASE_PASS , phase_acc, phase_t
#define TC_PHASE_INIT                  \
  long long phase_t = clock64();       \
  long long phase_acc[TC_NPHASE] = {};
#define TC_PHASE(k)                                 \
  do {                                              \
    if (threadIdx.x == 0) {                         \
      const long long now = clock64();              \
      phase_acc[k] += now - phase_t;                \
      phase_t = now;                                \
    }                                               \
  } while (0)
#define TC_PHASE_SYNC(k) \
  do {                   \
    __syncthreads();     \
    TC_PHASE(k);         \
  } while (0)
#define TC_PHASE_COUNT(k) phase_acc[k] += threadIdx.x == 0
#define TC_PHASE_FLUSH                                                                   \
  if (threadIdx.x == 0)                                                                  \
    for (int k = 0; k < TC_NPHASE; ++k)                                                  \
      atomicAdd(&g_phase_cycles[k], static_cast<unsigned long long>(phase_acc[k]));
#else
#define TC_PHASE_ARGS
#define TC_PHASE_PASS
#define TC_PHASE_INIT
#define TC_PHASE(k)
#define TC_PHASE_SYNC(k)
#define TC_PHASE_COUNT(k)
#define TC_PHASE_FLUSH
#endif

struct TcDims {
  int B, Bc, R, T, D;
  int Mp;      // word rows per pass: a multiple of 16, >= T
  int Rp, Dp;  // R and D padded to 16
  int SD, SR;  // row strides (bf16 elements) of the [*, Dp] and [*, Rp] tiles: +8 so
               // that the 8 rows an ldmatrix reads fall in 8 different 16-byte bank groups
  int vec;     // 16-byte global loads (D % 8 == 0 and both operands 16-byte aligned)
  float g1, g2;
};

TcDims make_tc_dims(int B, int Bc, int R, int T, int D, int Mp, float g1, float g2,
                    const void* r, const void* w) {
  TcDims d;
  d.B = B; d.Bc = Bc; d.R = R; d.T = T; d.D = D; d.Mp = Mp;
  d.Rp = round_up(R, 16); d.Dp = round_up(D, 16);
  d.SD = d.Dp + 8; d.SR = d.Rp + 8;
  d.vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(w) % 16 == 0;
  d.g1 = g1; d.g2 = g2;
  return d;
}

bool tc_dims_ok(const TcDims& d) {
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.D > 0 && d.R <= TC_MAX_RD &&
         d.D <= TC_MAX_RD && d.T <= TC_MAX_ROWS && d.Mp % 16 == 0 && d.Mp >= d.T &&
         d.Mp <= TC_MAX_ROWS;
}

// Regions [Rp][SD], words W [Mp][SD], a P [Mp][SR] (bf16), rel [Mp] and the
// warps' row partials red [kWarps][Mp] (fp32), the pass's row map row_t, row_c
// and caption slots cap_j, cap_base, cap_n [Mp], info [4] (int); d_regions
// (bwd) also d_c DC [Mp][SD], d_sim DS [Mp][SR] (bf16), each warp's d_r
// staging tile stage [kWarps][16][TC_STAGE] and drel [Mp] (fp32).  The
// forward leaves those out (0 rows).
size_t tc_smem_bytes(const TcDims& d, bool bwd) {
  const size_t mb = bwd ? d.Mp : 0;
  return 2 * (size_t(d.Rp) * d.SD + (d.Mp + mb) * (d.SD + d.SR)) +
         4 * ((bwd ? size_t(kWarps) * 16 * TC_STAGE : 0) + size_t(14) * d.Mp + mb + 4);
}

struct TcSmem {
  __nv_bfloat16 *Rs, *W, *DC, *P, *DS;
  float *stage, *rel, *drel, *red;
  int *row_t, *row_c, *cap_j, *cap_base, *cap_n, *info;
};

__device__ TcSmem tc_carve(unsigned char* base, const TcDims& d, bool bwd) {
  const int mb = bwd ? d.Mp : 0;
  TcSmem s;
  s.Rs = reinterpret_cast<__nv_bfloat16*>(base);
  s.W = s.Rs + d.Rp * d.SD;
  s.DC = s.W + d.Mp * d.SD;
  s.P = s.DC + mb * d.SD;
  s.DS = s.P + d.Mp * d.SR;
  s.stage = reinterpret_cast<float*>(s.DS + mb * d.SR);
  s.rel = s.stage + (bwd ? kWarps * 16 * TC_STAGE : 0);
  s.drel = s.rel + d.Mp;
  s.red = s.drel + mb;
  s.row_t = reinterpret_cast<int*>(s.red + kWarps * d.Mp);
  s.row_c = s.row_t + d.Mp;
  s.cap_j = s.row_c + d.Mp;
  s.cap_base = s.cap_j + d.Mp;
  s.cap_n = s.cap_base + d.Mp;
  s.info = s.cap_n + d.Mp;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&v)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&v)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&v)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(v[0]), "=r"(v[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&v)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(v[0]), "=r"(v[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulators.  Fragments
// (g = lane / 4, q = lane % 4): a (rows g, g+8) x (cols 2q, 2q+1, +8), b
// (k 2q, 2q+1, +8) x (col g), c (rows g, g+8) x (cols 2q, 2q+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows x cols of bf16 from src (row pitch D) into dst [rows_p][stride] at
// 16-byte chunks; rows past `rows` (or row(m) < 0) and columns past D are 0.
template <typename RowPtr>
__device__ void tc_load(__nv_bfloat16* dst, int rows_p, int stride, int rows, RowPtr row,
                        const TcDims& d) {
  const int kc = d.Dp / 8;
  for (int e = threadIdx.x; e < rows_p * kc; e += kThreads) {
    const int m = e / kc, k = (e % kc) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < rows && k < d.D) {
      const __nv_bfloat16* src = row(m);
      if (d.vec) {
        v = *reinterpret_cast<const uint4*>(src + k);
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        uint32_t h[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) h[q] = k + q < d.D ? s16[k + q] : 0u;
        v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                       h[6] | (h[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(dst + m * stride + k) = v;
  }
}

// Warp 0 packs the next pass: the real words of captions j, j+1, ... (whole
// captions, in order, while they fit in Mp rows; all-padded captions take no
// row) become rows 0 .. rows-1.  Writes info = {rows, captions, next j}.
__device__ void tc_pack_pass(const uint8_t* __restrict__ mask, int j, int c1, const TcDims& d,
                             const TcSmem& s) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int rows = 0, ncap = 0;
  for (; j < c1; ++j) {
    const uint8_t* mj = mask + size_t(j) * d.T;
    const bool r0 = lane < d.T && mj[lane] == 0;
    const bool r1 = lane + 32 < d.T && mj[lane + 32] == 0;
    const unsigned b0 = __ballot_sync(0xffffffffu, r0), b1 = __ballot_sync(0xffffffffu, r1);
    const int n = __popc(b0) + __popc(b1);
    if (rows + n > d.Mp) break;
    if (n == 0) continue;
    if (r0) {
      const int m = rows + __popc(b0 & below);
      s.row_t[m] = lane;
      s.row_c[m] = ncap;
    }
    if (r1) {
      const int m = rows + __popc(b0) + __popc(b1 & below);
      s.row_t[m] = lane + 32;
      s.row_c[m] = ncap;
    }
    if (lane == 0) {
      s.cap_j[ncap] = j;
      s.cap_base[ncap] = rows;
      s.cap_n[ncap] = n;
    }
    rows += n;
    ++ncap;
  }
  if (lane == 0) {
    s.info[0] = rows;
    s.info[1] = ncap;
    s.info[2] = j;
  }
}

// v[mt][h] = the block's sum (or max) over the row mt*16 + g + 8h of every
// warp's partial: the quad's four lanes, then the warps in a fixed order.
template <int MT, bool MAX>
__device__ void tc_rows(float (&v)[MT][2], float* red, int Mp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = v[mt][h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, o);
        x = MAX ? fmaxf(x, y) : x + y;
      }
      if ((lane & 3) == 0) red[warp * Mp + mt * 16 + (lane >> 2) + 8 * h] = x;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + (lane >> 2) + 8 * h;
      float x = red[row];
      for (int w = 1; w < kWarps; ++w) {
        const float y = red[w * Mp + row];
        x = MAX ? fmaxf(x, y) : x + y;
      }
      v[mt][h] = x;
    }
  __syncthreads();
}

// acc[mt][j] += A[Mp][Dp] Rs^T over the warp's n-tiles nt0 .. nt0+ntw-1 of Rp
// (products sim = W R^T and d a = d_c R^T).
template <int MT>
__device__ void tc_rows_by_regions(float (&acc)[MT][4][4], const __nv_bfloat16* A,
                                   const __nv_bfloat16* Rs, int nt0, int ntw, const TcDims& d) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < d.Dp; k0 += 16) {
    uint32_t a[MT][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], A + (mt * 16 + (lane & 15)) * d.SD + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ntw)
        ldsm_x2(b[j], Rs + ((nt0 + j) * 8 + (lane & 7)) * d.SD + k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ntw)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
  }
}

// acc[mt][j] += P[Mp][Rp] Rs[Rp][Dp] over the warp's n-tiles of Dp (c = rnd(a) R).
template <int MT>
__device__ void tc_attn_by_regions(float (&acc)[MT][4][4], const __nv_bfloat16* P,
                                   const __nv_bfloat16* Rs, int nt0, int ntw, const TcDims& d) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < d.Rp; k0 += 16) {
    uint32_t a[MT][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], P + (mt * 16 + (lane & 15)) * d.SR + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ntw) ldsm_x2_t(b[j], Rs + (k0 + (lane & 15)) * d.SD + (nt0 + j) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ntw)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
  }
}

// d_r [R, D] (the block's slice) = or += P^T DC + DS^T W, contracted over the
// pass's Mp rows.  A warp takes 16 regions x 64 features at a time: it loads
// the slice's earlier sums first (their latency hides behind the products),
// then moves each 32-feature half of its accumulators through a shared
// staging tile, so that the read-modify-write of the slice is 16-byte and
// row-contiguous (the mma fragments hold 8 bytes of each of 8 rows).
__device__ void tc_accumulate_dr(float* __restrict__ out, bool first, const TcDims& d,
                                 const TcSmem& s TC_PHASE_ARGS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nD = d.Dp / 8, chunks = (nD + 7) / 8, items = (d.Rp / 16) * chunks;
  const bool vec4 = (d.D & 3) == 0;
  float* stage = s.stage + warp * 16 * TC_STAGE;
  const int lrow = lane >> 3, lcol = (lane & 7) * 4;  // after staging: rows lrow + 4i
  for (int it = warp; it < items; it += kWarps) {
    const int r0 = (it / chunks) * 16, n0 = (it % chunks) * 8;
    float prev[2][4][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + lrow + 4 * i, col = n0 * 8 + hf * 32 + lcol;
        float* o = out + size_t(row) * d.D + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) prev[hf][i][e] = 0.f;
        if (first || row >= d.R) continue;
        if (vec4) {
          if (col < d.D) {
            const float4 p = *reinterpret_cast<const float4*>(o);
            prev[hf][i][0] = p.x; prev[hf][i][1] = p.y; prev[hf][i][2] = p.z; prev[hf][i][3] = p.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d.D) prev[hf][i][e] = o[e];
        }
      }
    float acc[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
    for (int k0 = 0; k0 < d.Mp; k0 += 16) {
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        const __nv_bfloat16* At = op ? s.DS : s.P;  // [Mp][SR], read transposed
        const __nv_bfloat16* Bm = op ? s.W : s.DC;  // [Mp][SD]
        const int i = lane >> 3;
        uint32_t a[4], b[4][4];
        ldsm_x4_t(a, At + (k0 + (lane & 7) + (i >> 1) * 8) * d.SR + r0 + (i & 1) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
          if (n0 + 2 * jp < nD)
            ldsm_x4_t(b[jp], Bm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * d.SD +
                                 (n0 + 2 * jp + (lane >> 4)) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
          if (n0 + 2 * jp < nD) {
            mma_bf16(acc[2 * jp], a, b[jp][0], b[jp][1]);
            mma_bf16(acc[2 * jp + 1], a, b[jp][2], b[jp][3]);
          }
      }
    }
    TC_PHASE(7);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      __syncwarp();
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(stage + ((lane >> 2) + 8 * h) * TC_STAGE + j4 * 8 +
                                     2 * (lane & 3)) =
              make_float2(acc[hf * 4 + j4][2 * h], acc[hf * 4 + j4][2 * h + 1]);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + lrow + 4 * i, col = n0 * 8 + hf * 32 + lcol;
        if (row >= d.R) continue;
        const float4 v = *reinterpret_cast<const float4*>(stage + (lrow + 4 * i) * TC_STAGE + lcol);
        const float x[4] = {v.x + prev[hf][i][0], v.y + prev[hf][i][1], v.z + prev[hf][i][2],
                            v.w + prev[hf][i][3]};
        float* o = out + size_t(row) * d.D + col;
        if (vec4) {
          if (col < d.D) *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d.D) o[e] = x[e];
        }
      }
    }
    TC_PHASE(8);
  }
}

// The next pass of captions j .. c1-1: warp 0 packs it, the block loads its
// words into W.  Returns its word rows (0: the remaining captions are all
// padded) and moves j past its captions.
__device__ __forceinline__ int tc_next_pass(const __nv_bfloat16* __restrict__ w,
                                            const uint8_t* __restrict__ mask, int& j, int c1,
                                            const TcDims& d, const TcSmem& s TC_PHASE_ARGS) {
  __syncthreads();  // the previous pass is done with the tiles and the row map
  if (threadIdx.x < 32) tc_pack_pass(mask, j, c1, d, s);
  __syncthreads();
  TC_PHASE(0);
  const int rows = s.info[0];
  j = s.info[2];
  if (rows == 0) return 0;
  tc_load(s.W, d.Mp, d.SD, rows, [&](int m) {
    return w + (size_t(s.cap_j[s.row_c[m]]) * d.T + s.row_t[m]) * d.D; }, d);
  __syncthreads();
  TC_PHASE(1);
  return rows;
}

// a = softmax_R(g1 sim) in place of the sim tiles a (the warp's n-tiles
// ntR0 .. ntR0+ntwR-1 of Rp; padded regions get 0), and P = rnd(a) in shared
// memory; v is scratch.
template <int MT>
__device__ __forceinline__ void tc_softmax(float (&a)[MT][4][4], float (&v)[MT][2], int ntR0,
                                           int ntwR, const TcDims& d, const TcSmem& s) {
  const int lane = threadIdx.x & 31, q2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[mt][h] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (jj < ntwR && (ntR0 + jj) * 8 + q2 + e < d.R)
            v[mt][h] = fmaxf(v[mt][h], d.g1 * a[mt][jj][2 * h + e]);
    }
  tc_rows<MT, true>(v, s.red, d.Mp);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = v[mt][h];
      v[mt][h] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool real = jj < ntwR && (ntR0 + jj) * 8 + q2 + e < d.R;
          const float x = real ? expf(d.g1 * a[mt][jj][2 * h + e] - mx) : 0.f;
          a[mt][jj][2 * h + e] = x;
          v[mt][h] += x;
        }
    }
  tc_rows<MT, false>(v, s.red, d.Mp);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + (lane >> 2) + 8 * h;
      const float inv = 1.f / v[mt][h];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= ntwR) continue;
        a[mt][jj][2 * h] *= inv;
        a[mt][jj][2 * h + 1] *= inv;
        *reinterpret_cast<uint32_t*>(s.P + row * d.SR + (ntR0 + jj) * 8 + q2) =
            pack_bf16(a[mt][jj][2 * h], a[mt][jj][2 * h + 1]);
      }
    }
}

// A pass's chain up to rel, on the words in W, as the plain version computes
// it: sim = W R^T; a = softmax_R(g1 sim) (fp32, in registers) and P = rnd(a)
// in shared memory; c = P R; c_hat = c / max(|c|, 1e-12) (left in c, with
// inrm = 1 / max(|c|, 1e-12)); rel = sum_D rnd(c_hat) w into s.rel.  The
// warp owns the n-tiles ntR0 .. ntR0+ntwR-1 of Rp and ntD0 .. ntD0+ntwD-1 of
// Dp.  Ends after a barrier.
template <int MT>
__device__ __forceinline__ void tc_attend(float (&a)[MT][4][4], float (&c)[MT][4][4],
                                          float (&inrm)[MT][2], int ntR0, int ntwR, int ntD0,
                                          int ntwD, const TcDims& d,
                                          const TcSmem& s TC_PHASE_ARGS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q2 = 2 * (lane & 3);
  float v[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[mt][jj][e] = 0.f;
  tc_rows_by_regions<MT>(a, s.W, s.Rs, ntR0, ntwR, d);
  tc_softmax<MT>(a, v, ntR0, ntwR, d, s);
  __syncthreads();
  TC_PHASE(2);

  // c = rnd(a) R; c_hat = c / max(|c|, 1e-12); rel = sum_D rnd(c_hat) w
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][jj][e] = 0.f;
  tc_attn_by_regions<MT>(c, s.P, s.Rs, ntD0, ntwD, d);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inrm[mt][h] = 0.f;  // the sum of c^2 first
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = c[mt][jj][2 * h + e];
          if (jj < ntwD) inrm[mt][h] = fmaf(x, x, inrm[mt][h]);
        }
    }
  tc_rows<MT, false>(inrm, s.red, d.Mp);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + (lane >> 2) + 8 * h;
      inrm[mt][h] = 1.f / fmaxf(sqrtf(inrm[mt][h]), 1e-12f);
      v[mt][h] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= ntwD) continue;
        const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            s.W + row * d.SD + (ntD0 + jj) * 8 + q2));
        const float c0 = c[mt][jj][2 * h] * inrm[mt][h];
        const float c1 = c[mt][jj][2 * h + 1] * inrm[mt][h];
        c[mt][jj][2 * h] = c0;
        c[mt][jj][2 * h + 1] = c1;
        v[mt][h] = fmaf(rnd<true>(c0), wv.x, fmaf(rnd<true>(c1), wv.y, v[mt][h]));
      }
    }
  tc_rows<MT, false>(v, s.red, d.Mp);
  if (warp == 0 && (lane & 3) == 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) s.rel[mt * 16 + (lane >> 2) + 8 * h] = v[mt][h];
  __syncthreads();
  TC_PHASE(3);
}

// d rel = g_ij softmax over the real words of each of the pass's ncap
// captions (image i) into s.drel; 0 on the unused rows.
__device__ __forceinline__ void tc_drel(const float* __restrict__ g, int i, int rows, int ncap,
                                        const TcDims& d, const TcSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int cs = warp; cs < ncap; cs += kWarps) {
    const int base = s.cap_base[cs], n = s.cap_n[cs];
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, d.g2 * s.rel[base + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) sum += expf(d.g2 * s.rel[base + t] - mx);
    sum = warp_sum(sum);
    const float gij = g[size_t(i) * d.Bc + s.cap_j[cs]];
    for (int t = lane; t < n; t += 32)
      s.drel[base + t] = gij * (expf(d.g2 * s.rel[base + t] - mx) / sum);
  }
  for (int m = rows + threadIdx.x; m < d.Mp; m += kThreads) s.drel[m] = 0.f;
}

// From the fp32 d_c R^T tiles da: d a = rnd(da), in place; d_sim = g1 a (d a
// - sum_R a d a) and DS = rnd(d_sim) in shared memory (the warp's n-tiles
// ntR0 .. ntR0+ntwR-1 of Rp); v is scratch.
template <int MT>
__device__ __forceinline__ void tc_dsim(const float (&a)[MT][4][4], float (&da)[MT][4][4],
                                        float (&v)[MT][2], int ntR0, int ntwR, const TcDims& d,
                                        const TcSmem& s) {
  const int lane = threadIdx.x & 31, q2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[mt][h] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = rnd<true>(da[mt][jj][2 * h + e]);
          da[mt][jj][2 * h + e] = x;
          if (jj < ntwR) v[mt][h] = fmaf(a[mt][jj][2 * h + e], x, v[mt][h]);
        }
    }
  tc_rows<MT, false>(v, s.red, d.Mp);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= ntwR) continue;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ds[e] = d.g1 * (a[mt][jj][2 * h + e] * (da[mt][jj][2 * h + e] - v[mt][h]));
        *reinterpret_cast<uint32_t*>(s.DS + row * d.SR + (ntR0 + jj) * 8 + q2) =
            pack_bf16(ds[0], ds[1]);
      }
    }
}

// The forwards' scores, with the caller's lane and warp (so the three
// forwards compile as they did with these loops inline).  An all-padded
// caption of [c0, c1) takes no row; its score is the plain version's
// logsumexp of T logits of -1e30, over g2.
__device__ __forceinline__ void tc_padded_scores(const uint8_t* __restrict__ mask, int c0, int c1,
                                                 const TcDims& d, int lane, int warp,
                                                 float* __restrict__ out_i) {
  for (int j = c0 + warp; j < c1; j += kWarps) {
    const uint8_t* mj = mask + size_t(j) * d.T;
    const bool real = (lane < d.T && mj[lane] == 0) || (lane + 32 < d.T && mj[lane + 32] == 0);
    if (!__any_sync(0xffffffffu, real) && lane == 0) out_i[j] = (NEG + logf(float(d.T))) / d.g2;
  }
}

// Each caption of the pass, one warp a caption: score = logsumexp over its
// real words of g2 rel, over g2.
__device__ __forceinline__ void tc_write_scores(const TcSmem& s, const TcDims& d, int lane,
                                                int warp, float* __restrict__ out_i) {
  for (int cs = warp; cs < s.info[1]; cs += kWarps) {
    const int base = s.cap_base[cs], n = s.cap_n[cs];
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, d.g2 * s.rel[base + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) sum += expf(d.g2 * s.rel[base + t] - mx);
    sum = warp_sum(sum);
    if (lane == 0) out_i[s.cap_j[cs]] = (mx + logf(sum)) / d.g2;
  }
}

// The forward, bf16 operands: block (image i, split).  The split's captions
// go in passes of at most Mp real word rows; each pass runs the chain to rel
// and writes the score of each of its captions to out[i][j].
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_fwd_tc_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ w,
                    const uint8_t* __restrict__ mask, float* __restrict__ out, TcDims d,
                    int nsplit) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const TcSmem s = tc_carve(tc_smem_raw, d, false);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out_i = out + size_t(i) * d.Bc;
  const __nv_bfloat16* ri = r + size_t(i) * d.R * d.D;
  tc_load(s.Rs, d.Rp, d.SD, d.R, [&](int q) { return ri + size_t(q) * d.D; }, d);
  tc_padded_scores(mask, c0, c1, d, lane, warp, out_i);
  TC_PHASE_SYNC(9);
  // a warp's columns: adjacent n-tiles (8 wide) of Rp and of Dp
  const int nR = d.Rp / 8, nD = d.Dp / 8;
  const int twR = (nR + kWarps - 1) / kWarps, twD = (nD + kWarps - 1) / kWarps;
  const int ntR0 = warp * twR, ntwR = max(0, min(twR, nR - ntR0));
  const int ntD0 = warp * twD, ntwD = max(0, min(twD, nD - ntD0));
  for (int j = c0; j < c1;) {
    if (tc_next_pass(w, mask, j, c1, d, s TC_PHASE_PASS) == 0) break;
    float a[MT][4][4], c[MT][4][4], inrm[MT][2];
    tc_attend<MT>(a, c, inrm, ntR0, ntwR, ntD0, ntwD, d, s TC_PHASE_PASS);
    tc_write_scores(s, d, lane, warp, out_i);
    TC_PHASE_SYNC(12);
    TC_PHASE_COUNT(TC_PASSES);
  }
  TC_PHASE_FLUSH
}

// d_regions, bf16 operands: block (image i, split).  The split's captions go
// in passes of at most Mp real word rows; each pass recomputes the chain and
// adds rnd(a)^T d_c + d_sim^T W into partial[i][split].
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_dr_tc_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ w,
                       const uint8_t* __restrict__ mask, const float* __restrict__ g,
                       float* __restrict__ partial, TcDims d, int nsplit) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const TcSmem s = tc_carve(tc_smem_raw, d, true);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q2 = 2 * (lane & 3);
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out = partial + (size_t(i) * nsplit + split) * d.R * d.D;
  const __nv_bfloat16* ri = r + size_t(i) * d.R * d.D;
  tc_load(s.Rs, d.Rp, d.SD, d.R, [&](int q) { return ri + size_t(q) * d.D; }, d);
  TC_PHASE_SYNC(9);
  // a warp's columns: adjacent n-tiles (8 wide) of Rp and of Dp
  const int nR = d.Rp / 8, nD = d.Dp / 8;
  const int twR = (nR + kWarps - 1) / kWarps, twD = (nD + kWarps - 1) / kWarps;
  const int ntR0 = warp * twR, ntwR = max(0, min(twR, nR - ntR0));
  const int ntD0 = warp * twD, ntwD = max(0, min(twD, nD - ntD0));
  bool first = true;
  for (int j = c0; j < c1;) {
    const int rows = tc_next_pass(w, mask, j, c1, d, s TC_PHASE_PASS);
    if (rows == 0) break;
    const int ncap = s.info[1];
    float a[MT][4][4], c[MT][4][4], inrm[MT][2], v[MT][2];
    tc_attend<MT>(a, c, inrm, ntR0, ntwR, ntD0, ntwD, d, s TC_PHASE_PASS);

    tc_drel(g, i, rows, ncap, d, s);
    __syncthreads();
    TC_PHASE(4);

    // d c_hat = rnd(d rel w); d_c = (d c_hat - c_hat <c_hat, d c_hat>) / nrm; DC = rnd(d_c)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        const float dr = s.drel[row];
        v[mt][h] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj >= ntwD) continue;
          const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              s.W + row * d.SD + (ntD0 + jj) * 8 + q2));
          v[mt][h] = fmaf(c[mt][jj][2 * h], rnd<true>(dr * wv.x),
                          fmaf(c[mt][jj][2 * h + 1], rnd<true>(dr * wv.y), v[mt][h]));
        }
      }
    tc_rows<MT, false>(v, s.red, d.Mp);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        const float dr = s.drel[row];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj >= ntwD) continue;
          const int col = (ntD0 + jj) * 8 + q2;
          const float2 wv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(s.W + row * d.SD + col));
          *reinterpret_cast<uint32_t*>(s.DC + row * d.SD + col) =
              pack_bf16((rnd<true>(dr * wv.x) - c[mt][jj][2 * h] * v[mt][h]) * inrm[mt][h],
                        (rnd<true>(dr * wv.y) - c[mt][jj][2 * h + 1] * v[mt][h]) * inrm[mt][h]);
        }
      }
    __syncthreads();
    TC_PHASE(5);

    // d a = rnd(d_c R^T); d_sim = g1 a (d a - sum_R a d a); DS = rnd(d_sim)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][jj][e] = 0.f;
    tc_rows_by_regions<MT>(c, s.DC, s.Rs, ntR0, ntwR, d);
    tc_dsim<MT>(a, c, v, ntR0, ntwR, d, s);
    __syncthreads();
    TC_PHASE(6);

    tc_accumulate_dr(out, first, d, s TC_PHASE_PASS);
    TC_PHASE_SYNC(11);
    TC_PHASE_COUNT(TC_PASSES);
    first = false;
  }
  if (first)  // no caption of the split has a real word: the slice is 0
    for (int e = threadIdx.x; e < d.R * d.D; e += kThreads) out[e] = 0.f;
  TC_PHASE_FLUSH
}

// ---------------------------------------------------------------------------
// bf16 d_regions and forward on the tensor cores at 256 < D <= 1024, the
// regions streamed (header: "The streamed d_regions", "The streamed forward").
// ---------------------------------------------------------------------------

constexpr int TCS_MAX_D = 1024;     // D limit (the [Mp, D] context lives in registers)
constexpr int TCS_MAX_ROWS = 32;    // word rows per pass: 16 or 32 (d_regions)
constexpr int TCS_FWD_ROWS = 32;    // word rows per pass of the forward: always 32
constexpr int TCS_KC = 64;          // region columns per streamed chunk: one n-tile per warp
constexpr int TCS_SK = TCS_KC + 8;  // row stride (bf16) of a chunk buffer, +8 as SD

bool tcs_dims_ok(const TcDims& d, bool bwd) {
  const bool rows_ok = bwd ? (d.Mp == 16 || d.Mp == TCS_MAX_ROWS) : d.Mp == TCS_FWD_ROWS;
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.R <= TC_MAX_RD && d.D > TC_MAX_RD &&
         d.D <= TCS_MAX_D && rows_ok && d.T <= d.Mp;
}

// Words W and d_c DC [Mp][SD], a P and d_sim DS [Mp][SR] (bf16), then one
// union: two region chunk buffers Rs [2][Rp][TCS_SK] (bf16) during the
// products, each warp's d_r staging tile [kWarps][16][TC_STAGE] (fp32) during
// the d_r accumulation; then rel, drel, red and the row map as above.  The
// forward (bwd false) leaves out DC, DS, the staging tiles and drel.
__host__ __device__ inline size_t tcs_union_bytes(const TcDims& d, bool bwd) {
  const size_t regions = 2 * 2 * size_t(d.Rp) * TCS_SK;
  const size_t stage = bwd ? 4 * size_t(kWarps) * 16 * TC_STAGE : 0;
  return regions > stage ? regions : stage;
}

size_t tcs_smem_bytes(const TcDims& d, bool bwd) {
  const size_t tiles = bwd ? 2 : 1;
  return 2 * tiles * size_t(d.Mp) * (d.SD + d.SR) + tcs_union_bytes(d, bwd) +
         4 * (size_t(bwd ? 15 : 14) * d.Mp + 4);
}

__device__ TcSmem tcs_carve(unsigned char* base, const TcDims& d, bool bwd) {
  const int mb = bwd ? d.Mp : 0;
  TcSmem s;
  s.W = reinterpret_cast<__nv_bfloat16*>(base);
  s.DC = s.W + d.Mp * d.SD;
  s.P = s.DC + mb * d.SD;
  s.DS = s.P + d.Mp * d.SR;
  s.Rs = s.DS + mb * d.SR;
  s.stage = reinterpret_cast<float*>(s.Rs);
  s.rel = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.Rs) +
                                   tcs_union_bytes(d, bwd));
  s.drel = s.rel + d.Mp;
  s.red = s.drel + mb;
  s.row_t = reinterpret_cast<int*>(s.red + kWarps * d.Mp);
  s.row_c = s.row_t + d.Mp;
  s.cap_j = s.row_c + d.Mp;
  s.cap_base = s.cap_j + d.Mp;
  s.cap_n = s.cap_base + d.Mp;
  s.info = s.cap_n + d.Mp;
  return s;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Columns k0 .. k0+TCS_KC-1 of the image's regions ri [R][D] into the chunk
// buffer dst [Rp][TCS_SK]; rows past R and columns past D are 0.  16-byte
// cp.async (zero-filled where out of range) where the rows are 16-byte
// aligned (d.vec), else plain loads and stores.
__device__ void tcs_load_chunk(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ ri, int k0,
                               const TcDims& d) {
  constexpr int kc = TCS_KC / 8;
  for (int e = threadIdx.x; e < d.Rp * kc; e += kThreads) {
    const int q = e / kc, kk = (e % kc) * 8, k = k0 + kk;
    __nv_bfloat16* to = dst + q * TCS_SK + kk;
    const bool in = q < d.R && k < d.D;
    if (d.vec) {
      const __nv_bfloat16* from = in ? ri + size_t(q) * d.D + k : ri;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :
                   : "r"(smem_u32(to)), "l"(from), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      uint32_t h[8] = {};
      if (in) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(ri + size_t(q) * d.D);
#pragma unroll
        for (int x = 0; x < 8; ++x) h[x] = k + x < d.D ? s16[k + x] : 0u;
      }
      *reinterpret_cast<uint4*>(to) = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                                                 h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
  }
}

// Chunk q of the sweep: start loading chunk q + 1 into the other buffer,
// wait for chunk q (issued one step earlier), and return its buffer.  Phase
// SLOT takes the time up to the wait, slot 13 the wait.  The caller ends each
// step with a barrier, before the buffer it read is loaded again.
template <int SLOT>
__device__ __forceinline__ const __nv_bfloat16* tcs_next_chunk(const __nv_bfloat16* __restrict__ ri,
                                                              int q, int nq, const TcDims& d,
                                                              const TcSmem& s TC_PHASE_ARGS) {
  if (q + 1 < nq) tcs_load_chunk(s.Rs + ((q + 1) & 1) * d.Rp * TCS_SK, ri, (q + 1) * TCS_KC, d);
  cp_async_commit();
  TC_PHASE(SLOT);
  cp_async_wait_all_but_last();
  __syncthreads();
  TC_PHASE(13);
  return s.Rs + (q & 1) * d.Rp * TCS_SK;
}

// acc[mt][j] += A[Mp][Dp] R^T over the region chunks, for the warp's n-tiles
// nt0 .. nt0+ntw-1 of Rp (products sim = W R^T and d a = d_c R^T, phase SLOT).
// Ends after a barrier.
template <int MT, int SLOT>
__device__ void tcs_rows_by_regions(float (&acc)[MT][4][4], const __nv_bfloat16* A,
                                    const __nv_bfloat16* __restrict__ ri, int nt0, int ntw,
                                    const TcDims& d, const TcSmem& s TC_PHASE_ARGS) {
  const int lane = threadIdx.x & 31;
  const int nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  tcs_load_chunk(s.Rs, ri, 0, d);
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    const __nv_bfloat16* Rc = tcs_next_chunk<SLOT>(ri, q, nq, d, s TC_PHASE_PASS);
    const int k0 = q * TCS_KC, kn = min(TCS_KC, d.Dp - k0);
    for (int kk = 0; kk < kn; kk += 16) {
      uint32_t a[MT][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], A + (mt * 16 + (lane & 15)) * d.SD + k0 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ntw)
          ldsm_x2(b[j], Rc + ((nt0 + j) * 8 + (lane & 7)) * TCS_SK + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ntw)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
    }
    __syncthreads();
  }
  TC_PHASE(SLOT);
}

// c[mt][q] += P[Mp][Rp] R[:, chunk q] over the region chunks (c = rnd(a) R):
// in chunk q the warp owns the n-tile q * 8 + warp of Dp, whose fp32 sums
// stay in registers for the pass.  Ends after a barrier.
template <int MT, int NQ>
__device__ void tcs_attn_by_regions(float (&c)[MT][NQ][4], const __nv_bfloat16* __restrict__ ri,
                                    const TcDims& d, const TcSmem& s TC_PHASE_ARGS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = (d.Dp + TCS_KC - 1) / TCS_KC, nD = d.Dp / 8;
  tcs_load_chunk(s.Rs, ri, 0, d);
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q >= nq) break;
    const __nv_bfloat16* Rc = tcs_next_chunk<16>(ri, q, nq, d, s TC_PHASE_PASS);
    if (q * 8 + warp < nD)
      for (int k0 = 0; k0 < d.Rp; k0 += 16) {
        uint32_t a[MT][4], b[2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], s.P + (mt * 16 + (lane & 15)) * d.SR + k0 + (lane >> 4) * 8);
        ldsm_x2_t(b, Rc + (k0 + (lane & 15)) * TCS_SK + warp * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(c[mt][q], a[mt], b[0], b[1]);
      }
    __syncthreads();
  }
  TC_PHASE(16);
}

// A pass's chain up to rel with the regions streamed, as tc_attend computes
// it: sim = W R^T over the region chunks; a = softmax_R(g1 sim) (fp32, in
// registers) and P = rnd(a) in shared memory; c = P R, a chunk of columns at
// a time, into the [Mp, D] fp32 context c in registers (n-tile q * 8 + warp
// of chunk q); c_hat = c / max(|c|, 1e-12) (left in c, with inrm = 1 /
// max(|c|, 1e-12)); rel = sum_D rnd(c_hat) w into s.rel.  The warp owns the
// n-tiles ntR0 .. ntR0+ntwR-1 of Rp.  Ends after a barrier.
template <int MT, int NQ>
__device__ __forceinline__ void tcs_attend(float (&a)[MT][4][4], float (&c)[MT][NQ][4],
                                           float (&inrm)[MT][2],
                                           const __nv_bfloat16* __restrict__ ri, int ntR0,
                                           int ntwR, const TcDims& d,
                                           const TcSmem& s TC_PHASE_ARGS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q2 = 2 * (lane & 3);
  const int nD = d.Dp / 8, nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  float v[MT][2];
  // sim = W R^T; a = softmax_R(g1 sim) (fp32, in registers), P = rnd(a)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[mt][jj][e] = 0.f;
  tcs_rows_by_regions<MT, 14>(a, s.W, ri, ntR0, ntwR, d, s TC_PHASE_PASS);
  tc_softmax<MT>(a, v, ntR0, ntwR, d, s);
  __syncthreads();
  TC_PHASE(15);

  // c = P R; c_hat = c / max(|c|, 1e-12) (left in c); rel = sum_D rnd(c_hat) w
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][q][e] = 0.f;
  tcs_attn_by_regions<MT, NQ>(c, ri, d, s TC_PHASE_PASS);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inrm[mt][h] = 0.f;  // the sum of c^2 first
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = c[mt][q][2 * h + e];
          if (q < nq && q * 8 + warp < nD) inrm[mt][h] = fmaf(x, x, inrm[mt][h]);
        }
    }
  tc_rows<MT, false>(inrm, s.red, d.Mp);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + (lane >> 2) + 8 * h;
      inrm[mt][h] = 1.f / fmaxf(sqrtf(inrm[mt][h]), 1e-12f);
      v[mt][h] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq || q * 8 + warp >= nD) continue;
        const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            s.W + row * d.SD + (q * 8 + warp) * 8 + q2));
        const float x0 = c[mt][q][2 * h] * inrm[mt][h];
        const float x1 = c[mt][q][2 * h + 1] * inrm[mt][h];
        c[mt][q][2 * h] = x0;
        c[mt][q][2 * h + 1] = x1;
        v[mt][h] = fmaf(rnd<true>(x0), wv.x, fmaf(rnd<true>(x1), wv.y, v[mt][h]));
      }
    }
  tc_rows<MT, false>(v, s.red, d.Mp);
  if (warp == 0 && (lane & 3) == 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) s.rel[mt * 16 + (lane >> 2) + 8 * h] = v[mt][h];
  __syncthreads();
  TC_PHASE(17);
}

// d_regions, bf16 operands, 256 < D <= 1024: block (image i, split), as
// damsm_bwd_dr_tc_kernel, with the image's regions streamed through shared
// memory in TCS_KC-column chunks, once for each product that reads them, and
// the pass's [Mp, D] context in registers (a warp owns one n-tile of each
// chunk).
template <int MT, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_dr_tcs_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ w,
                        const uint8_t* __restrict__ mask, const float* __restrict__ g,
                        float* __restrict__ partial, TcDims d, int nsplit) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const TcSmem s = tcs_carve(tc_smem_raw, d, true);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q2 = 2 * (lane & 3);
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out = partial + (size_t(i) * nsplit + split) * d.R * d.D;
  const __nv_bfloat16* ri = r + size_t(i) * d.R * d.D;
  // a warp's columns: adjacent n-tiles (8 wide) of Rp; n-tile q * 8 + warp of
  // Dp in chunk q (valid while below nD)
  const int nR = d.Rp / 8, nD = d.Dp / 8, nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  const int twR = (nR + kWarps - 1) / kWarps;
  const int ntR0 = warp * twR, ntwR = max(0, min(twR, nR - ntR0));
  bool first = true;
  for (int j = c0; j < c1;) {
    const int rows = tc_next_pass(w, mask, j, c1, d, s TC_PHASE_PASS);
    if (rows == 0) break;
    const int ncap = s.info[1];
    float a[MT][4][4], c[MT][NQ][4], inrm[MT][2], v[MT][2];

    tcs_attend<MT, NQ>(a, c, inrm, ri, ntR0, ntwR, d, s TC_PHASE_PASS);

    tc_drel(g, i, rows, ncap, d, s);
    __syncthreads();
    TC_PHASE(4);

    // d c_hat = rnd(d rel w); d_c = (d c_hat - c_hat <c_hat, d c_hat>) / nrm; DC = rnd(d_c)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        const float dr = s.drel[row];
        v[mt][h] = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq || q * 8 + warp >= nD) continue;
          const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              s.W + row * d.SD + (q * 8 + warp) * 8 + q2));
          v[mt][h] = fmaf(c[mt][q][2 * h], rnd<true>(dr * wv.x),
                          fmaf(c[mt][q][2 * h + 1], rnd<true>(dr * wv.y), v[mt][h]));
        }
      }
    tc_rows<MT, false>(v, s.red, d.Mp);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        const float dr = s.drel[row];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq || q * 8 + warp >= nD) continue;
          const int col = (q * 8 + warp) * 8 + q2;
          const float2 wv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(s.W + row * d.SD + col));
          *reinterpret_cast<uint32_t*>(s.DC + row * d.SD + col) =
              pack_bf16((rnd<true>(dr * wv.x) - c[mt][q][2 * h] * v[mt][h]) * inrm[mt][h],
                        (rnd<true>(dr * wv.y) - c[mt][q][2 * h + 1] * v[mt][h]) * inrm[mt][h]);
        }
      }
    __syncthreads();
    TC_PHASE(18);

    // d a = rnd(d_c R^T); d_sim = g1 a (d a - sum_R a d a); DS = rnd(d_sim)
    float da[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[mt][jj][e] = 0.f;
    tcs_rows_by_regions<MT, 19>(da, s.DC, ri, ntR0, ntwR, d, s TC_PHASE_PASS);
    tc_dsim<MT>(a, da, v, ntR0, ntwR, d, s);
    __syncthreads();
    TC_PHASE(20);

    tc_accumulate_dr(out, first, d, s TC_PHASE_PASS);  // its staging tiles reuse Rs
    TC_PHASE_SYNC(11);
    TC_PHASE_COUNT(TC_PASSES);
    first = false;
  }
  if (first)  // no caption of the split has a real word: the slice is 0
    for (int e = threadIdx.x; e < d.R * d.D; e += kThreads) out[e] = 0.f;
  TC_PHASE_FLUSH
}

// The forward, bf16 operands, 256 < D <= 1024: block (image i, split), as
// damsm_fwd_tc_kernel, with the image's regions streamed through shared
// memory in TCS_KC-column chunks twice a pass (sim = W R^T, then c = P R)
// and the pass's [Mp, D] context in registers (tcs_attend); Mp = 32.
template <int MT, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
damsm_fwd_tcs_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ w,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, TcDims d,
                     int nsplit) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const TcSmem s = tcs_carve(tc_smem_raw, d, false);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out_i = out + size_t(i) * d.Bc;
  const __nv_bfloat16* ri = r + size_t(i) * d.R * d.D;
  tc_padded_scores(mask, c0, c1, d, lane, warp, out_i);
  // a warp's columns: adjacent n-tiles (8 wide) of Rp; n-tile q * 8 + warp of
  // Dp in chunk q
  const int nR = d.Rp / 8, twR = (nR + kWarps - 1) / kWarps;
  const int ntR0 = warp * twR, ntwR = max(0, min(twR, nR - ntR0));
  for (int j = c0; j < c1;) {
    if (tc_next_pass(w, mask, j, c1, d, s TC_PHASE_PASS) == 0) break;
    float a[MT][4][4], c[MT][NQ][4], inrm[MT][2];
    tcs_attend<MT, NQ>(a, c, inrm, ri, ntR0, ntwR, d, s TC_PHASE_PASS);
    tc_write_scores(s, d, lane, warp, out_i);
    TC_PHASE_SYNC(12);
    TC_PHASE_COUNT(TC_PASSES);
  }
  TC_PHASE_FLUSH
}

template <int MT, int NQ>
int launch_dr_tcs(const void* r, const void* w, const uint8_t* mask, const float* g,
                  float* partial, float* dr, const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dr_tcs_kernel<MT, NQ>;
  const size_t bytes = tcs_smem_bytes(d, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(w), mask, g, partial, d,
                                   nsplit);
  if (partial != dr) launch_sum(partial, dr, d.B, nsplit, int64_t(d.R) * d.D, st);
  return int(cudaGetLastError());
}

template <int MT, int NQ>
int launch_fwd_tcs(const void* r, const void* w, const uint8_t* mask, float* out,
                   const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_fwd_tcs_kernel<MT, NQ>;
  const size_t bytes = tcs_smem_bytes(d, false);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(w), mask, out, d, nsplit);
  return int(cudaGetLastError());
}

// Dispatch a streamed kernel on NQ, the region chunks a pass holds context
// registers for: f(Nq<8>{}), f(Nq<12>{}) or f(Nq<16>{}) for D <= 512, 768,
// 1024.
template <int N>
struct Nq {
  static constexpr int value = N;
};

template <class F>
int dispatch_nq(const TcDims& d, F f) {
  const int nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  if (nq <= 8) return f(Nq<8>{});
  if (nq <= 12) return f(Nq<12>{});
  return f(Nq<16>{});
}

template <int MT>
int launch_fwd_tc(const void* r, const void* w, const uint8_t* mask, float* out, const TcDims& d,
                  int nsplit, cudaStream_t st) {
  auto k = damsm_fwd_tc_kernel<MT>;
  const size_t bytes = tc_smem_bytes(d, false);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(w), mask, out, d, nsplit);
  return int(cudaGetLastError());
}

template <int MT>
int launch_dr_tc(const void* r, const void* w, const uint8_t* mask, const float* g,
                 float* partial, float* dr, const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dr_tc_kernel<MT>;
  const size_t bytes = tc_smem_bytes(d, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(w), mask, g, partial, d,
                                   nsplit);
  if (partial != dr) launch_sum(partial, dr, d.B, nsplit, int64_t(d.R) * d.D, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 d_words on the tensor cores, R <= 256, D <= 1024, the regions streamed
// (header: "The bf16 d_words").
// ---------------------------------------------------------------------------

constexpr int TCD_ROWS_256 = 64;   // word rows per pass at D <= 256
constexpr int TCD_ROWS_768 = 32;   // at 256 < D <= 768
constexpr int TCD_ROWS_1024 = 16;  // at 768 < D <= 1024
constexpr int TCD_QREG = 2;        // at 256 < D <= 768: region chunks of d_w held in registers

// The rows per pass the d_words takes at d.D (by the region chunks its
// context takes: 4, 12 or 16).
inline int tcd_rows(const TcDims& d) {
  const int nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  return nq <= 4 ? TCD_ROWS_256 : nq <= 12 ? TCD_ROWS_768 : TCD_ROWS_1024;
}

bool tcd_dims_ok(const TcDims& d) {
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.D > 0 && d.R <= TC_MAX_RD &&
         d.D <= TCS_MAX_D && d.Mp == tcd_rows(d) && d.T <= d.Mp;
}

// Row stride (fp32) of the shared part of d_w: the columns past the first
// qreg region chunks, + 8 so that a warp's 8-byte accesses (8 rows x 4
// column pairs) take the two wavefronts 256 bytes need.
__host__ __device__ inline int tcd_swd(const TcDims& d, int qreg) {
  const int nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  return nq > qreg ? (nq - qreg) * TCS_KC + 8 : 0;
}

// Words W [Mp][SD]; one bf16 tile of Mp rows and max(SR, TCS_SK) columns
// that holds in turn a (P, stride SR), a chunk of d_c (DC, stride TCS_SK)
// and d_sim (DS, stride SR); the two region chunk buffers Rs [2][Rp][TCS_SK];
// the shared part of d_w [Mp][tcd_swd] (fp32); rel, drel, red and the row map
// as tcs_carve's.
size_t tcd_smem_bytes(const TcDims& d, int qreg) {
  const size_t sp = d.SR > TCS_SK ? d.SR : TCS_SK;
  return 2 * size_t(d.Mp) * (d.SD + sp) + 2 * 2 * size_t(d.Rp) * TCS_SK +
         4 * size_t(d.Mp) * tcd_swd(d, qreg) + 4 * (size_t(15) * d.Mp + 4);
}

__device__ TcSmem tcd_carve(unsigned char* base, const TcDims& d, int qreg, float*& dw) {
  TcSmem s;
  s.W = reinterpret_cast<__nv_bfloat16*>(base);
  s.P = s.DC = s.DS = s.W + d.Mp * d.SD;
  s.Rs = s.P + d.Mp * max(d.SR, TCS_SK);
  s.stage = nullptr;
  dw = reinterpret_cast<float*>(s.Rs + 2 * d.Rp * TCS_SK);
  s.rel = dw + d.Mp * tcd_swd(d, qreg);
  s.drel = s.rel + d.Mp;
  s.red = s.drel + d.Mp;
  s.row_t = reinterpret_cast<int*>(s.red + kWarps * d.Mp);
  s.row_c = s.row_t + d.Mp;
  s.cap_j = s.row_c + d.Mp;
  s.cap_base = s.cap_j + d.Mp;
  s.cap_n = s.cap_base + d.Mp;
  s.info = s.cap_n + d.Mp;
  return s;
}

// The d_words' passes: each caption's real words counted (a thread a
// caption), then thread 0 cuts the captions, in order, where tc_pack_pass
// would: plan[0] = passes, plan[1 + p] = the first caption of pass p,
// plan[1 + passes] = Bc.  Captions whose words all fit in one pass of Mp
// rows; one pass of no row where no caption has a word.
__global__ void __launch_bounds__(kThreads)
damsm_dw_passes_kernel(const uint8_t* __restrict__ mask, int* __restrict__ plan, TcDims d) {
  constexpr int kChunk = 4 * kThreads;
  __shared__ int cnt[kChunk];
  int rows = 0, passes = 1;  // thread 0's
  for (int j0 = 0; j0 < d.Bc; j0 += kChunk) {
    const int n = min(kChunk, d.Bc - j0);
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const uint8_t* mj = mask + size_t(j0 + c) * d.T;
      int k = 0;
      for (int t = 0; t < d.T; ++t) k += mj[t] == 0;
      cnt[c] = k;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int c = 0; c < n; ++c) {
        if (rows + cnt[c] > d.Mp) {
          plan[1 + passes++] = j0 + c;
          rows = 0;
        }
        rows += cnt[c];
      }
  }
  if (threadIdx.x == 0) {
    plan[0] = passes;
    plan[1] = 0;
    plan[1 + passes] = d.Bc;
  }
}

// d a += d_c R^T over the region chunks (the warp's n-tiles nt0 .. nt0+ntw-1
// of Rp), d_c given as bf16 pairs in the context's layout (dc[mt][q][h]: rows
// mt*16 + g + 8h, columns 2q', 2q'+1 of n-tile q * 8 + warp): at chunk q each
// warp writes its n-tile into DC before the chunk's barrier, and all read
// the chunk's 64 columns after it.  Ends after a barrier.
template <int MT, int NQ>
__device__ void tcd_rows_by_regions(float (&acc)[MT][4][4], const uint32_t (&dc)[MT][NQ][2],
                                    const __nv_bfloat16* __restrict__ ri, int nt0, int ntw,
                                    const TcDims& d, const TcSmem& s TC_PHASE_ARGS) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q2 = 2 * (lane & 3);
  const int nq = (d.Dp + TCS_KC - 1) / TCS_KC, nD = d.Dp / 8;
  tcs_load_chunk(s.Rs, ri, 0, d);
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q >= nq) break;
    if (q * 8 + warp < nD)  // the previous chunk's barrier: nobody reads DC now
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(s.DC + (mt * 16 + (lane >> 2) + 8 * h) * TCS_SK +
                                       warp * 8 + q2) = dc[mt][q][h];
    const __nv_bfloat16* Rc = tcs_next_chunk<19>(ri, q, nq, d, s TC_PHASE_PASS);
    const int kn = min(TCS_KC, d.Dp - q * TCS_KC);
    for (int kk = 0; kk < kn; kk += 16) {
      uint32_t a[MT][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], s.DC + (mt * 16 + (lane & 15)) * TCS_SK + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ntw)
          ldsm_x2(b[j], Rc + ((nt0 + j) * 8 + (lane & 7)) * TCS_SK + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < ntw)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
    }
    __syncthreads();
  }
  TC_PHASE(19);
}

// d_words, bf16 operands: block (pass p of plan, split of the images).  The
// pass's real words (tc_pack_pass) stay in W for all of the split's images;
// per image the chain to rel with the regions streamed (tcs_attend), d rel,
// d_c, d a = rnd(d_c R^T), d_sim, and d_w += d rel rnd(c_hat) + rnd(d_sim) R,
// d_w fp32 on chip (QREG region chunks in registers, the rest in DW) until
// one store of the pass's rows into partial[split] (its padded slots: 0).
template <int MT, int NQ, int QREG>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_dw_tcs_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ w,
                        const uint8_t* __restrict__ mask, const float* __restrict__ g,
                        const int* __restrict__ plan, float* __restrict__ partial, TcDims d,
                        int nsplit) {
  const int p = blockIdx.x, split = blockIdx.y;
  if (p >= plan[0]) return;  // the grid has a block for every caption
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  float* DW;
  const TcSmem s = tcd_carve(tc_smem_raw, d, QREG, DW);
  TC_PHASE_INIT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q2 = 2 * (lane & 3);
  const int c0 = plan[1 + p], c1 = plan[2 + p];
  const int per = (d.B + nsplit - 1) / nsplit;
  const int i0 = min(d.B, split * per), i1 = min(d.B, i0 + per);
  float* out = partial + size_t(split) * d.Bc * d.T * d.D;
  // a warp's columns: adjacent n-tiles (8 wide) of Rp; n-tile q * 8 + warp of
  // Dp in chunk q (valid while below nD), whose d_w it owns
  const int nR = d.Rp / 8, nD = d.Dp / 8, nq = (d.Dp + TCS_KC - 1) / TCS_KC;
  const int twR = (nR + kWarps - 1) / kWarps;
  const int ntR0 = warp * twR, ntwR = max(0, min(twR, nR - ntR0));
  const int swd = tcd_swd(d, QREG);
  float dwr[MT][QREG > 0 ? QREG : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < (QREG > 0 ? QREG : 1); ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwr[mt][q][e] = 0.f;
  for (int e = threadIdx.x; e < d.Mp * swd; e += kThreads) DW[e] = 0.f;
  // d_w[row][n-tile q * 8 + warp, columns q2 + e] += x[e]: registers or DW
  auto add_dw = [&](int mt, int q, int h, float x0, float x1) {
    if (q < QREG) {
      dwr[mt][q < QREG ? q : 0][2 * h] += x0;
      dwr[mt][q < QREG ? q : 0][2 * h + 1] += x1;
    } else {
      float2* o = reinterpret_cast<float2*>(DW + (mt * 16 + (lane >> 2) + 8 * h) * swd +
                                            (q - QREG) * TCS_KC + warp * 8 + q2);
      const float2 v = *o;
      *o = make_float2(v.x + x0, v.y + x1);
    }
  };
  int j = c0;
  const int rows = tc_next_pass(w, mask, j, c1, d, s TC_PHASE_PASS);
  const int ncap = s.info[1];
  for (int i = rows > 0 ? i0 : i1; i < i1; ++i) {
    const __nv_bfloat16* ri = r + size_t(i) * d.R * d.D;
    float a[MT][4][4], c[MT][NQ][4], inrm[MT][2], v[MT][2];
    tcs_attend<MT, NQ>(a, c, inrm, ri, ntR0, ntwR, d, s TC_PHASE_PASS);

    tc_drel(g, i, rows, ncap, d, s);
    __syncthreads();
    TC_PHASE(4);

    // d c_hat = rnd(d rel w); <c_hat, d c_hat> per row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        const float dr = s.drel[row];
        v[mt][h] = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq || q * 8 + warp >= nD) continue;
          const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              s.W + row * d.SD + (q * 8 + warp) * 8 + q2));
          v[mt][h] = fmaf(c[mt][q][2 * h], rnd<true>(dr * wv.x),
                          fmaf(c[mt][q][2 * h + 1], rnd<true>(dr * wv.y), v[mt][h]));
        }
      }
    tc_rows<MT, false>(v, s.red, d.Mp);
    // d_w += d rel rnd(c_hat); d_c = (d c_hat - c_hat <c_hat, d c_hat>) / nrm, as bf16
    // pairs in the context's layout
    uint32_t dc[MT][NQ][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + (lane >> 2) + 8 * h;
        const float dr = s.drel[row];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          dc[mt][q][h] = 0u;
          if (q >= nq || q * 8 + warp >= nD) continue;
          const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              s.W + row * d.SD + (q * 8 + warp) * 8 + q2));
          const float x0 = c[mt][q][2 * h], x1 = c[mt][q][2 * h + 1];
          add_dw(mt, q, h, dr * rnd<true>(x0), dr * rnd<true>(x1));
          dc[mt][q][h] = pack_bf16((rnd<true>(dr * wv.x) - x0 * v[mt][h]) * inrm[mt][h],
                                   (rnd<true>(dr * wv.y) - x1 * v[mt][h]) * inrm[mt][h]);
        }
      }
    TC_PHASE(18);

    // d a = rnd(d_c R^T); d_sim = g1 a (d a - sum_R a d a); DS = rnd(d_sim)
    float da[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[mt][jj][e] = 0.f;
    tcd_rows_by_regions<MT, NQ>(da, dc, ri, ntR0, ntwR, d, s TC_PHASE_PASS);
    tc_dsim<MT>(a, da, v, ntR0, ntwR, d, s);
    __syncthreads();
    TC_PHASE(20);

    // d_w += DS R (DS where the product reads P), a chunk of columns at a time
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][q][e] = 0.f;
    tcs_attn_by_regions<MT, NQ>(c, ri, d, s TC_PHASE_PASS);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (q < nq && q * 8 + warp < nD) add_dw(mt, q, h, c[mt][q][2 * h], c[mt][q][2 * h + 1]);
    TC_PHASE(11);
    TC_PHASE_COUNT(TC_PASSES);
  }
  __syncthreads();  // DW whole

  // the pass's rows of partial[split]: d_w, each element stored once
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + (lane >> 2) + 8 * h;
      if (row >= rows) continue;
      float* o = out + (size_t(s.cap_j[s.row_c[row]]) * d.T + s.row_t[row]) * d.D;
#pragma unroll
      for (int q = 0; q < QREG; ++q) {
        const int col = (q * 8 + warp) * 8 + q2;
        if (q * 8 + warp >= nD) continue;
        if (col < d.D) o[col] = dwr[mt][q][2 * h];
        if (col + 1 < d.D) o[col + 1] = dwr[mt][q][2 * h + 1];
      }
    }
  const int ncol = d.D - QREG * TCS_KC;
  for (int e = threadIdx.x; e < rows * ncol; e += kThreads) {
    const int m = e / ncol, k = e % ncol;
    out[(size_t(s.cap_j[s.row_c[m]]) * d.T + s.row_t[m]) * d.D + QREG * TCS_KC + k] =
        DW[m * swd + k];
  }
  // the padded slots of the pass's captions: 0
  for (int e = warp; e < (c1 - c0) * d.T; e += kWarps) {
    const size_t slot = size_t(c0) * d.T + e;
    if (mask[slot] == 0) continue;
    for (int k = lane; k < d.D; k += 32) out[slot * d.D + k] = 0.f;
  }
  TC_PHASE_FLUSH
}

template <int MT, int NQ, int QREG>
int launch_dw_tcs(const void* r, const void* w, const uint8_t* mask, const float* g, int* plan,
                  float* partial, float* dw, const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dw_tcs_kernel<MT, NQ, QREG>;
  const size_t bytes = tcd_smem_bytes(d, QREG);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  damsm_dw_passes_kernel<<<1, kThreads, 0, st>>>(mask, plan, d);
  k<<<dim3(d.Bc, nsplit), kThreads, bytes, st>>>(static_cast<const __nv_bfloat16*>(r),
                                                 static_cast<const __nv_bfloat16*>(w), mask, g,
                                                 plan, partial, d, nsplit);
  if (partial != dw) launch_sum(partial, dw, 1, nsplit, int64_t(d.Bc) * d.T * d.D, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 d_regions and forward on the CUDA cores at R, D <= 256, the real words
// packed and the regions streamed (header: "The fp32 d_regions", "The fp32
// forward").
// ---------------------------------------------------------------------------

constexpr int F32_MAX_RD = 256;   // R and D limit: every [rows, *] tile is 256 wide
constexpr int F32_S = 260;        // row stride (fp32) of those tiles: rows 4 banks apart
constexpr int F32_KC = 32;        // regions' columns (sim, d a) or rows (c) per chunk
constexpr int F32_SC = 36;        // row stride of a column chunk [256][F32_SC]
constexpr int F32_ROWS = 48;      // word rows per pass of the d_regions
constexpr int F32_FWD_ROWS = 64;  // word rows per pass of the forward
constexpr int F32_CHUNK = F32_MAX_RD * F32_SC;  // fp32 per chunk buffer
static_assert(F32_S == F32_MAX_RD + 4 && F32_SC == F32_KC + 4, "16-byte rows, 4 banks apart");
static_assert(F32_KC * F32_S <= F32_CHUNK, "a row chunk fits a chunk buffer");
static_assert(F32_KC * F32_MAX_RD / 4 == 8 * kThreads, "a chunk is 8 16-byte pieces a thread");

// Words W, d_c DC (the d_regions' only, bwd: in the forward DC is A, unused)
// and a A [Mp][F32_S] (fp32); the two chunk buffers Rb [2][F32_CHUNK], in whose place
// d_sim DS [Mp][F32_S] stands during the d_r accumulation; then rel, drel,
// the 4 column warps' row partials red [4][Mp], the row map and caption slots
// [Mp] each and info [4] as the tensor-core kernels lay them out (tc: their
// bf16 tiles unused).  sw is W's row stride; Wd, the wide d_regions' words
// tile for its d_r accumulation (f32w_carve), is W here.
struct F32Smem {
  float *W, *DC, *A, *Rb, *DS, *Wd;
  int sw;
  TcSmem tc;
};

size_t f32_smem_bytes(int Mp, bool bwd) {
  return 4 * (size_t(bwd ? 3 : 2) * Mp * F32_S + 2 * size_t(F32_CHUNK) + size_t(11) * Mp + 4);
}

__device__ F32Smem f32_carve(float* base, int Mp, bool bwd) {
  F32Smem s;
  s.W = base;
  s.DC = s.W + Mp * F32_S;
  s.A = bwd ? s.DC + Mp * F32_S : s.DC;
  s.Rb = s.A + Mp * F32_S;
  s.DS = s.Rb;
  s.Wd = s.W;
  s.sw = F32_S;
  s.tc = TcSmem{};
  s.tc.rel = s.Rb + 2 * F32_CHUNK;
  s.tc.drel = s.tc.rel + Mp;
  s.tc.red = s.tc.drel + Mp;
  s.tc.row_t = reinterpret_cast<int*>(s.tc.red + 4 * Mp);
  s.tc.row_c = s.tc.row_t + Mp;
  s.tc.cap_j = s.tc.row_c + Mp;
  s.tc.cap_base = s.tc.cap_j + Mp;
  s.tc.cap_n = s.tc.cap_base + Mp;
  s.tc.info = s.tc.cap_n + Mp;
  return s;
}

// A thread's rows and columns of the [Mp, 256] products: row group rg (0..7)
// owns the rows rg + 8 i; column group cg (0..31) owns the regions cg + 32 j
// (sim, d a) or the features 4 cg + 128 h + e (c).  A warp is 4 row groups
// by 8 column groups, so each 16-byte shared load of a product reads 4 rows
// of one operand and 8 of the other, each row in its own bank group.
__device__ __forceinline__ int f32_rg() { return ((threadIdx.x >> 7) << 2) + ((threadIdx.x & 31) >> 3); }
__device__ __forceinline__ int f32_cg() { return ((threadIdx.x >> 5) & 3) * 8 + (threadIdx.x & 7); }

__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// v[i] = the block's sum (or max) over row rg + 8 i of every thread's partial:
// the row group's 8 lanes by shuffles, then its 4 column warps in a fixed order.
template <int MT, bool MAX>
__device__ __forceinline__ void f32_rows(float (&v)[MT], float* red) {
  constexpr int Mp = 8 * MT;
  const int rg = f32_rg(), wc = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = MAX ? fmaxf(x, y) : x + y;
    }
    if ((threadIdx.x & 7) == 0) red[wc * Mp + rg + 8 * i] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = rg + 8 * i;
    float x = red[row];
#pragma unroll
    for (int w = 1; w < 4; ++w) x = MAX ? fmaxf(x, red[w * Mp + row]) : x + red[w * Mp + row];
    v[i] = x;
  }
  __syncthreads();
}

// Chunk q of the image's regions ri [R][D] into the buffer dst: the rows
// 32q .. 32q+31 with the 256 columns from d0 ([32][F32_S], ROWS) or the
// columns 32q .. 32q+31 of all 256 rows ([256][F32_SC]); zero past R and D.
// 16-byte cp.async (zero-filled out of range) where the rows are 16-byte
// aligned (d.vec), else plain loads and stores.
template <bool ROWS>
__device__ __forceinline__ void f32_load_chunk(float* dst, const float* __restrict__ ri, int q,
                                               const TcDims& d, int d0 = 0) {
  // piece e of the chunk's 2,048 16-byte pieces: its shared offset, region row and column
  auto piece = [&](int e, int& to, int& r, int& k) {
    if (ROWS) {
      to = (e >> 6) * F32_S + (e & 63) * 4;
      r = q * F32_KC + (e >> 6);
      k = d0 + (e & 63) * 4;
    } else {
      to = (e >> 3) * F32_SC + (e & 7) * 4;
      r = e >> 3;
      k = q * F32_KC + (e & 7) * 4;
    }
  };
  if (d.vec) {
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      int to, r, k;
      piece(threadIdx.x + it * kThreads, to, r, k);
      const bool in = r < d.R && k < d.D;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :
                   : "r"(smem_u32(dst + to)), "l"(in ? ri + size_t(r) * d.D + k : ri),
                     "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < 8 * kThreads; e += kThreads) {
      int to, r, k;
      piece(e, to, r, k);
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[c] = r < d.R && k + c < d.D ? ri[size_t(r) * d.D + k + c] : 0.f;
      *reinterpret_cast<float4*>(dst + to) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// A sweep over nq chunks of the regions through the two chunk buffers Rb,
// double-buffered: load(buffer, q) starts chunk q's copy; after the barrier
// that makes chunk q visible (and ends every warp's products on chunk q - 1,
// whose buffer is next), chunk q + 1 loads with cp.async while
// compute(buffer, q) runs on chunk q.  Phase SLOT takes the products and
// starting the loads, slot 13 the waits.  Ends after a barrier.
template <int SLOT, class L, class F>
__device__ __forceinline__ void f32_sweep(int nq, float* Rb, L&& load, F&& compute TC_PHASE_ARGS) {
  load(Rb, 0);
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    TC_PHASE(SLOT);
    cp_async_wait_all();
    __syncthreads();
    TC_PHASE(13);
    if (q + 1 < nq) load(Rb + ((q + 1) & 1) * F32_CHUNK, q + 1);
    cp_async_commit();
    compute(Rb + (q & 1) * F32_CHUNK, q);
  }
  __syncthreads();
  TC_PHASE(SLOT);
}

// One product's sweep over the nq chunks of the regions (ROWS: row chunks,
// else column chunks; f32_sweep).
template <bool ROWS, int SLOT, class F>
__device__ __forceinline__ void f32_stream(const float* __restrict__ ri, int nq, const TcDims& d,
                                           const F32Smem& s, F&& compute TC_PHASE_ARGS) {
  f32_sweep<SLOT>(
      nq, s.Rb, [&](float* buf, int q) { f32_load_chunk<ROWS>(buf, ri, q, d); }, compute
      TC_PHASE_PASS);
}

// acc[i][j] += sum_k A[rg + 8i][k0 + k] C[cg + 32j][k] over a column chunk C
// of the regions (sim = W R^T, d a = d_c R^T; A's rows sa apart): both
// operands read along k, 16 bytes at a time, MT + 8 loads for 32 MT FMAs.
template <int MT>
__device__ __forceinline__ void f32_by_cols(float (&acc)[MT][8], const float* A, int sa,
                                            const float* C, int k0) {
  const float* a0 = A + f32_rg() * sa + k0;
  const float* c0 = C + f32_cg() * F32_SC;
#pragma unroll 1  // the code of a chunk's products stays small (instruction cache)
  for (int k = 0; k < F32_KC; k += 4) {
    float4 a[MT], b[8];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + 8 * i * sa + k);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(c0 + 32 * j * F32_SC + k);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        acc[i][j] = x;
      }
  }
}

// acc[i][4h + e] += sum_k A[rg + 8i][k0 + k] Rr[k][4cg + 128h + e] over a row
// chunk Rr of the regions (c = a R): A read along k, the regions along their
// features, 16 bytes at a time, MT + 8 loads for 32 MT FMAs.
template <int MT>
__device__ __forceinline__ void f32_by_rows(float (&acc)[MT][8], const float* A, const float* Rr,
                                            int k0) {
  const float* a0 = A + f32_rg() * F32_S + k0;
  const float* r0 = Rr + 4 * f32_cg();
#pragma unroll 1  // as f32_by_cols
  for (int k = 0; k < F32_KC; k += 4) {
    float4 a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + 8 * i * F32_S + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b0 = *reinterpret_cast<const float4*>(r0 + (k + u) * F32_S);
      const float4 b1 = *reinterpret_cast<const float4*>(r0 + (k + u) * F32_S + 128);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float av = f4_at(a[i], u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fmaf(av, f4_at(b0, e), acc[i][e]);
          acc[i][4 + e] = fmaf(av, f4_at(b1, e), acc[i][4 + e]);
        }
      }
    }
  }
}

// The features d0 .. d0+ncol-1 of the pass's word rows into dst [Mp][sd]
// (rows past the pass's and features past D are 0).
__device__ __forceinline__ void f32_load_words(float* dst, int sd, int ncol, int d0,
                                               const float* __restrict__ w, int rows,
                                               const TcDims& d, const TcSmem& s) {
  for (int e = threadIdx.x; e < d.Mp * (ncol / 4); e += kThreads) {
    const int m = e / (ncol / 4), k = d0 + (e % (ncol / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < rows && k < d.D) {
      const float* src = w + (size_t(s.cap_j[s.row_c[m]]) * d.T + s.row_t[m]) * d.D + k;
      if (d.vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = k + q < d.D ? src[q] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dst + m * sd + k - d0) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The next pass of captions j .. c1-1: warp 0 packs it (tc_pack_pass), the
// block loads its words into W (ncol features a row: rows past it and
// columns past D are 0).  Returns its word rows (0: the remaining captions
// are all padded) and moves j past its captions.
__device__ __forceinline__ int f32_next_pass(const float* __restrict__ w,
                                             const uint8_t* __restrict__ mask, int& j, int c1,
                                             const TcDims& d, const F32Smem& s,
                                             int ncol TC_PHASE_ARGS) {
  __syncthreads();  // the previous pass is done with the tiles and the row map
  if (threadIdx.x < 32) tc_pack_pass(mask, j, c1, d, s.tc);
  __syncthreads();
  TC_PHASE(0);
  const int rows = s.tc.info[0];
  j = s.tc.info[2];
  if (rows == 0) return 0;
  f32_load_words(s.W, s.sw, ncol, 0, w, rows, d, s.tc);
  __syncthreads();
  TC_PHASE(1);
  return rows;
}

// a = softmax_R(g1 sim) from the thread's sim sums into A (0 at padded
// regions; a thread's sums are its rows' regions cg + 32 j).  Ends after a
// barrier.
template <int MT>
__device__ __forceinline__ void f32_softmax(float (&a)[MT][8], const TcDims& d, const F32Smem& s) {
  const int rg = f32_rg(), cg = f32_cg();
  float v[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    v[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (cg + 32 * j < d.R) v[i] = fmaxf(v[i], d.g1 * a[i][j]);
  }
  f32_rows<MT, true>(v, s.tc.red);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float mx = v[i];
    v[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = cg + 32 * j < d.R ? expf(d.g1 * a[i][j] - mx) : 0.f;
      a[i][j] = x;
      v[i] += x;
    }
  }
  f32_rows<MT, false>(v, s.tc.red);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float inv = 1.f / v[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) s.A[(rg + 8 * i) * F32_S + cg + 32 * j] = a[i][j] * inv;
  }
  __syncthreads();
}

// d_sim = g1 a (d a - sum_R a d a) into DS (0 at padded regions), from the
// thread's d a sums (its rows' regions cg + 32 j) and a in A.  Ends after a
// barrier.
template <int MT>
__device__ __forceinline__ void f32_dsim(const float (&da)[MT][8], const TcDims& d,
                                         const F32Smem& s) {
  const int rg = f32_rg(), cg = f32_cg();
  float v[MT];
#pragma unroll
  for (int q = 0; q < MT; ++q) {
    v[q] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < 8; ++j2) {
      const int col = cg + 32 * j2;
      if (col < d.R) v[q] = fmaf(s.A[(rg + 8 * q) * F32_S + col], da[q][j2], v[q]);
    }
  }
  f32_rows<MT, false>(v, s.tc.red);
#pragma unroll
  for (int q = 0; q < MT; ++q)
#pragma unroll
    for (int j2 = 0; j2 < 8; ++j2) {
      const int col = cg + 32 * j2, at = (rg + 8 * q) * F32_S + col;
      s.DS[at] = col < d.R ? d.g1 * (s.A[at] * (da[q][j2] - v[q])) : 0.f;
    }
  __syncthreads();
}

// A pass's chain up to rel, in fp32, on the words in W: sim = W R^T over the
// column chunks; a = softmax_R(g1 sim) into A (0 at padded regions; not kept
// in registers, which the products need); c = a R over the row chunks;
// c_hat = c inrm with inrm = 1 / max(|c|, 1e-12) (c_hat left in c); rel =
// sum_D c_hat w into rel.  One reciprocal a row, as the tensor-core kernels
// take it, in place of a division an element: less code (the instruction
// cache holds the passes' code only in part).  The fp32 forward and
// d_regions both run it.  Ends after a barrier.
template <int MT>
__device__ __forceinline__ void f32_attend(float (&c)[MT][8], float (&inrm)[MT],
                                           const float* __restrict__ ri, const TcDims& d,
                                           const F32Smem& s TC_PHASE_ARGS) {
  const int rg = f32_rg(), cg = f32_cg();
  float a[MT][8], v[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
  f32_stream<false, 14>(ri, (d.D + F32_KC - 1) / F32_KC, d, s,
                        [&](const float* C, int q) {
                          f32_by_cols<MT>(a, s.W, F32_S, C, q * F32_KC);
                        }
                        TC_PHASE_PASS);
  f32_softmax<MT>(a, d, s);
  TC_PHASE(15);

  // c = a R; c_hat = c / max(|c|, 1e-12); rel = sum_D c_hat w
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  f32_stream<true, 16>(ri, (d.R + F32_KC - 1) / F32_KC, d, s,
                       [&](const float* Rr, int q) { f32_by_rows<MT>(c, s.A, Rr, q * F32_KC); }
                       TC_PHASE_PASS);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    v[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i] = fmaf(c[i][j], c[i][j], v[i]);
  }
  f32_rows<MT, false>(v, s.tc.red);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    inrm[i] = 1.f / fmaxf(sqrtf(v[i]), 1e-12f);
    v[i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 wv =
          *reinterpret_cast<const float4*>(s.W + (rg + 8 * i) * F32_S + 4 * cg + 128 * h);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ch = c[i][4 * h + e] * inrm[i];
        c[i][4 * h + e] = ch;
        v[i] = fmaf(ch, f4_at(wv, e), v[i]);
      }
    }
  }
  f32_rows<MT, false>(v, s.tc.red);
  if (((threadIdx.x >> 5) & 3) == 0 && (threadIdx.x & 7) == 0)
#pragma unroll
    for (int i = 0; i < MT; ++i) s.tc.rel[rg + 8 * i] = v[i];
  __syncthreads();
  TC_PHASE(17);
}

// d_r [R, D] (the block's slice) = or += A^T DC + DS^T W over its features
// dlo .. dhi-1, contracted over the pass's rows (rows past them add exactly
// 0: their d_c and d_sim are 0).  DC and W hold those features from their
// column 0, rows sdc and sw apart (A and DS: F32_S).  In 128 x 128 tiles; a
// thread owns the rows r0 + 4 ty + 64 hr + e and the columns d0 + 4 tx +
// 64 hd + e (ty, tx = tid / 16, tid % 16), reads all four operands as
// 16-byte rows (8 loads for 128 FMAs) and loads the slice's earlier sums
// before its products, so their latency hides behind them.
__device__ __forceinline__ void f32_accumulate_dr(float* __restrict__ out, bool first, int rows,
                                                  const TcDims& d, const F32Smem& s,
                                                  const float* DC, int sdc, const float* W, int sw,
                                                  int dlo, int dhi TC_PHASE_ARGS) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool vec4 = (d.D & 3) == 0;
  const int rows4 = (rows + 3) & ~3;
  for (int r0 = 0; r0 < d.R; r0 += 128)
    for (int d0 = dlo; d0 < dhi; d0 += 128) {
      const int ra = r0 + 4 * ty, ca = d0 + 4 * tx;
      float prev[8][8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int row = ra + 64 * (x >> 2) + (x & 3);
#pragma unroll
        for (int hd = 0; hd < 2; ++hd) {
          const int col = ca + 64 * hd;
#pragma unroll
          for (int e = 0; e < 4; ++e) prev[x][4 * hd + e] = 0.f;
          if (first || row >= d.R) continue;
          const float* o = out + size_t(row) * d.D + col;
          if (vec4) {
            if (col < d.D) {
              const float4 v = *reinterpret_cast<const float4*>(o);
#pragma unroll
              for (int e = 0; e < 4; ++e) prev[x][4 * hd + e] = f4_at(v, e);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < d.D) prev[x][4 * hd + e] = o[e];
          }
        }
      }
      float acc[8][8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = 0.f;
#pragma unroll 2
      for (int m = 0; m < rows4; ++m) {
        float4 op[4][2];  // a, d_sim (rows), d_c, w (columns): 2 x 16 bytes each
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          op[0][h] = *reinterpret_cast<const float4*>(s.A + m * F32_S + ra + 64 * h);
          op[1][h] = *reinterpret_cast<const float4*>(s.DS + m * F32_S + ra + 64 * h);
          op[2][h] = *reinterpret_cast<const float4*>(DC + m * sdc + ca - dlo + 64 * h);
          op[3][h] = *reinterpret_cast<const float4*>(W + m * sw + ca - dlo + 64 * h);
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float av = f4_at(op[0][x >> 2], x & 3), sv = f4_at(op[1][x >> 2], x & 3);
#pragma unroll
          for (int y = 0; y < 8; ++y)
            acc[x][y] = fmaf(sv, f4_at(op[3][y >> 2], y & 3),
                             fmaf(av, f4_at(op[2][y >> 2], y & 3), acc[x][y]));
        }
      }
      TC_PHASE(7);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int row = ra + 64 * (x >> 2) + (x & 3);
        if (row >= d.R) continue;
#pragma unroll
        for (int hd = 0; hd < 2; ++hd) {
          const int col = ca + 64 * hd;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = acc[x][4 * hd + e] + prev[x][4 * hd + e];
          float* o = out + size_t(row) * d.D + col;
          if (vec4) {
            if (col < d.D) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < d.D) o[e] = v[e];
          }
        }
      }
      TC_PHASE(8);
    }
}

// d_regions, fp32 operands, R, D <= 256: block (image i, split).  The split's
// captions go in passes of at most Mp = 8 MT real word rows (tc_pack_pass);
// each pass runs the chain to rel (f32_attend), its backward to d_c and
// d_sim, and adds A^T DC + DS^T W into partial[i][split].
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_dr_f32_kernel(const float* __restrict__ r, const float* __restrict__ w,
                        const uint8_t* __restrict__ mask, const float* __restrict__ g,
                        float* __restrict__ partial, TcDims d, int nsplit) {
  static_assert(8 * MT * F32_S <= 2 * F32_CHUNK, "d_sim fits in the chunk buffers");
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const F32Smem s = f32_carve(reinterpret_cast<float*>(tc_smem_raw), 8 * MT, true);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int rg = f32_rg(), cg = f32_cg();
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out = partial + (size_t(i) * nsplit + split) * d.R * d.D;
  const float* ri = r + size_t(i) * d.R * d.D;
  bool first = true;
  for (int j = c0; j < c1;) {
    const int rows = f32_next_pass(w, mask, j, c1, d, s, F32_MAX_RD TC_PHASE_PASS);
    if (rows == 0) break;
    const int ncap = s.tc.info[1];
    float c[MT][8], inrm[MT], v[MT];
    f32_attend<MT>(c, inrm, ri, d, s TC_PHASE_PASS);

    tc_drel(g, i, rows, ncap, d, s.tc);
    __syncthreads();
    TC_PHASE(4);

    // d c_hat = d rel w; d_c = (d c_hat - c_hat <c_hat, d c_hat>) inrm into DC
#pragma unroll
    for (int q = 0; q < MT; ++q) {
      const int row = rg + 8 * q;
      const float dr = s.tc.drel[row];
      v[q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 wv = *reinterpret_cast<const float4*>(s.W + row * F32_S + 4 * cg + 128 * h);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[q] = fmaf(c[q][4 * h + e], dr * f4_at(wv, e), v[q]);
      }
    }
    f32_rows<MT, false>(v, s.tc.red);
#pragma unroll
    for (int q = 0; q < MT; ++q) {
      const int row = rg + 8 * q;
      const float dr = s.tc.drel[row];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dc = s.DC + row * F32_S + 4 * cg + 128 * h;
        const float4 wv = *reinterpret_cast<const float4*>(s.W + row * F32_S + 4 * cg + 128 * h);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = (dr * f4_at(wv, e) - c[q][4 * h + e] * v[q]) * inrm[q];
        *reinterpret_cast<float4*>(dc) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
    __syncthreads();
    TC_PHASE(18);

    // d a = d_c R^T; d_sim = g1 a (d a - sum_R a d a) into DS (0 at padded regions)
    float da[MT][8];
#pragma unroll
    for (int q = 0; q < MT; ++q)
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) da[q][j2] = 0.f;
    f32_stream<false, 19>(ri, (d.D + F32_KC - 1) / F32_KC, d, s,
                          [&](const float* C, int q) {
                            f32_by_cols<MT>(da, s.DC, F32_S, C, q * F32_KC);
                          }
                          TC_PHASE_PASS);
    f32_dsim<MT>(da, d, s);
    TC_PHASE(20);

    f32_accumulate_dr(out, first, rows, d, s, s.DC, F32_S, s.W, F32_S, 0, d.D TC_PHASE_PASS);
    TC_PHASE_SYNC(11);
    TC_PHASE_COUNT(TC_PASSES);
    first = false;
  }
  if (first)  // no caption of the split has a real word: the slice is 0
    for (int e = threadIdx.x; e < d.R * d.D; e += kThreads) out[e] = 0.f;
  TC_PHASE_FLUSH
}

// The forward, fp32 operands, R, D <= 256: block (image i, split).  The
// split's captions go in passes of at most Mp = 8 MT real word rows
// (tc_pack_pass); each pass runs the chain to rel (f32_attend) and writes the
// score of each of its captions to out[i][j].
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_fwd_f32_kernel(const float* __restrict__ r, const float* __restrict__ w,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, TcDims d,
                     int nsplit) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const F32Smem s = f32_carve(reinterpret_cast<float*>(tc_smem_raw), 8 * MT, false);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out_i = out + size_t(i) * d.Bc;
  const float* ri = r + size_t(i) * d.R * d.D;
  tc_padded_scores(mask, c0, c1, d, lane, warp, out_i);
  for (int j = c0; j < c1;) {
    if (f32_next_pass(w, mask, j, c1, d, s, F32_MAX_RD TC_PHASE_PASS) == 0) break;
    float c[MT][8], inrm[MT];
    f32_attend<MT>(c, inrm, ri, d, s TC_PHASE_PASS);
    tc_write_scores(s.tc, d, lane, warp, out_i);
    TC_PHASE_SYNC(12);
    TC_PHASE_COUNT(TC_PASSES);
  }
  TC_PHASE_FLUSH
}

// TcDims of the fp32 kernels: 16-byte global loads where D % 4 == 0 and both
// operands are 16-byte aligned
TcDims make_f32_dims(int B, int Bc, int R, int T, int D, int Mp, float g1, float g2,
                     const void* r, const void* w) {
  TcDims t = make_tc_dims(B, Bc, R, T, D, Mp, g1, g2, r, w);
  t.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return t;
}

bool f32_dims_ok(const TcDims& d, int rows) {
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.D > 0 && d.R <= F32_MAX_RD &&
         d.D <= F32_MAX_RD && d.Mp == rows && d.T <= d.Mp;
}

template <int MT>
int launch_fwd_f32(const float* r, const float* w, const uint8_t* mask, float* out,
                   const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_fwd_f32_kernel<MT>;
  const size_t bytes = f32_smem_bytes(8 * MT, false);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(r, w, mask, out, d, nsplit);
  return int(cudaGetLastError());
}

template <int MT>
int launch_dr_f32(const float* r, const float* w, const uint8_t* mask, const float* g,
                  float* partial, float* dr, const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dr_f32_kernel<MT>;
  const size_t bytes = f32_smem_bytes(8 * MT, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, nsplit);
  k<<<grid, kThreads, bytes, st>>>(r, w, mask, g, partial, d, nsplit);
  if (partial != dr) launch_sum(partial, dr, d.B, nsplit, int64_t(d.R) * d.D, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 forward and d_regions on the CUDA cores at 256 < D <= 1024, R <= 256,
// the real words packed and the regions streamed (header: "The wide fp32
// forward and d_regions").
// ---------------------------------------------------------------------------

constexpr int F32W_MAX_D = 1024;   // D limit
constexpr int F32W_ROWS = 32;      // word rows per pass where the words tile fits (D <= 768),
constexpr int F32W_ROWS_MIN = 24;  // else 24
constexpr int F32W_DG = 256;       // features of a context group: 8 sums a thread
static_assert(F32W_DG == F32_MAX_RD, "a group of features is a row chunk's 256 columns");
static_assert(2 * F32W_ROWS * F32_S <= 2 * F32_CHUNK,
              "d_sim and a group of the words fit in the chunk buffers");

// The words tile's row stride: D rounded up to whole groups of features, + 4
// so that rows lie 4 banks apart.
__host__ __device__ inline int f32w_stride(int D) { return round_up(D, F32W_DG) + 4; }

// Words W [Mp][f32w_stride(D)] (the d_regions' d_c takes their place a group
// at a time), a A [Mp][F32_S], the two chunk buffers Rb [2][F32_CHUNK] (the
// d_regions' d_sim DS and one group of the words Wd, [Mp][F32_S] each, take
// their place for the d_r accumulation) and 11 fp32/int words a row, as
// f32_carve lays them out.
size_t f32w_smem_bytes(int Mp, int D) {
  return 4 * (size_t(Mp) * (f32w_stride(D) + F32_S) + 2 * size_t(F32_CHUNK) + size_t(11) * Mp +
              4);
}

// Its rows' part (rel .. info) is written out as in f32_carve: a helper
// shared by the two carves changed the SASS of the bf16 d_regions kernels,
// which call neither (nvcc 12.9, sm_90a).
__device__ F32Smem f32w_carve(float* base, int Mp, int D) {
  F32Smem s;
  s.sw = f32w_stride(D);
  s.W = base;
  s.DC = s.W;
  s.A = s.W + Mp * s.sw;
  s.Rb = s.A + Mp * F32_S;
  s.DS = s.Rb;
  s.Wd = s.Rb + Mp * F32_S;
  s.tc = TcSmem{};
  s.tc.rel = s.Rb + 2 * F32_CHUNK;
  s.tc.drel = s.tc.rel + Mp;
  s.tc.red = s.tc.drel + Mp;
  s.tc.row_t = reinterpret_cast<int*>(s.tc.red + 4 * Mp);
  s.tc.row_c = s.tc.row_t + Mp;
  s.tc.cap_j = s.tc.row_c + Mp;
  s.tc.cap_base = s.tc.cap_j + Mp;
  s.tc.cap_n = s.tc.cap_base + Mp;
  s.tc.info = s.tc.cap_n + Mp;
  return s;
}

bool f32w_dims_ok(const TcDims& d) {
  return d.B > 0 && d.B <= 65535 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.R <= F32_MAX_RD &&
         d.D > F32_MAX_RD && d.D <= F32W_MAX_D &&
         (d.Mp == F32W_ROWS || d.Mp == F32W_ROWS_MIN) && d.T <= d.Mp &&
         f32w_smem_bytes(d.Mp, d.D) <= size_t(SMEM_LIMIT);
}

// |c|^2 and c . w from the thread's context sums c over a group of 256
// features (its features 4 cg + 128 h + e, the words tile's from Wc) into cc
// and cw; c is reset to 0 for the next group unless kept (the fp32 d_words
// keeps the last group's).
template <int MT>
__device__ __forceinline__ void f32w_fold(float (&c)[MT][8], float (&cc)[MT], float (&cw)[MT],
                                          const float* Wc, int sw, bool keep) {
  const int rg = f32_rg(), cg = f32_cg();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 wv =
          *reinterpret_cast<const float4*>(Wc + (rg + 8 * i) * sw + 4 * cg + 128 * h);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = c[i][4 * h + e];
        cc[i] = fmaf(x, x, cc[i]);
        cw[i] = fmaf(x, f4_at(wv, e), cw[i]);
        if (!keep) c[i][4 * h + e] = 0.f;
      }
    }
}

// d_c = sc (w - sr c) over a group of 256 features from the thread's context
// sums c, with sc = d rel inrm and sr = rel inrm a row (d c_hat = d rel w and
// <c_hat, d c_hat> = d rel rel, so d_c = (d c_hat - c_hat <c_hat, d c_hat>)
// inrm), written over the group's words at Wc; c is reset to 0.
template <int MT>
__device__ __forceinline__ void f32w_dc(float (&c)[MT][8], const float (&sc)[MT],
                                        const float (&sr)[MT], float* Wc, int sw) {
  const int rg = f32_rg(), cg = f32_cg();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = Wc + (rg + 8 * i) * sw + 4 * cg + 128 * h;
      const float4 wv = *reinterpret_cast<const float4*>(p);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = sc[i] * (f4_at(wv, e) - sr[i] * c[i][4 * h + e]);
        c[i][4 * h + e] = 0.f;
      }
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    }
}

// A pass's chain up to rel at 256 < D <= 1024, in fp32, on the words in W:
// sim = W R^T over the column chunks and a = softmax_R(g1 sim) into A, as
// f32_attend; then c = a R a group of 256 features at a time, the group's
// R / 32 row chunks in turn within one sweep, each group folded into |c|^2
// and c . w as it completes (f32w_fold), so that c is never stored; inrm =
// 1 / max(|c|, 1e-12) (the one reciprocal a row) and rel = (c . w) inrm into
// rel.  KEEP: c holds the last group's context sums on return (the fp32
// d_words takes its d_c from them); else c is scratch.  Ends after a barrier.
template <int MT, bool KEEP>
__device__ __forceinline__ void f32w_chain(float (&inrm)[MT], float (&c)[MT][8],
                                           const float* __restrict__ ri, const TcDims& d,
                                           const F32Smem& s TC_PHASE_ARGS) {
  const int rg = f32_rg();
  const int nr = (d.R + F32_KC - 1) / F32_KC, ng = (d.D + F32W_DG - 1) / F32W_DG;
  float a[MT][8];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
  f32_stream<false, 14>(ri, (d.D + F32_KC - 1) / F32_KC, d, s,
                        [&](const float* C, int q) {
                          f32_by_cols<MT>(a, s.W, s.sw, C, q * F32_KC);
                        }
                        TC_PHASE_PASS);
  f32_softmax<MT>(a, d, s);
  TC_PHASE(15);

  float cc[MT], cw[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    cc[i] = cw[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }
  f32_sweep<16>(
      nr * ng, s.Rb,
      [&](float* buf, int q) { f32_load_chunk<true>(buf, ri, q % nr, d, (q / nr) * F32W_DG); },
      [&](const float* Rr, int q) {
        f32_by_rows<MT>(c, s.A, Rr, (q % nr) * F32_KC);
        if (q % nr == nr - 1)
          f32w_fold<MT>(c, cc, cw, s.W + (q / nr) * F32W_DG, s.sw, KEEP && q / nr == ng - 1);
      } TC_PHASE_PASS);
  f32_rows<MT, false>(cc, s.tc.red);
  f32_rows<MT, false>(cw, s.tc.red);
#pragma unroll
  for (int i = 0; i < MT; ++i) inrm[i] = 1.f / fmaxf(sqrtf(cc[i]), 1e-12f);
  if (((threadIdx.x >> 5) & 3) == 0 && (threadIdx.x & 7) == 0)
#pragma unroll
    for (int i = 0; i < MT; ++i) s.tc.rel[rg + 8 * i] = cw[i] * inrm[i];
  __syncthreads();
  TC_PHASE(17);
}

// The chain to rel of the wide forward and d_regions (f32w_chain, the
// context not kept).
template <int MT>
__device__ __forceinline__ void f32w_attend(float (&inrm)[MT], const float* __restrict__ ri,
                                            const TcDims& d, const F32Smem& s TC_PHASE_ARGS) {
  float c[MT][8];
  f32w_chain<MT, false>(inrm, c, ri, d, s TC_PHASE_PASS);
}

// d_regions, fp32 operands, 256 < D <= 1024, R <= 256: block (image i,
// split).  Each pass runs the chain to rel (f32w_attend)
// and d rel; one sweep then takes the context again a group of 256 features
// at a time (the group's row chunks), turns it into d_c over the group's
// words in W (f32w_dc) and adds d_c R^T into d a (the group's column chunks,
// up to D); d_sim goes into DS; then, a group at a time, the group's words
// come back into Wd and A^T DC + DS^T Wd is added into partial[i][split].
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_dr_f32w_kernel(const float* __restrict__ r, const float* __restrict__ w,
                         const uint8_t* __restrict__ mask, const float* __restrict__ g,
                         float* __restrict__ partial, TcDims d, int nsplit) {
  static_assert(8 * MT <= F32W_ROWS, "d_sim and a group of the words fit in the chunk buffers");
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const F32Smem s = f32w_carve(reinterpret_cast<float*>(tc_smem_raw), 8 * MT, d.D);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int rg = f32_rg();
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out = partial + (size_t(i) * nsplit + split) * d.R * d.D;
  const float* ri = r + size_t(i) * d.R * d.D;
  // the sweep's chunks: a group is its nr row chunks, then its kg column
  // chunks (the last group's only up to D)
  const int nr = (d.R + F32_KC - 1) / F32_KC, nk = (d.D + F32_KC - 1) / F32_KC;
  const int ng = (d.D + F32W_DG - 1) / F32W_DG, kg = F32W_DG / F32_KC, per_g = nr + kg;
  bool first = true;
  for (int j = c0; j < c1;) {
    const int rows = f32_next_pass(w, mask, j, c1, d, s, round_up(d.D, F32W_DG) TC_PHASE_PASS);
    if (rows == 0) break;
    float inrm[MT];
    f32w_attend<MT>(inrm, ri, d, s TC_PHASE_PASS);
    tc_drel(g, i, rows, s.tc.info[1], d, s.tc);
    __syncthreads();
    TC_PHASE(4);

    // c again, d_c over the words and d a += d_c R^T, a group at a time
    float sc[MT], sr[MT], c[MT][8], da[MT][8];
#pragma unroll
    for (int q = 0; q < MT; ++q) {
      sc[q] = s.tc.drel[rg + 8 * q] * inrm[q];
      sr[q] = s.tc.rel[rg + 8 * q] * inrm[q];
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) c[q][j2] = da[q][j2] = 0.f;
    }
    f32_sweep<19>(
        (ng - 1) * per_g + nr + nk - (ng - 1) * kg, s.Rb,
        [&](float* buf, int q) {
          const int gq = min(q / per_g, ng - 1), k = q - gq * per_g;
          if (k < nr) f32_load_chunk<true>(buf, ri, k, d, gq * F32W_DG);
          else f32_load_chunk<false>(buf, ri, gq * kg + k - nr, d);
        },
        [&](const float* C, int q) {
          const int gq = min(q / per_g, ng - 1), k = q - gq * per_g;
          if (k < nr) {
            f32_by_rows<MT>(c, s.A, C, k * F32_KC);
            if (k == nr - 1) f32w_dc<MT>(c, sc, sr, s.W + gq * F32W_DG, s.sw);
          } else {
            f32_by_cols<MT>(da, s.W, s.sw, C, (gq * kg + k - nr) * F32_KC);
          }
        } TC_PHASE_PASS);
    f32_dsim<MT>(da, d, s);
    TC_PHASE(20);

    // d_r += A^T DC + DS^T W, a group at a time, its words in Wd again
    for (int gq = 0; gq < ng; ++gq) {
      f32_load_words(s.Wd, F32_S, F32W_DG, gq * F32W_DG, w, rows, d, s.tc);
      __syncthreads();
      TC_PHASE(21);
      f32_accumulate_dr(out, first, rows, d, s, s.W + gq * F32W_DG, s.sw, s.Wd, F32_S,
                        gq * F32W_DG, min(d.D, (gq + 1) * F32W_DG) TC_PHASE_PASS);
      __syncthreads();  // every warp is done with Wd
      TC_PHASE(11);
    }
    TC_PHASE_COUNT(TC_PASSES);
    first = false;
  }
  if (first)  // no caption of the split has a real word: the slice is 0
    for (int e = threadIdx.x; e < d.R * d.D; e += kThreads) out[e] = 0.f;
  TC_PHASE_FLUSH
}

// The forward, fp32 operands, 256 < D <= 1024, R <= 256: block (image i,
// split) as the wide d_regions'; each pass runs the chain to rel (f32w_attend)
// and writes the score of each of its captions to out[i][j].
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_fwd_f32w_kernel(const float* __restrict__ r, const float* __restrict__ w,
                      const uint8_t* __restrict__ mask, float* __restrict__ out, TcDims d,
                      int nsplit) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const F32Smem s = f32w_carve(reinterpret_cast<float*>(tc_smem_raw), 8 * MT, d.D);
  TC_PHASE_INIT
  const int i = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (d.Bc + nsplit - 1) / nsplit;
  const int c0 = min(d.Bc, split * per), c1 = min(d.Bc, c0 + per);
  float* out_i = out + size_t(i) * d.Bc;
  const float* ri = r + size_t(i) * d.R * d.D;
  tc_padded_scores(mask, c0, c1, d, lane, warp, out_i);
  for (int j = c0; j < c1;) {
    if (f32_next_pass(w, mask, j, c1, d, s, round_up(d.D, F32W_DG) TC_PHASE_PASS) == 0) break;
    float inrm[MT];
    f32w_attend<MT>(inrm, ri, d, s TC_PHASE_PASS);
    tc_write_scores(s.tc, d, lane, warp, out_i);
    TC_PHASE_SYNC(12);
    TC_PHASE_COUNT(TC_PASSES);
  }
  TC_PHASE_FLUSH
}

template <int MT>
int launch_fwd_f32w(const float* r, const float* w, const uint8_t* mask, float* out,
                    const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_fwd_f32w_kernel<MT>;
  const size_t bytes = f32w_smem_bytes(8 * MT, d.D);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  k<<<dim3(d.B, nsplit), kThreads, bytes, st>>>(r, w, mask, out, d, nsplit);
  return int(cudaGetLastError());
}

template <int MT>
int launch_dr_f32w(const float* r, const float* w, const uint8_t* mask, const float* g,
                   float* partial, float* dr, const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dr_f32w_kernel<MT>;
  const size_t bytes = f32w_smem_bytes(8 * MT, d.D);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  k<<<dim3(d.B, nsplit), kThreads, bytes, st>>>(r, w, mask, g, partial, d, nsplit);
  if (partial != dr) launch_sum(partial, dr, d.B, nsplit, int64_t(d.R) * d.D, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 d_words on the CUDA cores, R <= 256, D <= 1024, the real words packed
// and the regions streamed (header: "The fp32 d_words").
// ---------------------------------------------------------------------------

constexpr int F32D_ROWS_256 = 32;   // word rows per pass at D <= 256
constexpr int F32D_ROWS_1024 = 16;  // at 256 < D <= 1024

// The rows per pass the fp32 d_words takes at D.
inline int f32d_rows(int D) {
  return D <= F32W_DG ? F32D_ROWS_256 : F32D_ROWS_1024;
}

// Row stride (fp32) of the shared part of d_w: the feature groups before the
// last (that one stays in registers), + 4 so that rows lie 4 banks apart;
// none at D <= 256.
__host__ __device__ inline int f32d_swd(int D) {
  const int ng = (D + F32W_DG - 1) / F32W_DG;
  return ng > 1 ? (ng - 1) * F32W_DG + 4 : 0;
}

// Words W [Mp][f32w_stride(D)], a A [Mp][F32_S] (d_sim DS takes its place),
// one group of d_c DC [Mp][F32_S], the shared part of d_w [Mp][f32d_swd(D)],
// the two chunk buffers Rb [2][F32_CHUNK] and 11 fp32/int words a row, as
// f32_carve lays them out.
size_t f32d_smem_bytes(int Mp, int D) {
  return 4 * (size_t(Mp) * (f32w_stride(D) + 2 * F32_S + f32d_swd(D)) + 2 * size_t(F32_CHUNK) +
              size_t(11) * Mp + 4);
}

__device__ F32Smem f32d_carve(float* base, int Mp, int D, float*& dw) {
  F32Smem s;
  s.sw = f32w_stride(D);
  s.W = base;
  s.A = s.W + Mp * s.sw;
  s.DS = s.A;
  s.DC = s.A + Mp * F32_S;
  dw = s.DC + Mp * F32_S;
  s.Rb = dw + Mp * f32d_swd(D);
  s.Wd = s.W;
  s.tc = TcSmem{};
  s.tc.rel = s.Rb + 2 * F32_CHUNK;
  s.tc.drel = s.tc.rel + Mp;
  s.tc.red = s.tc.drel + Mp;
  s.tc.row_t = reinterpret_cast<int*>(s.tc.red + 4 * Mp);
  s.tc.row_c = s.tc.row_t + Mp;
  s.tc.cap_j = s.tc.row_c + Mp;
  s.tc.cap_base = s.tc.cap_j + Mp;
  s.tc.cap_n = s.tc.cap_base + Mp;
  s.tc.info = s.tc.cap_n + Mp;
  return s;
}

bool f32d_dims_ok(const TcDims& d) {
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.D > 0 && d.R <= F32_MAX_RD &&
         d.D <= F32W_MAX_D && d.Mp == f32d_rows(d.D) && d.T <= d.Mp &&
         f32d_smem_bytes(d.Mp, d.D) <= size_t(SMEM_LIMIT);
}

// d_c = sc (w - sr c) of a group of 256 features (the words from Wc, as
// f32w_dc) into DC [Mp][F32_S] from column 0, and c = sc c, the group's
// d rel c_hat (sc = d rel inrm, sr = rel inrm a row).
template <int MT>
__device__ __forceinline__ void f32d_dc(float (&c)[MT][8], const float (&sc)[MT],
                                        const float (&sr)[MT], const float* Wc, int sw,
                                        float* DC) {
  const int rg = f32_rg(), cg = f32_cg();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 wv =
          *reinterpret_cast<const float4*>(Wc + (rg + 8 * i) * sw + 4 * cg + 128 * h);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = sc[i] * (f4_at(wv, e) - sr[i] * c[i][4 * h + e]);
        c[i][4 * h + e] *= sc[i];
      }
      *reinterpret_cast<float4*>(DC + (rg + 8 * i) * F32_S + 4 * cg + 128 * h) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
}

// x, the thread's sums over group gq of d_w (rows rg + 8 i, features
// gq * 256 + 4 cg + 128 h + e), added into d_w: the registers dwr for the
// last group, else the shared part DW (each element its one thread's);
// x is reset to 0.
template <int MT>
__device__ __forceinline__ void f32d_add(float (&x)[MT][8], float (&dwr)[MT][8], float* DW,
                                         int swd, int gq, int ng) {
  const int rg = f32_rg(), cg = f32_cg();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (gq == ng - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dwr[i][4 * h + e] += x[i][4 * h + e];
      } else {
        float4* o = reinterpret_cast<float4*>(DW + (rg + 8 * i) * swd + gq * F32W_DG + 4 * cg +
                                              128 * h);
        const float4 v = *o;
        *o = make_float4(v.x + x[i][4 * h], v.y + x[i][4 * h + 1], v.z + x[i][4 * h + 2],
                         v.w + x[i][4 * h + 3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][4 * h + e] = 0.f;
    }
}

// d_words, fp32 operands, R <= 256, D <= 1024: block (pass p of plan, split
// of the images).  The pass's real words (tc_pack_pass) stay in W for all
// of the split's images; per image the chain to rel (f32w_chain, the last
// feature group's context kept), d rel, then one sweep: the last group's
// d_c (from the kept context) and its column chunks for d a += d_c R^T,
// then for each other group its row chunks (the context again), its d_c
// and its column chunks; d_sim into DS; and d_w += d_sim R over the row
// chunks of each group.  d_rel c_hat and d_sim R add into d_w, fp32 on chip
// (the last group in registers, the others in DW), until one store of the
// pass's rows into partial[split] (its padded slots: 0).
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
damsm_bwd_dw_f32_kernel(const float* __restrict__ r, const float* __restrict__ w,
                        const uint8_t* __restrict__ mask, const float* __restrict__ g,
                        const int* __restrict__ plan, float* __restrict__ partial, TcDims d,
                        int nsplit) {
  const int p = blockIdx.x, split = blockIdx.y;
  if (p >= plan[0]) return;  // the grid has a block for every caption
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  float* DW;
  const F32Smem s = f32d_carve(reinterpret_cast<float*>(tc_smem_raw), 8 * MT, d.D, DW);
  TC_PHASE_INIT
  const int rg = f32_rg(), cg = f32_cg();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = plan[1 + p], c1 = plan[2 + p];
  const int per = (d.B + nsplit - 1) / nsplit;
  const int i0 = min(d.B, split * per), i1 = min(d.B, i0 + per);
  float* out = partial + size_t(split) * d.Bc * d.T * d.D;
  // the d a sweep's chunks: the last group's kl column chunks (up to D), then
  // each other group's nr row chunks and kg column chunks
  const int nr = (d.R + F32_KC - 1) / F32_KC, nk = (d.D + F32_KC - 1) / F32_KC;
  const int ng = (d.D + F32W_DG - 1) / F32W_DG, kg = F32W_DG / F32_KC, per_g = nr + kg;
  const int kl = nk - (ng - 1) * kg, swd = f32d_swd(d.D);
  float dwr[MT][8];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j2 = 0; j2 < 8; ++j2) dwr[i][j2] = 0.f;
  for (int e = threadIdx.x; e < 8 * MT * swd; e += kThreads) DW[e] = 0.f;
  int j = c0;
  const int rows = f32_next_pass(w, mask, j, c1, d, s, round_up(d.D, F32W_DG) TC_PHASE_PASS);
  const int ncap = s.tc.info[1];
  for (int i = rows > 0 ? i0 : i1; i < i1; ++i) {
    const float* ri = r + size_t(i) * d.R * d.D;
    float inrm[MT], c[MT][8];
    f32w_chain<MT, true>(inrm, c, ri, d, s TC_PHASE_PASS);
    tc_drel(g, i, rows, ncap, d, s.tc);
    __syncthreads();
    TC_PHASE(4);

    // the last group's d_c into DC and its d rel c_hat into d_w
    float sc[MT], sr[MT], da[MT][8];
#pragma unroll
    for (int q = 0; q < MT; ++q) {
      sc[q] = s.tc.drel[rg + 8 * q] * inrm[q];
      sr[q] = s.tc.rel[rg + 8 * q] * inrm[q];
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) da[q][j2] = 0.f;
    }
    f32d_dc<MT>(c, sc, sr, s.W + (ng - 1) * F32W_DG, s.sw, s.DC);
    f32d_add<MT>(c, dwr, DW, swd, ng - 1, ng);
    TC_PHASE(18);

    // d a += d_c R^T a group at a time (the first sweep's barrier makes DC whole)
    f32_sweep<19>(
        kl + (ng - 1) * per_g, s.Rb,
        [&](float* buf, int q) {
          if (q < kl) {
            f32_load_chunk<false>(buf, ri, (ng - 1) * kg + q, d);
          } else {
            const int gq = (q - kl) / per_g, k = (q - kl) % per_g;
            if (k < nr) f32_load_chunk<true>(buf, ri, k, d, gq * F32W_DG);
            else f32_load_chunk<false>(buf, ri, gq * kg + k - nr, d);
          }
        },
        [&](const float* C, int q) {
          const int gq = q < kl ? ng - 1 : (q - kl) / per_g;
          const int k = q < kl ? nr + q : (q - kl) % per_g;
          if (k < nr) {
            f32_by_rows<MT>(c, s.A, C, k * F32_KC);
            if (k == nr - 1) {
              f32d_dc<MT>(c, sc, sr, s.W + gq * F32W_DG, s.sw, s.DC);
              f32d_add<MT>(c, dwr, DW, swd, gq, ng);
            }
          } else {
            f32_by_cols<MT>(da, s.DC, F32_S, C, (k - nr) * F32_KC);
          }
        } TC_PHASE_PASS);
    f32_dsim<MT>(da, d, s);  // into DS, over a
    TC_PHASE(20);

    // d_w += d_sim R, a group at a time (its row chunks)
    f32_sweep<22>(
        nr * ng, s.Rb,
        [&](float* buf, int q) { f32_load_chunk<true>(buf, ri, q % nr, d, (q / nr) * F32W_DG); },
        [&](const float* Rr, int q) {
          f32_by_rows<MT>(c, s.DS, Rr, (q % nr) * F32_KC);
          if (q % nr == nr - 1) f32d_add<MT>(c, dwr, DW, swd, q / nr, ng);
        } TC_PHASE_PASS);
    TC_PHASE_COUNT(TC_PASSES);
  }

  // the pass's rows of partial[split]: d_w, each element stored once by the
  // thread that holds it
  const bool vec4 = (d.D & 3) == 0;
#pragma unroll
  for (int q = 0; q < MT; ++q) {
    const int row = rg + 8 * q;
    if (row >= rows) continue;
    float* o = out + (size_t(s.tc.cap_j[s.tc.row_c[row]]) * d.T + s.tc.row_t[row]) * d.D;
    for (int gq = 0; gq < ng; ++gq)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = gq * F32W_DG + 4 * cg + 128 * h;
        if (col >= d.D) continue;
        float x[4];
        if (gq == ng - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = dwr[q][4 * h + e];
        } else {
          const float4 v = *reinterpret_cast<const float4*>(DW + row * swd + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = f4_at(v, e);
        }
        if (vec4) {
          *reinterpret_cast<float4*>(o + col) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d.D) o[col + e] = x[e];
        }
      }
  }
  // the padded slots of the pass's captions: 0
  for (int e = warp; e < (c1 - c0) * d.T; e += kWarps) {
    const size_t slot = size_t(c0) * d.T + e;
    if (mask[slot] == 0) continue;
    for (int k = lane; k < d.D; k += 32) out[slot * d.D + k] = 0.f;
  }
  TC_PHASE(23);
  TC_PHASE_FLUSH
}

template <int MT>
int launch_dw_f32(const float* r, const float* w, const uint8_t* mask, const float* g, int* plan,
                  float* partial, float* dw, const TcDims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dw_f32_kernel<MT>;
  const size_t bytes = f32d_smem_bytes(8 * MT, d.D);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  damsm_dw_passes_kernel<<<1, kThreads, 0, st>>>(mask, plan, d);
  k<<<dim3(d.Bc, nsplit), kThreads, bytes, st>>>(r, w, mask, g, plan, partial, d, nsplit);
  if (partial != dw) launch_sum(partial, dw, 1, nsplit, int64_t(d.Bc) * d.T * d.D, st);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The feature-streamed forward, d_regions and d_words (route 3, D > 1024) on
// the CUDA cores (header: "The feature-streamed kernels").
// ---------------------------------------------------------------------------

constexpr int FS_THREADS = 512;               // 16 warps: the backward holds one block an SM
constexpr int FS_WARPS = FS_THREADS / 32;
constexpr int FS_MB = MAX_ROWS / FS_WARPS;    // word rows a warp: m = warp + 16 a, a < 4
constexpr int FS_KF = 128;                    // features of a streamed chunk: 4 columns a lane
constexpr int FS_SW = FS_KF + 4;              // row stride (fp32) of a chunk tile: rows 4 banks apart
constexpr int FS_QG = 8 * FS_WARPS;           // regions of a d_r tile: 8 consecutive ones a warp
constexpr int FS_TILE = RT * FS_KF / FS_THREADS;  // region tile elements a thread loads
static_assert(FS_KF == 4 * 32, "a lane owns columns lane + 32 jj, jj < 4, of a chunk");
static_assert(FS_TILE * FS_THREADS == RT * FS_KF, "a region tile is whole elements a thread");

// Shared memory of one block, carved from the dynamic allocation.
struct FsSmem {
  float* S;      // [M][SR] sim -> a (fp32)
  float* DA;     // [M][SR] d a -> d sim (backward only)
  float* Wc;     // [M][FS_SW] a chunk of the words (rounded to the operand type)
  float* DC;     // [M][FS_SW] the chunk's d_c (backward only)
  float* Rt;     // [RT][FS_SW] a tile of region rows, the chunk's columns
  float* nrm;    // [M] max(|c|, 1e-12)
  float* rel;    // [M]
  float* drel;   // [M]
  float* inner;  // [M] <c_hat, d c_hat>
};

// [M] rows of S (and DA), Wc (and DC) and 4 row scalars beside the region
// tile, as fs_carve lays them out; no term depends on D.
size_t fs_smem_bytes(const Dims& d, bool backward) {
  const size_t k = backward ? 2 : 1;
  return sizeof(float) * (size_t(d.M) * (k * d.SR + k * FS_SW + 4) + size_t(RT) * FS_SW);
}

__device__ FsSmem fs_carve(float* base, const Dims& d, bool backward) {
  const int k = backward ? 1 : 0;
  FsSmem s;
  s.S = base;
  s.DA = s.S + d.M * d.SR;
  s.Wc = s.DA + k * d.M * d.SR;
  s.DC = s.Wc + d.M * FS_SW;
  s.Rt = s.DC + k * d.M * FS_SW;
  s.nrm = s.Rt + RT * FS_SW;
  s.rel = s.nrm + d.M;
  s.drel = s.rel + d.M;
  s.inner = s.drel + d.M;
  return s;
}

bool fs_dims_ok(const Dims& d, bool backward) {
  return d.B > 0 && d.Bc > 0 && d.R > 0 && d.T > 0 && d.D > 0 && d.vb > 0 &&
         d.M <= MAX_ROWS && fs_smem_bytes(d, backward) <= size_t(SMEM_LIMIT);
}

// Columns c0 .. c0+FS_KF-1 of the word rows of captions j0 .. j0+vb-1 into
// Wc (rows past Bc and columns past D are 0).
template <typename T>
__device__ void fs_load_words(const T* __restrict__ w, int j0, int c0, const Dims& d,
                              float* Wc) {
  for (int e = threadIdx.x; e < d.M * FS_KF; e += FS_THREADS) {
    const int m = e / FS_KF, k = e % FS_KF;
    const int j = j0 + m / d.T, t = m % d.T, col = c0 + k;
    Wc[m * FS_SW + k] =
        (j < d.Bc && col < d.D) ? to_f(w[(size_t(j) * d.T + t) * d.D + col]) : 0.f;
  }
}

// This thread's elements of region rows r0 .. r0+RT-1 of image i, columns
// c0 .. c0+FS_KF-1, into v (rows past R and columns past D are 0): element
// threadIdx.x + FS_THREADS q of the tile, row-major.
template <typename T>
__device__ __forceinline__ void fs_fetch_regions(const T* __restrict__ r, int i, int r0, int c0,
                                                 const Dims& d, float (&v)[FS_TILE]) {
#pragma unroll
  for (int q = 0; q < FS_TILE; ++q) {
    const int e = threadIdx.x + FS_THREADS * q;
    const int rr = r0 + e / FS_KF, col = c0 + e % FS_KF;
    v[q] = (rr < d.R && col < d.D) ? to_f(r[(size_t(i) * d.R + rr) * d.D + col]) : 0.f;
  }
}

// The region tiles of image i in chunk c0's columns, RT rows at a time:
// f(r0) with Rt [RT][FS_SW] holding rows r0 .. r0+RT-1.  Each tile's loads
// are issued into registers before the previous tile's f, so they fly under it.
template <typename T, class F>
__device__ void fs_region_tiles(const T* __restrict__ r, int i, int c0, const Dims& d, float* Rt,
                                F&& f) {
  float next[FS_TILE];
  fs_fetch_regions(r, i, 0, c0, d, next);
  for (int r0 = 0; r0 < d.SR; r0 += RT) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < FS_TILE; ++q) {
      const int e = threadIdx.x + FS_THREADS * q;
      Rt[(e / FS_KF) * FS_SW + e % FS_KF] = next[q];
    }
    __syncthreads();
    if (r0 + RT < d.SR) fs_fetch_regions(r, i, r0 + RT, c0, d, next);
    f(r0);
  }
}

// out[m][r0 + lane] = (first ? 0 : out) + sum_{k < FS_KF} A[m][k] Rt[lane][k]
// (rows m of this warp): one chunk's part of a product over the features.
template <int MB>
__device__ void fs_by_features(const float* A, const float* Rt, float* out, int r0,
                               const Dims& d, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) acc[i] = 0.f;
  for (int k = 0; k < FS_KF; k += 4) {
    const float4 b = *reinterpret_cast<const float4*>(Rt + lane * FS_SW + k);
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int m = warp + FS_WARPS * i;
      if (m < d.M) {
        const float4 a = *reinterpret_cast<const float4*>(A + m * FS_SW + k);
        acc[i] = fmaf(a.x, b.x, acc[i]);
        acc[i] = fmaf(a.y, b.y, acc[i]);
        acc[i] = fmaf(a.z, b.z, acc[i]);
        acc[i] = fmaf(a.w, b.w, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int m = warp + FS_WARPS * i;
    if (m < d.M) {
      float* o = out + m * d.SR + r0 + lane;
      *o = first ? acc[i] : *o + acc[i];
    }
  }
}

// acc[i][jj] = sum_r rnd?(P[m][r]) R_i[r][c0 + lane + 32 jj] (m = warp + 16 i)
// over all region tiles: one chunk's columns of a product over the regions
// (P = a or d sim, [M][SR], 0 past R).
template <typename T, int MB, bool BF16, bool ROUND_P>
__device__ void fs_by_regions(float (&acc)[MB][4], const float* P, const T* __restrict__ r,
                              int i, int c0, const Dims& d, float* Rt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < MB; ++a)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[a][jj] = 0.f;
  fs_region_tiles(r, i, c0, d, Rt, [&](int r0) {
    for (int n = 0; n < RT; n += 4) {
      float b[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[q][jj] = Rt[(n + q) * FS_SW + lane + 32 * jj];
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        const int m = warp + FS_WARPS * a;
        if (m < d.M) {
          float4 p = *reinterpret_cast<const float4*>(P + m * d.SR + r0 + n);
          if (ROUND_P) {
            p.x = rnd<BF16>(p.x); p.y = rnd<BF16>(p.y);
            p.z = rnd<BF16>(p.z); p.w = rnd<BF16>(p.w);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[a][jj] = fmaf(p.x, b[0][jj], acc[a][jj]);
            acc[a][jj] = fmaf(p.y, b[1][jj], acc[a][jj]);
            acc[a][jj] = fmaf(p.z, b[2][jj], acc[a][jj]);
            acc[a][jj] = fmaf(p.w, b[3][jj], acc[a][jj]);
          }
        }
      }
    }
  });
}

// The context c = rnd(a) R_i a chunk at a time, the chunk's words in Wc:
// f(c0, c) for every chunk, c[a][jj] the feature c0 + lane + 32 jj of row
// warp + 16 a.  The context is never stored whole.
template <typename T, int MB, bool BF16, class F>
__device__ void fs_context(const T* __restrict__ r, const T* __restrict__ w, int i, int j0,
                           const Dims& d, const FsSmem& s, F&& f) {
  for (int c0 = 0; c0 < d.D; c0 += FS_KF) {
    __syncthreads();
    fs_load_words(w, j0, c0, d, s.Wc);
    float c[MB][4];
    fs_by_regions<T, MB, BF16, true>(c, s.S, r, i, c0, d, s.Rt);
    f(c0, c);
  }
}

// v[a] summed over the warp into dst[m] (m = warp + 16 a), in a fixed order.
template <int MB>
__device__ __forceinline__ void fs_row_sums(const float (&v)[MB], float* dst, const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < MB; ++a) {
    const int m = warp + FS_WARPS * a;
    if (m >= d.M) continue;  // the warp's rows: uniform across its lanes
    const float sum = warp_sum(v[a]);
    if (lane == 0) dst[m] = sum;
  }
}

// The forward of image i against the sub-block's captions j0.. up to rel:
// S holds a (fp32), nrm and rel are filled.  Sweeps over the regions, each a
// chunk of features at a time: sim = W R^T; the softmax; then c = rnd(a) R,
// folded into |c|^2 and c . w per row, rel = c . w / |c|.  ROUND_REL (the
// bf16 forward's scores) sweeps once more for rel = sum rnd(c_hat) w, as the
// plain version rounds c_hat; the backward keeps the fp32 c_hat's rel, as
// the Pallas kernel computes it.
template <typename T, int MB, bool BF16, bool ROUND_REL>
__device__ void fs_forward_chain(const T* __restrict__ r, const T* __restrict__ w, int i, int j0,
                                 const Dims& d, const FsSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < d.D; c0 += FS_KF) {  // sim = W R^T
    __syncthreads();
    fs_load_words(w, j0, c0, d, s.Wc);
    fs_region_tiles(r, i, c0, d, s.Rt,
                    [&](int r0) { fs_by_features<MB>(s.Wc, s.Rt, s.S, r0, d, c0 == 0); });
  }
  __syncthreads();
  for (int m = warp; m < d.M; m += FS_WARPS) {  // a = softmax_R(g1 * sim); columns past R 0
    float* row = s.S + m * d.SR;
    float mx = -INFINITY;
    for (int q = lane; q < d.R; q += 32) mx = fmaxf(mx, d.g1 * row[q]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int q = lane; q < d.R; q += 32) {
      const float e = expf(d.g1 * row[q] - mx);
      row[q] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int q = lane; q < d.SR; q += 32) row[q] = q < d.R ? row[q] / sum : 0.f;
  }
  float cc[MB], cw[MB];
#pragma unroll
  for (int a = 0; a < MB; ++a) cc[a] = cw[a] = 0.f;
  fs_context<T, MB, BF16>(r, w, i, j0, d, s, [&](int, float (&c)[MB][4]) {
#pragma unroll
    for (int a = 0; a < MB; ++a) {
      const int m = warp + FS_WARPS * a;
      if (m >= d.M) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        cc[a] = fmaf(c[a][jj], c[a][jj], cc[a]);
        cw[a] = fmaf(c[a][jj], s.Wc[m * FS_SW + lane + 32 * jj], cw[a]);
      }
    }
  });
  fs_row_sums<MB>(cc, s.nrm, d);
  fs_row_sums<MB>(cw, s.rel, d);
  __syncwarp();
  // a warp's rows are its own: nrm and rel from the sums it just wrote
#pragma unroll
  for (int a = 0; a < MB; ++a) {
    const int m = warp + FS_WARPS * a;
    if (m < d.M && lane == 0) {
      const float nrm = fmaxf(sqrtf(s.nrm[m]), 1e-12f);
      s.nrm[m] = nrm;
      s.rel[m] = s.rel[m] / nrm;
    }
  }
  if constexpr (ROUND_REL) {
    float rel[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) rel[a] = 0.f;
    fs_context<T, MB, BF16>(r, w, i, j0, d, s, [&](int, float (&c)[MB][4]) {
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        const int m = warp + FS_WARPS * a;
        if (m >= d.M) continue;
        const float nrm = s.nrm[m];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          rel[a] = fmaf(rnd<true>(c[a][jj] / nrm), s.Wc[m * FS_SW + lane + 32 * jj], rel[a]);
      }
    });
    fs_row_sums<MB>(rel, s.rel, d);
  }
  __syncthreads();
}

// v[t] = the logsumexp term of word t of caption c of the block:
// padded ? NEG : g2 * rel; returns (max, sum of exp(v - max)) over T.
__device__ __forceinline__ float2 fs_caption_lse(const uint8_t* __restrict__ mask, const float* rel,
                                                 int c, int j, const Dims& d) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int t = lane; t < d.T; t += 32)
    mx = fmaxf(mx, padded(mask, j, t, d) ? NEG : d.g2 * rel[c * d.T + t]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < d.T; t += 32)
    sum += expf((padded(mask, j, t, d) ? NEG : d.g2 * rel[c * d.T + t]) - mx);
  return make_float2(mx, warp_sum(sum));
}

// The forward: block (image i, caption sub-block); scores out[i][j].
template <typename T, int MB, bool BF16>
__global__ void __launch_bounds__(FS_THREADS)
damsm_fwd_fs_kernel(const T* __restrict__ r, const T* __restrict__ w,
                    const uint8_t* __restrict__ mask, float* __restrict__ out, Dims d) {
  extern __shared__ float4 smem_raw[];
  const FsSmem s = fs_carve(reinterpret_cast<float*>(smem_raw), d, false);
  const int i = blockIdx.x, j0 = blockIdx.y * d.vb;
  fs_forward_chain<T, MB, BF16, BF16>(r, w, i, j0, d, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < d.vb; c += FS_WARPS) {  // logsumexp over the words of caption j
    const int j = j0 + c;
    if (j >= d.Bc) continue;
    const float2 ms = fs_caption_lse(mask, s.rel, c, j, d);
    if (lane == 0) out[size_t(i) * d.Bc + j] = (ms.x + logf(ms.y)) / d.g2;
  }
}

// The backward of image i against the sub-block's captions j0..: the forward
// chain, d rel (0 where padded), <c_hat, d c_hat> = d rel * rel, then d_c a
// chunk at a time into DC, each chunk's d a = d_c R^T added into DA and
// on_dc(c0) called with the chunk's d_c in DC; last d sim into DA.
// DW_TERM: also add d rel * rnd(c_hat) into the d_words slice dw_acc
// [dw_rows][D] (the rows of real captions).
template <typename T, int MB, bool BF16, bool DW_TERM, class F>
__device__ void fs_backward_chain(const T* __restrict__ r, const T* __restrict__ w,
                                  const uint8_t* __restrict__ mask, const float* __restrict__ g,
                                  int i, int j0, const Dims& d, const FsSmem& s, float* dw_acc,
                                  int dw_rows, F&& on_dc) {
  fs_forward_chain<T, MB, BF16, false>(r, w, i, j0, d, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < d.vb; c += FS_WARPS) {  // d rel = g_ij * softmax_T, 0 where padded
    const int j = j0 + c;
    const float2 ms = fs_caption_lse(mask, s.rel, c, j, d);
    const float gij = j < d.Bc ? g[size_t(i) * d.Bc + j] : 0.f;
    for (int t = lane; t < d.T; t += 32) {
      const int m = c * d.T + t;
      const float dr = padded(mask, j, t, d) ? 0.f : gij * (expf(d.g2 * s.rel[m] - ms.x) / ms.y);
      s.drel[m] = dr;
      s.inner[m] = dr * s.rel[m];
    }
  }
  // d_c = (d c_hat - c_hat <c_hat, d c_hat>) / nrm, d a += d_c R^T
  fs_context<T, MB, BF16>(r, w, i, j0, d, s, [&](int c0, float (&c)[MB][4]) {
#pragma unroll
    for (int a = 0; a < MB; ++a) {
      const int m = warp + FS_WARPS * a;
      if (m >= d.M) continue;
      const float nrm = s.nrm[m], inner = s.inner[m], dr = s.drel[m];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = lane + 32 * jj, k = c0 + col;
        const float ch = c[a][jj] / nrm;
        if (DW_TERM && k < d.D && m < dw_rows) dw_acc[size_t(m) * d.D + k] += dr * rnd<BF16>(ch);
        s.DC[m * FS_SW + col] = (rnd<BF16>(dr * s.Wc[m * FS_SW + col]) - ch * inner) / nrm;
      }
    }
    fs_region_tiles(r, i, c0, d, s.Rt,
                    [&](int r0) { fs_by_features<MB>(s.DC, s.Rt, s.DA, r0, d, c0 == 0); });
    on_dc(c0);  // DC is the chunk's d_c, visible to every thread (the barriers above)
  });
  __syncthreads();
  for (int m = warp; m < d.M; m += FS_WARPS) {  // d sim = g1 * a * (rnd(d a) - sum_R a rnd(d a))
    const float* a = s.S + m * d.SR;
    float* da = s.DA + m * d.SR;
    float rs = 0.f;
    for (int q = lane; q < d.R; q += 32) rs = fmaf(a[q], rnd<BF16>(da[q]), rs);
    rs = warp_sum(rs);
    for (int q = lane; q < d.SR; q += 32)
      da[q] = q < d.R ? d.g1 * (a[q] * (rnd<BF16>(da[q]) - rs)) : 0.f;
  }
  __syncthreads();
}

// out[q][c0 + lane + 32 jj] (= if first, else +=) sum_m rnd?(P[m][q]) X[m][lane + 32 jj]
// for q < R and features < D: one chunk of a d_regions product (P = a with
// X = d_c, or P = d sim with X = the words), a warp 8 consecutive regions.
template <bool BF16, bool ROUND_P>
__device__ void fs_accumulate_dr(float* __restrict__ out, const float* P, const float* X, int c0,
                                 const Dims& d, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q0 = 0; q0 < d.R; q0 += FS_QG) {
    const int qw = q0 + 8 * warp;
    if (qw >= d.R) continue;  // the warp's regions: uniform across its lanes
    float acc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[a][jj] = 0.f;
    for (int m = 0; m < d.M; ++m) {  // qw + 7 < SR: P's padded columns are 0
      const float4 p0 = *reinterpret_cast<const float4*>(P + m * d.SR + qw);
      const float4 p1 = *reinterpret_cast<const float4*>(P + m * d.SR + qw + 4);
      float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float xv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) xv[jj] = X[m * FS_SW + lane + 32 * jj];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float p = ROUND_P ? rnd<BF16>(pv[a]) : pv[a];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[a][jj] = fmaf(p, xv[jj], acc[a][jj]);
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int q = qw + a;
      if (q >= d.R) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = c0 + lane + 32 * jj;
        if (k >= d.D) continue;
        float* o = out + size_t(q) * d.D + k;
        *o = first ? acc[a][jj] : *o + acc[a][jj];
      }
    }
  }
}

// d_regions: block image i.  Its caption sub-blocks add rnd(a)^T d_c (a
// chunk at a time, as the chain forms d_c) and d sim^T W into dr[i] ([R][D]),
// in order: one owner per element, no split, no scratch, no atomics.
template <typename T, int MB, bool BF16>
__global__ void __launch_bounds__(FS_THREADS)
damsm_bwd_dr_fs_kernel(const T* __restrict__ r, const T* __restrict__ w,
                       const uint8_t* __restrict__ mask, const float* __restrict__ g,
                       float* __restrict__ dr, Dims d) {
  extern __shared__ float4 smem_raw[];
  const FsSmem s = fs_carve(reinterpret_cast<float*>(smem_raw), d, true);
  const int i = blockIdx.x;
  const int nsub = (d.Bc + d.vb - 1) / d.vb;
  float* acc_out = dr + size_t(i) * d.R * d.D;
  for (int sb = 0; sb < nsub; ++sb) {
    const int j0 = sb * d.vb;
    const bool first = sb == 0;
    fs_backward_chain<T, MB, BF16, false>(r, w, mask, g, i, j0, d, s, nullptr, 0, [&](int c0) {
      fs_accumulate_dr<BF16, true>(acc_out, s.S, s.DC, c0, d, first);
    });
    for (int c0 = 0; c0 < d.D; c0 += FS_KF) {  // d sim^T W
      __syncthreads();
      fs_load_words(w, j0, c0, d, s.Wc);
      __syncthreads();
      fs_accumulate_dr<BF16, false>(acc_out, s.DA, s.Wc, c0, d, false);
    }
    __syncthreads();
  }
}

// d_words: block (caption sub-block, split).  The split's images add
// d rel * rnd(c_hat) + d sim R into partial[split][captions of the block].
template <typename T, int MB, bool BF16>
__global__ void __launch_bounds__(FS_THREADS)
damsm_bwd_dw_fs_kernel(const T* __restrict__ r, const T* __restrict__ w,
                       const uint8_t* __restrict__ mask, const float* __restrict__ g,
                       float* __restrict__ partial, Dims d, int nsplit) {
  extern __shared__ float4 smem_raw[];
  const FsSmem s = fs_carve(reinterpret_cast<float*>(smem_raw), d, true);
  const int j0 = blockIdx.x * d.vb, split = blockIdx.y;
  const int per = (d.B + nsplit - 1) / nsplit;
  const int i0 = split * per, i1 = min(d.B, i0 + per);
  const int rows = min(d.vb, d.Bc - j0) * d.T;  // rows of real captions
  float* acc_out = partial + (size_t(split) * d.Bc * d.T + size_t(j0) * d.T) * d.D;
  for (size_t e = threadIdx.x; e < size_t(rows) * d.D; e += FS_THREADS) acc_out[e] = 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = i0; i < i1; ++i) {
    fs_backward_chain<T, MB, BF16, true>(r, w, mask, g, i, j0, d, s, acc_out, rows,
                                         [](int) {});
    for (int c0 = 0; c0 < d.D; c0 += FS_KF) {  // d sim R, a chunk at a time
      float acc[MB][4];
      fs_by_regions<T, MB, BF16, false>(acc, s.DA, r, i, c0, d, s.Rt);
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        const int m = warp + FS_WARPS * a;
        if (m >= rows) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int k = c0 + lane + 32 * jj;
          if (k < d.D) acc_out[size_t(m) * d.D + k] += acc[a][jj];
        }
      }
    }
  }
}

template <typename T, int MB, bool BF16>
int launch_fwd_fs(const void* r, const void* w, const uint8_t* mask, float* out, const Dims& d,
                  cudaStream_t st) {
  auto k = damsm_fwd_fs_kernel<T, MB, BF16>;
  const size_t bytes = fs_smem_bytes(d, false);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  dim3 grid(d.B, (d.Bc + d.vb - 1) / d.vb);
  k<<<grid, FS_THREADS, bytes, st>>>(static_cast<const T*>(r), static_cast<const T*>(w), mask,
                                     out, d);
  return int(cudaGetLastError());
}

template <typename T, int MB, bool BF16>
int launch_dr_fs(const void* r, const void* w, const uint8_t* mask, const float* g, float* dr,
                 const Dims& d, cudaStream_t st) {
  auto k = damsm_bwd_dr_fs_kernel<T, MB, BF16>;
  const size_t bytes = fs_smem_bytes(d, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  k<<<d.B, FS_THREADS, bytes, st>>>(static_cast<const T*>(r), static_cast<const T*>(w), mask, g,
                                    dr, d);
  return int(cudaGetLastError());
}

template <typename T, int MB, bool BF16>
int launch_dw_fs(const void* r, const void* w, const uint8_t* mask, const float* g,
                 float* partial, float* dw, const Dims& d, int nsplit, cudaStream_t st) {
  auto k = damsm_bwd_dw_fs_kernel<T, MB, BF16>;
  const size_t bytes = fs_smem_bytes(d, true);
  if (!prepare(k, bytes)) return int(cudaErrorInvalidValue);
  k<<<dim3((d.Bc + d.vb - 1) / d.vb, nsplit), FS_THREADS, bytes, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(w), mask, g, partial, d, nsplit);
  if (partial != dw) launch_sum(partial, dw, 1, nsplit, int64_t(d.Bc) * d.T * d.D, st);
  return int(cudaGetLastError());
}

// Dispatch the feature-streamed kernels on the operand type; a warp takes
// MB = FS_MB of a block's rows (those past M skipped).
#define XMC_FS_DISPATCH(LAUNCH, ...)                                               \
  do {                                                                             \
    if (dtype == 0) return LAUNCH<float, FS_MB, false>(__VA_ARGS__);               \
    if (dtype == 1) return LAUNCH<__nv_bfloat16, FS_MB, true>(__VA_ARGS__);        \
    return int(cudaErrorInvalidValue);                                             \
  } while (0)

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

// Dispatch the tensor-core kernels on MT = Mp / 16, the 16-row tiles of a pass.
#define XMC_TC_DISPATCH(LAUNCH, ...)                  \
  switch (t.Mp / 16) {                                \
    case 1: return LAUNCH<1>(__VA_ARGS__);            \
    case 2: return LAUNCH<2>(__VA_ARGS__);            \
    case 3: return LAUNCH<3>(__VA_ARGS__);            \
    default: return LAUNCH<4>(__VA_ARGS__);           \
  }

}  // namespace

// XMC_DAMSM_PART splits the build into three nvcc jobs that run side by side
// (ops/cuda/damsm_score.py: KERNEL, DR_KERNEL, DW_KERNEL): 1 compiles the
// forward's entry point and the kernels it launches, 2 the d_regions', 3 the
// d_words'.  Undefined: all three.
#if !defined(XMC_DAMSM_PART) || XMC_DAMSM_PART == 1
extern "C" int xmc_damsm_fwd(const void* r, const void* w, const void* mask, void* out,
                             int B, int Bc, int R, int T, int D, int vb, int rows, int nsplit,
                             float g1, float g2, int dtype, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (route == 1) {  // a tensor-core kernel (bf16), in passes of `rows` word rows
    const TcDims t = make_tc_dims(B, Bc, R, T, D, rows, g1, g2, r, w);
    if (dtype != 1 || nsplit < 1) return int(cudaErrorInvalidValue);
    if (D > TC_MAX_RD) {  // the regions streamed
      if (!tcs_dims_ok(t, false)) return int(cudaErrorInvalidValue);
      return dispatch_nq(t, [&](auto nq) {  // Mp = 32: MT = 2
        return launch_fwd_tcs<2, decltype(nq)::value>(r, w, m, o, t, nsplit, st);
      });
    }
    if (!tc_dims_ok(t)) return int(cudaErrorInvalidValue);  // the regions resident
    XMC_TC_DISPATCH(launch_fwd_tc, r, w, m, o, t, nsplit, st);
  }
  if (route == 2) {  // an fp32 kernel with packed words, in passes of `rows` word rows
    const TcDims t = make_f32_dims(B, Bc, R, T, D, rows, g1, g2, r, w);
    if (dtype != 0 || nsplit < 1) return int(cudaErrorInvalidValue);
    const float *rf = static_cast<const float*>(r), *wf = static_cast<const float*>(w);
    if (D > F32_MAX_RD) {  // the wide kernel: the context a group of features at a time
      if (!f32w_dims_ok(t)) return int(cudaErrorInvalidValue);
      return t.Mp == F32W_ROWS ? launch_fwd_f32w<F32W_ROWS / 8>(rf, wf, m, o, t, nsplit, st)
                               : launch_fwd_f32w<F32W_ROWS_MIN / 8>(rf, wf, m, o, t, nsplit, st);
    }
    if (!f32_dims_ok(t, F32_FWD_ROWS)) return int(cudaErrorInvalidValue);
    return launch_fwd_f32<F32_FWD_ROWS / 8>(rf, wf, m, o, t, nsplit, st);
  }
  const Dims d = make_dims(B, Bc, R, T, D, vb, g1, g2);
  if (route == 3) {  // the feature-streamed kernel (either dtype), a caption sub-block a block
    if (!fs_dims_ok(d, false)) return int(cudaErrorInvalidValue);
    XMC_FS_DISPATCH(launch_fwd_fs, r, w, m, o, d, st);
  }
  if (route != 0 || !dims_ok(d)) return int(cudaErrorInvalidValue);
  XMC_DAMSM_DISPATCH(launch_fwd, r, w, m, o, d, st);
}
#endif

#if !defined(XMC_DAMSM_PART) || XMC_DAMSM_PART == 2
extern "C" int xmc_damsm_bwd_dr(const void* r, const void* w, const void* mask, const void* g,
                                void* partial, void* dr, int B, int Bc, int R, int T, int D,
                                int vb, int rows, int nsplit, float g1, float g2, int dtype,
                                int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* gg = static_cast<const float*>(g);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dr);
  if (route == 1) {  // a tensor-core kernel (bf16), in passes of `rows` word rows
    const TcDims t = make_tc_dims(B, Bc, R, T, D, rows, g1, g2, r, w);
    if (dtype != 1 || nsplit < 1) return int(cudaErrorInvalidValue);
    if (D > TC_MAX_RD) {  // the regions streamed
      if (!tcs_dims_ok(t, true)) return int(cudaErrorInvalidValue);
      return dispatch_nq(t, [&](auto nq) {  // MT = Mp / 16: 1 or 2
        constexpr int NQ = decltype(nq)::value;
        return t.Mp == 16 ? launch_dr_tcs<1, NQ>(r, w, m, gg, p, o, t, nsplit, st)
                          : launch_dr_tcs<2, NQ>(r, w, m, gg, p, o, t, nsplit, st);
      });
    }
    if (!tc_dims_ok(t)) return int(cudaErrorInvalidValue);  // the regions resident
    XMC_TC_DISPATCH(launch_dr_tc, r, w, m, gg, p, o, t, nsplit, st);
  }
  if (route == 2) {  // an fp32 kernel with packed words, in passes of `rows` word rows
    const TcDims t = make_f32_dims(B, Bc, R, T, D, rows, g1, g2, r, w);
    if (dtype != 0 || nsplit < 1) return int(cudaErrorInvalidValue);
    const float *rf = static_cast<const float*>(r), *wf = static_cast<const float*>(w);
    if (D > F32_MAX_RD) {  // the wide kernel: the context a group of features at a time
      if (!f32w_dims_ok(t)) return int(cudaErrorInvalidValue);
      return t.Mp == F32W_ROWS
                 ? launch_dr_f32w<F32W_ROWS / 8>(rf, wf, m, gg, p, o, t, nsplit, st)
                 : launch_dr_f32w<F32W_ROWS_MIN / 8>(rf, wf, m, gg, p, o, t, nsplit, st);
    }
    if (!f32_dims_ok(t, F32_ROWS)) return int(cudaErrorInvalidValue);
    return launch_dr_f32<F32_ROWS / 8>(rf, wf, m, gg, p, o, t, nsplit, st);
  }
  const Dims d = make_dims(B, Bc, R, T, D, vb, g1, g2);
  if (route == 3) {  // the feature-streamed kernel (either dtype), one block an image, no split
    if (!fs_dims_ok(d, true) || nsplit != 1) return int(cudaErrorInvalidValue);
    XMC_FS_DISPATCH(launch_dr_fs, r, w, m, gg, o, d, st);
  }
  if (route != 0 || !dims_ok(d) || nsplit < 1) return int(cudaErrorInvalidValue);
  XMC_DAMSM_DISPATCH(launch_dr, r, w, m, gg, p, o, d, nsplit, st);
}
#endif

#if !defined(XMC_DAMSM_PART) || XMC_DAMSM_PART == 3
extern "C" int xmc_damsm_bwd_dw(const void* r, const void* w, const void* mask, const void* g,
                                void* plan, void* partial, void* dw, int B, int Bc, int R, int T,
                                int D, int vb, int rows, int nsplit, float g1, float g2,
                                int dtype, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* gg = static_cast<const float*>(g);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dw);
  if (route == 1) {  // the tensor-core kernel (bf16), in passes of `rows` word rows
    const TcDims t = make_tc_dims(B, Bc, R, T, D, rows, g1, g2, r, w);
    if (dtype != 1 || nsplit < 1 || plan == nullptr || !tcd_dims_ok(t))
      return int(cudaErrorInvalidValue);
    int* pl = static_cast<int*>(plan);
    const int nq = (t.Dp + TCS_KC - 1) / TCS_KC;
    if (nq <= 4)
      return launch_dw_tcs<TCD_ROWS_256 / 16, 4, 0>(r, w, m, gg, pl, p, o, t, nsplit, st);
    if (nq <= 12)
      return launch_dw_tcs<TCD_ROWS_768 / 16, 12, TCD_QREG>(r, w, m, gg, pl, p, o, t, nsplit, st);
    return launch_dw_tcs<TCD_ROWS_1024 / 16, 16, 0>(r, w, m, gg, pl, p, o, t, nsplit, st);
  }
  if (route == 2) {  // the fp32 kernel with packed words, in passes of `rows` word rows
    const TcDims t = make_f32_dims(B, Bc, R, T, D, rows, g1, g2, r, w);
    if (dtype != 0 || nsplit < 1 || plan == nullptr || !f32d_dims_ok(t))
      return int(cudaErrorInvalidValue);
    int* pl = static_cast<int*>(plan);
    const float *rf = static_cast<const float*>(r), *wf = static_cast<const float*>(w);
    return t.Mp == F32D_ROWS_256
               ? launch_dw_f32<F32D_ROWS_256 / 8>(rf, wf, m, gg, pl, p, o, t, nsplit, st)
               : launch_dw_f32<F32D_ROWS_1024 / 8>(rf, wf, m, gg, pl, p, o, t, nsplit, st);
  }
  const Dims d = make_dims(B, Bc, R, T, D, vb, g1, g2);
  if (route == 3) {  // the feature-streamed kernel (either dtype), a caption sub-block a block
    if (!fs_dims_ok(d, true) || nsplit < 1) return int(cudaErrorInvalidValue);
    XMC_FS_DISPATCH(launch_dw_fs, r, w, m, gg, p, o, d, nsplit, st);
  }
  if (route != 0 || !dims_ok(d) || nsplit < 1) return int(cudaErrorInvalidValue);
  XMC_DAMSM_DISPATCH(launch_dw, r, w, m, gg, p, o, d, nsplit, st);
}
#endif

#ifdef XMC_DAMSM_PHASES
extern "C" int xmc_damsm_phases_read(void* host) {
  return int(cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles)));
}
extern "C" int xmc_damsm_phases_reset() {
  const unsigned long long zero[TC_NPHASE] = {};
  return int(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#endif
